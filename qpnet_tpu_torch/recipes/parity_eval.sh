#!/bin/bash
# Checkpoint-parity gauntlet (BASELINE.md configs 2 & 5) for the PyTorch
# port: recipes/parity_eval.sh's steps through qpnet_tpu_torch.
#
# Runs the exact procedure that proves the 0.1 dB-MCD parity claim the
# moment the reference's released assets are at hand (README.md:143-212
# of the reference lists where they are published):
#
#   1. convert the released PyTorch SI checkpoint to the pickle format
#      both packages read (+ model.conf) — tools/convert_checkpoint.py;
#   2. extract WORLD features for the vcc18eval wavs;
#   3. batch AR decode (batch 20, seed 100, sampling — the reference's
#      decode settings, runQP.py:65-66) with optional F0 scaling;
#   4. restore the noise-shaping pre-emphasis;
#   5. score our wavs against the reference's released generated wavs
#      AND both against the natural recordings (tools/evaluate.py).
#
# Usage:
#   bash qpnet_tpu_torch/recipes/parity_eval.sh --si_checkpoint <torch checkpoint-final.pkl>
#       --eval_wavs <dir of natural vcc18eval wavs>
#       --ref_gen <dir of the reference's generated wavs>
#       --stats <train-set stats .h5> --workdir <scratch>
#       [--fs 22050] [--minf0 40] [--maxf0 700] [--f0_factor 1.0]
#       [--skip_convert true --config <model.conf>]   # checkpoint already
#                                                     # converted
#       [--device cuda|cpu]
set -euo pipefail
cd "$(dirname "$0")/../.."

si_checkpoint=
eval_wavs=
ref_gen=
stats=
workdir=
fs=22050
minf0=40
maxf0=700
f0_factor=1.0
skip_convert=false
config=
n_jobs=8
network=default        # or Rd10Rr3Ed4Er1 for the deep released models
decode_quantize=none   # or w8a8: int8 weights and activations in K1
device=cuda
. qpnet_tpu_torch/recipes/parse_options.sh

[ -n "$eval_wavs" ] && [ -n "$stats" ] && [ -n "$workdir" ] || {
  sed -n '2,26p' qpnet_tpu_torch/recipes/parity_eval.sh; exit 1; }
if [ "$skip_convert" = true ]; then
  [ -n "$si_checkpoint" ] && [ -n "$config" ] || {
    echo "--skip_convert needs --si_checkpoint (converted) and" \
         "--config"; exit 1; }
else
  [ -n "$si_checkpoint" ] || {
    echo "--si_checkpoint (the released torch checkpoint) is required";
    exit 1; }
fi
mkdir -p "$workdir"

ckpt="$workdir/checkpoint-final.pkl"
conf="$workdir/model.conf"
if [ "$skip_convert" = true ]; then
  ckpt="$si_checkpoint"
  conf="$config"
else
  python -m qpnet_tpu_torch.tools.convert_checkpoint \
    --checkpoint "$si_checkpoint" --out "$ckpt" --config "$conf" \
    --network "$network"
fi

# 2. WORLD features of the natural eval wavs
find "$eval_wavs" -name '*.wav' | sort > "$workdir/eval_wav.scp"
python -m qpnet_tpu_torch.bin.feature_extract --device "$device" \
  --waveforms "$workdir/eval_wav.scp" --feature_dir "$workdir/h5" \
  --fs "$fs" --shiftms 5 --minf0 "$minf0" --maxf0 "$maxf0" \
  --fftl 1024 --inv true --n_jobs "$n_jobs"
find "$workdir/h5" -name '*.h5' | sort > "$workdir/eval_feat.scp"

# 3. decode at the reference operating point
python -m qpnet_tpu_torch.bin.qpnet_decode --device "$device" \
  --feats "$workdir/eval_feat.scp" --stats "$stats" --config "$conf" \
  --checkpoint "$ckpt" --outdir "$workdir/gen_ns/feat_id.wav" --fs "$fs" \
  --batch_size 20 --seed 100 --f0_factor "$f0_factor" \
  --quantize "$decode_quantize"

# 4. undo the noise-shaping pre-emphasis
python -m qpnet_tpu_torch.bin.noise_restored \
  --feats "$workdir/eval_feat.scp" --stats "$stats" \
  --outdir "$workdir/gen_ns/feat_id.wav" \
  --writedir "$workdir/gen/feat_id.wav" \
  --fs "$fs" --mcep_dim_start 2 --mcep_dim_end 37 --mcep_alpha 0.455 \
  --inv false --n_jobs "$n_jobs"

# 5. score
echo "=== ours vs natural ==="
python -m qpnet_tpu_torch.tools.evaluate \
  --ref_wavs "$eval_wavs" --gen_wavs "$workdir/gen" \
  --minf0 "$minf0" --maxf0 "$maxf0" | tee "$workdir/ours_vs_natural.json"
if [ -n "$ref_gen" ]; then
  echo "=== reference-generated vs natural ==="
  python -m qpnet_tpu_torch.tools.evaluate \
    --ref_wavs "$eval_wavs" --gen_wavs "$ref_gen" \
    --minf0 "$minf0" --maxf0 "$maxf0" | tee "$workdir/ref_vs_natural.json"
  echo "PARITY CRITERION: |MCD(ours vs natural) - MCD(ref vs natural)|" \
       "must be <= 0.1 dB (BASELINE.md)"
fi
