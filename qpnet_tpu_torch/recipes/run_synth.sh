#!/bin/bash
# Self-contained end-to-end recipe on a generated corpus for the PyTorch
# port (recipes/run_synth.sh's stages) — no licensed audio required.  The
# reference's run_FE.sh/run_QP.sh assume VCC2018 is on disk (reference
# README.md:61-75); this recipe builds a deterministic speech-like corpus
# first (qpnet_tpu_torch/tools/make_synth_corpus.py) and then runs the
# SAME stage ladder the VCC2018 recipes run, ending with an objective
# decoded-vs-source evaluation.  It is the one-command smoke/validation
# run for a fresh checkout or a new card.
#
# Stages (--stage, default cftde):
#   c: generate the synthetic corpus (wav + scp + conf)
#   f: feature extraction (train/update/valid/eval) + stats + noise shaping
#   t: SI training
#   a: SD adaptation + validation sweep + decode at the best iteration
#   d: SI decode + noise restore (per speaker)
#   s: F0-scaled decode (factor --f0factor, default 1.5)
#   e: objective evaluation (MCD / F0-RMSE / V-UV vs the source wavs)
#
# Example, on the card (chip_smoke.py phase 17 runs these stages with
# --seconds 1.5 --iters 100 --uiters 100 and the device analysis):
#   bash qpnet_tpu_torch/recipes/run_synth.sh --prj /tmp/qpsynth \
#        --iters 1000 --dtype bfloat16
# On the CPU: --device cpu (with a short --iters).
# Reference-budget run: --iters 200000 --uiters 3000 (as run_QP.sh).

stage=cftde
prj=${QPNET_PRJ_DIR:-/tmp/qpnet_synth}
fs=22050
speakers=1
train_utts=6
seconds=3.0
iters=1000
uiters=200
dense=8
dtype=bfloat16
f0factor=1.5
dsp_backend=numpy
f0_backend=host
decode_batch_size=
resume=
seed=0
device=cuda

. "$(dirname "$0")/parse_options.sh" || exit 1
set -e

export QPNET_PRJ_DIR="$prj"
corpus_dir="$prj/corpus/SYNTH"
spks=$(seq -f "SYN%g" 1 "$speakers")
FE="python -m qpnet_tpu_torch.runFE --device $device -f $fs --corpus SYNTH \
    --dsp_backend $dsp_backend --f0_backend $f0_backend"
QP="python -m qpnet_tpu_torch.runQP --device $device -w synthtr.scp \
    -a synthtr.scp -f $fs -d $dense --corpus SYNTH --dtype $dtype"
if [ -n "$decode_batch_size" ]; then
  QP="$QP --decode_batch_size $decode_batch_size"
fi

if [[ $stage == *c* ]]; then
  mkdir -p "$prj"
  python -m qpnet_tpu_torch.tools.make_synth_corpus \
    --corpus_dir "$corpus_dir" --fs "$fs" --speakers "$speakers" \
    --train_utts "$train_utts" --seconds "$seconds" --seed "$seed"
fi

if [[ $stage == *f* ]]; then
  # synthup/synthva are subsets of synthtr (reference containment
  # convention), so two extractions cover every list
  for spk in $spks; do
    for set_ in synthtr syntheval; do
      $FE -r -i -e "${set_}_${spk}.scp" -2 "$spk"
    done
  done
  $FE -r -e synthtr.scp -3 allspk
  $FE -r -e synthtr.scp -4 allspk
fi

if [[ $stage == *t* ]]; then
  # --resume auto picks up the newest checkpoint after an interruption
  $QP -I "$iters" ${resume:+-R "$resume"} -1
fi

model="Asynthtr_Wsynthtr_d${dense}"

# best adaptation iteration for a speaker, from the sweep's yml (the
# same selection runQP step 5 prints), read without PyYAML
best_iter() {
  python -c "
from qpnet_tpu_torch.utils.yamlconf import read_validation_record
r = read_validation_record(
    '$prj/qpnet_models/${model}_Usynthup_$1_Vsynthup_$1/'
    'validation_result.yml')
b = min(r, key=r.get)
print(b.split('-')[-1].split('.')[0])"
}

if [[ $stage == *a* ]]; then
  for spk in $spks; do
    $QP -x "synthup_${spk}.scp" -u "synthup_${spk}.scp" -U "$uiters" -2
    $QP -x "synthup_${spk}.scp" -u "synthup_${spk}.scp" \
        -y "synthva_${spk}.scp" -v "synthva_${spk}.scp" -U "$uiters" -5
    # decode the SD model at the sweep's best iteration (the step the
    # reference leaves to a human reading validation_result.yml)
    best=$(best_iter "$spk")
    echo "== $spk: decoding SD checkpoint-$best =="
    $QP -r -x "synthup_${spk}.scp" -u "synthup_${spk}.scp" \
        -e "syntheval_${spk}.scp" -M "$best" -3 -4 "$spk"
  done
fi

if [[ $stage == *d* ]]; then
  for spk in $spks; do
    $QP -m -r -e "syntheval_${spk}.scp" -M final -3 -4 "$spk"
  done
fi

if [[ $stage == *s* ]]; then
  for spk in $spks; do
    $QP -m -r -e "syntheval_${spk}.scp" -M final -F "$f0factor" -3 -4 "$spk"
  done
fi

if [[ $stage == *e* ]]; then
  for spk in $spks; do
    echo "== $spk SI decoded-vs-source =="
    python -m qpnet_tpu_torch.tools.evaluate \
      --ref_wavs "$corpus_dir/wav/synth_evaluation/$spk" \
      --gen_wavs "$prj/qpnet_output/$model/restored/$spk/final"
    sd="${model}_Usynthup_${spk}_Vsynthup_${spk}"
    if [ -f "$prj/qpnet_models/$sd/validation_result.yml" ]; then
      best=$(best_iter "$spk")
      sd_out="$prj/qpnet_output/$sd/restored/$spk/$best"
      if [ -d "$sd_out" ]; then
        echo "== $spk SD decoded-vs-source (checkpoint-$best) =="
        python -m qpnet_tpu_torch.tools.evaluate \
          --ref_wavs "$corpus_dir/wav/synth_evaluation/$spk" \
          --gen_wavs "$sd_out"
      fi
    fi
  done
fi
