#!/bin/bash
# Feature-extraction recipe over the VCC2018 roster for the PyTorch port
# (recipes/run_FE.sh's stages, the reference's src/run_FE.sh):
#   stage 0: f0/power distribution extraction (then edit pow_f0_dict.yml)
#   stage 1: feature extraction + analysis-synthesis check (training set)
#   stage 2: feature extraction (evaluation set)
#   stage 3: feature extraction (reference set)
#   stage 4: feature statistics + noise shaping (global training list)
# Usage: bash qpnet_tpu_torch/recipes/run_FE.sh --stage 01234 [--fs 22050]
#        [--device cuda|cpu]

stage=
fs=22050
prj=${QPNET_PRJ_DIR:-.}
hubspks="VCC2SF1 VCC2SF2 VCC2SM1 VCC2SM2"
spospks="VCC2SF3 VCC2SF4 VCC2SM3 VCC2SM4"
srcspks="$hubspks $spospks"
tarspks="VCC2TM1 VCC2TM2 VCC2TF1 VCC2TF2"
allspks="$srcspks $tarspks"
device=cuda

. "$(dirname "$0")/parse_options.sh" || exit 1
set -e
export QPNET_PRJ_DIR="$prj"
FE="python -m qpnet_tpu_torch.runFE --device $device"

if echo "$stage" | grep -q 0; then
  for spk in $allspks; do
    $FE -f "$fs" -e "vcc18tr_${spk}.scp" -1 "$spk"
  done
fi

if echo "$stage" | grep -q 1; then
  for spk in $allspks; do
    $FE -r -i -f "$fs" -e "vcc18tr_${spk}.scp" -2 "$spk"
    $FE -r -f "$fs" -e "vcc18tr_${spk}.scp" -2 "$spk"
  done
fi

if echo "$stage" | grep -q 2; then
  for spk in $srcspks; do
    $FE -r -i -f "$fs" -e "vcc18eval_${spk}.scp" -2 "$spk"
  done
fi

if echo "$stage" | grep -q 3; then
  for spk in $tarspks; do
    $FE -r -i -f "$fs" -e "vcc18ref_${spk}.scp" -2 "$spk"
  done
fi

if echo "$stage" | grep -q 4; then
  $FE -r -f "$fs" -e "vcc18tr.scp" -3 allspk
  $FE -r -f "$fs" -e "vcc18tr.scp" -4 allspk
fi
