#!/bin/bash
# QPNet recipe for the PyTorch port — recipes/run_QP.sh's stages, the
# reference's src/run_QP.sh stage structure:
#   stage 0: SI training           stage 1: SD adaptation
#   stage 2: SD validation sweep   stage 3: SI decode (+ restore)
#   stage 4: SD decode (+ restore) stage 5: F0x0.5 decode
#   stage 6: F0x1.5 decode
# Usage: bash qpnet_tpu_torch/recipes/run_QP.sh --stage 0123456 [--miter N]
#        [--fs 22050] [--device cuda|cpu]

stage=0
miter=final
fs=22050
dense=8
iters=200000
uiters=3000
prj=${QPNET_PRJ_DIR:-.}
spoke="VCC2SF3 VCC2SF4 VCC2SM3 VCC2SM4"
device=cuda

. "$(dirname "$0")/parse_options.sh" || exit 1

set -e
cd "$prj"
QP="python -m qpnet_tpu_torch.runQP --device $device -w vcc18tr.scp \
    -a vcc18tr.scp -f $fs -d $dense"

if [[ $stage == *0* ]]; then
  $QP -I "$iters" -1
fi

if [[ $stage == *1* ]]; then
  for spk in $spoke; do
    $QP -x "vcc18up_${spk}.scp" -u "vcc18up_${spk}.scp" -U "$uiters" -2
  done
fi

if [[ $stage == *2* ]]; then
  for spk in $spoke; do
    $QP -x "vcc18up_${spk}.scp" -u "vcc18up_${spk}.scp" \
        -y "vcc18va_${spk}.scp" -v "vcc18va_${spk}.scp" -U "$uiters" -5
  done
  echo "pick the best iteration from validation_result.yml, then decode with --miter"
fi

if [[ $stage == *3* ]]; then
  for spk in $spoke; do
    $QP -m -e "vcc18eval_${spk}.scp" -M final -3 -4 "$spk"
  done
fi

if [[ $stage == *4* ]]; then
  for spk in $spoke; do
    $QP -x "vcc18up_${spk}.scp" -u "vcc18up_${spk}.scp" \
        -e "vcc18eval_${spk}.scp" -M "$miter" -3 -4 "$spk"
  done
fi

if [[ $stage == *5* ]]; then
  for spk in $spoke; do
    $QP -x "vcc18up_${spk}.scp" -u "vcc18up_${spk}.scp" \
        -e "vcc18eval_${spk}.scp" -M "$miter" -F 0.5 -3 -4 "$spk"
  done
fi

if [[ $stage == *6* ]]; then
  for spk in $spoke; do
    $QP -x "vcc18up_${spk}.scp" -u "vcc18up_${spk}.scp" \
        -e "vcc18eval_${spk}.scp" -M "$miter" -F 1.5 -3 -4 "$spk"
  done
fi
