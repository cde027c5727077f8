"""Feature-extraction orchestrator, the port of `qpnet_tpu/runFE.py` — the
reference's src/runFE.py with the same step structure (1: f0/pow
statistics, 2: extraction/synthesis, 3: feature statistics, 4: noise
shaping) and scp/temp-list conventions,
driven by argparse (docopt is not a dependency here) and calling the worker
mains in-process instead of os.system string argv.

Path roots come from flags/environment instead of the reference's
hard-coded param_path.py: --corpus_dir (default ./corpus/VCC2018/),
QPNET_PRJ_DIR env overrides the project root.  Same argv as the JAX
package's, plus --device (CUDA unless `--device cpu`), handed to the workers
that take it; the yml goes through `utils/yamlconf.py` (no PyYAML).

  python -m qpnet_tpu_torch.runFE -f 22050 -e vcc18tr_VCC2SF1.scp -1 VCC2SF1
  python -m qpnet_tpu_torch.runFE -r -i -e vcc18tr_VCC2SF1.scp -2 VCC2SF1 \
      --dsp_backend jax --f0_backend jax           # analysis on the card
"""

from __future__ import annotations

import argparse
import os
import sys

from qpnet_tpu_torch.config import AcousticConfig
from qpnet_tpu_torch.data.lists import (
    path_check, path_initial, remove_temp_file, templist,
)
from qpnet_tpu_torch.utils import yamlconf

N_JOBS = int(os.environ.get("QPNET_N_JOBS", "20"))
SAVE_F0, SAVE_AP, SAVE_SPC = True, False, False
SAVE_NPOW, SAVE_EXTEND, SAVE_VAD = True, False, True


def get_arguments(argv=None):
    p = argparse.ArgumentParser(
        description="Feature extraction orchestrator (runFE)")
    p.add_argument("-e", "--evallist", required=True,
                   help="name of the execute scp list file")
    p.add_argument("spk", help="speaker name")
    p.add_argument("-f", "--fs", default="22050")
    p.add_argument("-r", "--replace", action="store_true")
    p.add_argument("-i", "--inverse", action="store_true")
    p.add_argument("-1", "--step1", action="store_true",
                   help="f0 & power statistics")
    p.add_argument("-2", "--step2", action="store_true",
                   help="feature extraction / synthesis")
    p.add_argument("-3", "--step3", action="store_true",
                   help="feature statistics")
    p.add_argument("-4", "--step4", action="store_true",
                   help="waveform noise shaping")
    p.add_argument("--prj_dir", default=os.environ.get("QPNET_PRJ_DIR", "."))
    p.add_argument("--corpus", default="VCC2018")
    p.add_argument("--n_jobs", type=int, default=N_JOBS)
    p.add_argument("--dsp_backend", default="numpy",
                   choices=["numpy", "jax"],
                   help="step 2 spectral analysis: numpy = float64 host "
                        "pool (parity default); jax = CheapTrick/D4C/mcep "
                        "batched on the torch device")
    p.add_argument("--f0_backend", default="host",
                   choices=["host", "jax"],
                   help="step 2 F0: host = numpy harvest pool (parity "
                        "default); jax = device harvest (whole pipeline "
                        "on device with --dsp_backend jax)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the torch device of step 2's jax backends")
    return p.parse_args(argv)


def main(argv=None):
    args = get_arguments(argv)
    if not any([args.step1, args.step2, args.step3, args.step4]):
        raise SystemExit("Please specify steps with options (-1..-4)")
    feat_format = "h5"
    feat_param = AcousticConfig(fs=int(args.fs), shiftms=5)
    synonym_root = "rootpath"
    spk = args.spk
    prj = args.prj_dir.rstrip("/") + "/"
    corpus_dir = f"{prj}corpus/{args.corpus}/"
    tempdir = f"{prj}temp/"
    stats_dir = f"{corpus_dir}stats/"
    figure_dir = f"{corpus_dir}hist/"
    wavs = f"{corpus_dir}scp/{args.evallist}"
    spkinfof = f"{corpus_dir}conf/pow_f0_dict.yml"
    path_check([corpus_dir])
    path_initial([tempdir, figure_dir, stats_dir, os.path.dirname(spkinfof)])
    running_set = os.path.basename(wavs).split(".")[0].split("-")[-1]
    stats = f"{stats_dir}{running_set}_stats.{feat_format}"
    waveforms = f"{tempdir}wavs_{spk}.tmp"
    templist(wavs, waveforms, "", [synonym_root], [corpus_dir])
    feats = f"{tempdir}feat_{running_set}.tmp"
    templist(waveforms, feats, "", ["wav"], [feat_format])

    if args.step1:
        from qpnet_tpu_torch.bin import initialize_speaker
        initialize_speaker.main([
            "--speaker", spk, "--waveforms", waveforms,
            "--figure_dir", figure_dir, "--n_jobs", str(args.n_jobs)])
        print(f"f0 & power statistics are created, please modify the "
              f"{spkinfof} file for the speaker {spk}.")
        if os.path.exists(spkinfof):
            spk_dict = yamlconf.read(spkinfof)
            if spk not in spk_dict:
                spk_dict[spk] = {"f0_min": 40, "f0_max": 800, "pow_th": -30}
        else:
            spk_dict = {spk: {"f0_min": 40, "f0_max": 800, "pow_th": -30}}
        yamlconf.write(spkinfof, spk_dict)
        sys.exit(0)

    if args.step2:
        info = yamlconf.read(spkinfof)[spk]
        from qpnet_tpu_torch.bin import feature_extract
        feature_extract.main([
            "--waveforms", waveforms,
            "--feature_type", feat_param.feature_type,
            "--feature_format", feat_format,
            "--fs", str(args.fs), "--shiftms", str(feat_param.shiftms),
            "--fftl", str(feat_param.fftl),
            "--minf0", str(info["f0_min"]), "--maxf0", str(info["f0_max"]),
            "--pow_th", str(info["pow_th"]),
            "--mcep_dim", str(feat_param.mcep_dim),
            "--mcep_dim_start", str(feat_param.mcep_dim_start),
            "--mcep_dim_end", str(feat_param.mcep_dim_end),
            "--mcep_alpha", str(feat_param.mcep_alpha),
            "--highpass_cutoff", str(feat_param.highpass_cutoff),
            "--f0_dim_idx", str(feat_param.f0_dim_idx),
            "--ap_dim_idx", str(feat_param.ap_dim_idx),
            "--save_f0", str(SAVE_F0), "--save_ap", str(SAVE_AP),
            "--save_spc", str(SAVE_SPC), "--save_npow", str(SAVE_NPOW),
            "--save_extended", str(SAVE_EXTEND), "--save_vad", str(SAVE_VAD),
            "--overwrite", str(args.replace), "--inv", str(args.inverse),
            "--dsp_backend", args.dsp_backend,
            "--f0_backend", args.f0_backend,
            "--n_jobs", str(args.n_jobs), "--device", args.device])

    if args.step3:
        from qpnet_tpu_torch.bin import calc_stats
        calc_stats.main(["--features", feats,
                         "--feature_type", feat_param.feature_type,
                         "--stats", stats])

    if args.step4:
        from qpnet_tpu_torch.bin import noise_shaping
        noise_shaping.main([
            "--waveforms", waveforms,
            "--feature_type", feat_param.feature_type,
            "--feature_format", feat_format,
            "--wavtype", "ns", "--stats", stats,
            "--fs", str(args.fs), "--shiftms", str(feat_param.shiftms),
            "--fftl", str(feat_param.fftl),
            "--mcep_dim_start", str(feat_param.mcep_dim_start),
            "--mcep_dim_end", str(feat_param.mcep_dim_end),
            "--mcep_alpha", str(feat_param.mcep_alpha),
            "--mag", str(feat_param.mag),
            "--n_jobs", str(args.n_jobs), "--inv", "true"])

    remove_temp_file([waveforms, feats])


if __name__ == "__main__":
    main()
