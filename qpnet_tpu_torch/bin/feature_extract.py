"""WORLD feature extraction / analysis-synthesis worker, the port of
`qpnet_tpu/bin/feature_extract.py`: the same argv, plus --device.

`--inv true` extracts h5 features (`/world`, `/f0`, `/npow`, `/vad_idx`),
`--inv false` re-synthesizes `h5_restored/*.wav` from features.  The host
backends (`--dsp_backend numpy --f0_backend host`, the defaults) write the
JAX package's files bit for bit; `jax` in either backend runs that stage on
the torch device (--device, CUDA unless `--device cpu`), in one process.

  python -m qpnet_tpu_torch.bin.feature_extract --waveforms wav.scp \
      --fs 22050 --n_jobs 8                                  # host
  python -m qpnet_tpu_torch.bin.feature_extract --waveforms wav.scp \
      --dsp_backend jax --f0_backend jax                     # on the card
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
from scipy.io import wavfile

from qpnet_tpu_torch.data import (check_hdf5, find_files, read_hdf5,
                                  read_txt, write_hdf5)
from qpnet_tpu_torch.dsp import extfrm, low_cut_filter
from qpnet_tpu_torch.dsp.contf0 import smoothed_continuous_f0
from qpnet_tpu_torch.dsp.world import (WorldAnalyzer, WorldSynthesizer,
                                       decode_aperiodicity)
from qpnet_tpu_torch.ops import extend_time
from qpnet_tpu_torch.utils import multi_processing, set_loglevel


def strtobool(v: str) -> bool:
    return str(v).lower() in ("y", "yes", "t", "true", "on", "1")


def get_arguments(argv=None):
    parser = argparse.ArgumentParser(description="making feature files")
    parser.add_argument("--waveforms", required=True, type=str)
    parser.add_argument("--feature_dir", default=None, type=str)
    parser.add_argument("--feature_type", default="world", choices=["world"])
    parser.add_argument("--f0_analyzer", default="harvest",
                        choices=["harvest", "dio"])
    parser.add_argument("--dsp_backend", default="numpy",
                        choices=["numpy", "jax"],
                        help="numpy = float64 host DSP (reference parity); "
                             "jax = CheapTrick/D4C batched on the torch "
                             "device (one worker process owns it)")
    parser.add_argument("--f0_backend", default="host",
                        choices=["host", "jax"],
                        help="host = numpy harvest/dio (parity default); "
                             "jax = harvest or dio+stonemask on the torch "
                             "device; with --dsp_backend jax the whole "
                             "analysis runs there as one pass")
    parser.add_argument("--feature_format", default="h5", type=str)
    parser.add_argument("--fs", default=22050, type=int)
    parser.add_argument("--shiftms", default=5.0, type=float)
    parser.add_argument("--fftl", default=1024, type=int)
    parser.add_argument("--minf0", default=40, type=float)
    parser.add_argument("--maxf0", default=400, type=float)
    parser.add_argument("--pow_th", default=-20, type=float)
    parser.add_argument("--mcep_dim", default=34, type=int)
    parser.add_argument("--mcep_dim_start", default=2, type=int)
    parser.add_argument("--mcep_dim_end", default=37, type=int)
    parser.add_argument("--mcep_alpha", default=0.455, type=float)
    parser.add_argument("--highpass_cutoff", default=70, type=int)
    parser.add_argument("--f0_dim_idx", default=1, type=int)
    parser.add_argument("--ap_dim_idx", default=-2, type=int)
    parser.add_argument("--save_f0", default=True, type=strtobool)
    parser.add_argument("--save_ap", default=False, type=strtobool)
    parser.add_argument("--save_spc", default=False, type=strtobool)
    parser.add_argument("--save_npow", default=True, type=strtobool)
    parser.add_argument("--save_extended", default=False, type=strtobool)
    parser.add_argument("--save_vad", default=True, type=strtobool)
    parser.add_argument("--overwrite", default=False, type=strtobool)
    parser.add_argument("--inv", default=True, type=strtobool)
    parser.add_argument("--n_jobs", default=10, type=int)
    parser.add_argument("--verbose", default=1, type=int)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="the torch device of the jax backends (read "
                             "only by them); cpu runs them on the CPU")
    return parser.parse_args(argv)


def retarget_path(filepath, extname=None, newdir=None):
    """Move `filepath` into `newdir` (default: keep its directory),
    optionally swapping the extension for `extname`."""
    base = os.path.basename(filepath)
    if extname is not None:
        base = os.path.splitext(base)[0] + "." + extname
    return os.path.join(newdir if newdir is not None
                        else os.path.dirname(filepath), base)


def _feat_name(wav_name, args):
    if args.feature_dir is None:
        return wav_name.replace("wav", args.feature_format)
    return retarget_path(wav_name, extname=args.feature_format,
                         newdir=args.feature_dir)


def _load_wav(wav_name, args):
    """Read + highpass one utterance, verifying the sampling rate."""
    fs, x = wavfile.read(wav_name)
    if fs != args.fs:
        logging.error("%s: fs=%d Hz but the recipe expects %d Hz",
                      wav_name, fs, args.fs)
        sys.exit(1)
    x = np.asarray(x, dtype=np.float64)
    if args.highpass_cutoff != 0:
        x = low_cut_filter(x, fs, cutoff=args.highpass_cutoff)
    return x


def _use_fused_analysis(analyzer, args):
    """The fused one-pass extraction applies when every stage is on device
    and the raw spc/ap arrays are not requested as outputs."""
    return (analyzer.backend == "jax" and analyzer.f0_backend == "jax"
            and not (args.save_ap or args.save_spc))


def _write_feature_sets(args, feat_name, f0, mcep, codeap, npow):
    """The h5 schema writes shared by the staged and fused paths."""
    # continuous F0 low-passed at 20 Hz, with the reference's
    # widening-cutoff retry
    uv, cont_f0_lpf = smoothed_continuous_f0(f0, args.shiftms)
    feats = np.concatenate(
        [uv[:, None], cont_f0_lpf[:, None], mcep, codeap], axis=1)
    write_hdf5(feat_name, "/world", feats.astype(np.float32))
    if args.save_f0:
        write_hdf5(feat_name, "/f0", f0)
    if args.save_npow:
        write_hdf5(feat_name, "/npow", npow)
    if args.save_extended:
        up = int(args.shiftms * args.fs * 0.001)
        write_hdf5(feat_name, "/world_extend",
                   extend_time(feats, up).astype(np.float32))
    if args.save_vad:
        _, vad_idx = extfrm(mcep, npow, power_threshold=args.pow_th)
        write_hdf5(feat_name, "/vad_idx", vad_idx)


def _analyze_and_write(analyzer, args, x, f0_time, feat_name):
    """Device/host spectral stage + dataset writes for one utterance."""
    if _use_fused_analysis(analyzer, args):
        out = analyzer.extract_all(x, dim=args.mcep_dim,
                                   alpha=args.mcep_alpha)
        _write_feature_sets(args, feat_name, out["f0"], out["mcep"],
                            out["codeap"], out["npow"])
        return
    f0, spc, ap = analyzer.analyze(x, f0_time=f0_time)
    codeap = analyzer.codeap()
    mcep = analyzer.mcep(dim=args.mcep_dim, alpha=args.mcep_alpha)
    npow = analyzer.npow()
    if args.save_ap:
        write_hdf5(feat_name, "/ap", ap)
    if args.save_spc:
        write_hdf5(feat_name, "/spc", spc)
    _write_feature_sets(args, feat_name, f0, mcep, codeap, npow)


def _fused_pipeline_extract(analyzer, args, wav_list):
    """Fully-device extraction, pipelined at depth 2: utterance k+1's fused
    pass is queued while the device still runs k's, and k's host tail
    (fetch, cont-F0 smoothing, h5 writes) overlaps k+1's device time."""
    from collections import deque

    n = len(wav_list)
    depth = 2
    pending = deque()

    def drain():
        (i, wav_name, feat_name), handle = pending.popleft()
        logging.info("[%d/%d] extracting %s", i + 1, n, wav_name)
        out = analyzer.extract_all_fetch(handle)
        _write_feature_sets(args, feat_name, out["f0"], out["mcep"],
                            out["codeap"], out["npow"])

    for job in _pending_jobs(wav_list, args):
        x = _load_wav(job[1], args)
        pending.append((job, analyzer.extract_all_async(
            x, dim=args.mcep_dim, alpha=args.mcep_alpha)))
        while len(pending) > depth:
            drain()
    while pending:
        drain()


def _pending_jobs(wav_list, args):
    """(index, wav_name, feat_name) for utterances still to extract."""
    n = len(wav_list)
    jobs = []
    for i, wav_name in enumerate(wav_list):
        feat_name = _feat_name(wav_name, args)
        if check_hdf5(feat_name, "/world") and not args.overwrite:
            logging.info("[%d/%d] %s already extracted, skipping",
                         i + 1, n, wav_name)
            continue
        jobs.append((i, wav_name, feat_name))
    return jobs


def world_feature_extract(wav_list, args):
    """Extract `/world` (uv | contF0 | mcep | codeap) + aux datasets.

    Same flag surface and h5 schema as the reference worker (reference
    feature_extract.py:276-361); the analysis itself runs on this
    framework's own WORLD/mcep implementations.

    Under `--dsp_backend jax` with the host F0, the sequential F0 heuristic
    stays on the host while CheapTrick/D4C/mcep run on the device; a thread
    pool (sized by --n_jobs) runs F0 for upcoming utterances while the
    device analyzes the current one, so neither stage waits on the other.
    """
    analyzer = WorldAnalyzer(fs=args.fs, shiftms=args.shiftms,
                             minf0=args.minf0, maxf0=args.maxf0,
                             fftl=args.fftl, f0_analyzer=args.f0_analyzer,
                             backend=args.dsp_backend,
                             f0_backend=args.f0_backend,
                             device=args.device)
    if _use_fused_analysis(analyzer, args):
        _fused_pipeline_extract(analyzer, args, wav_list)
        return
    n = len(wav_list)
    f0_threads = getattr(args, "f0_threads", 0)
    if analyzer.f0_backend == "jax":
        f0_threads = 0          # F0 is on device too: nothing to overlap
    if analyzer.backend == "jax" and f0_threads > 1 and n > 1:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        def f0_job(wav_name):
            x = _load_wav(wav_name, args)
            return x, analyzer.estimate_f0(x)

        jobs = iter(_pending_jobs(wav_list, args))
        with ThreadPoolExecutor(max_workers=f0_threads) as pool:
            pending = deque()

            def fill():
                while len(pending) < 2 * f0_threads:
                    job = next(jobs, None)
                    if job is None:
                        return
                    pending.append((job, pool.submit(f0_job, job[1])))

            fill()
            while pending:
                (i, wav_name, feat_name), fut = pending.popleft()
                x, f0_time = fut.result()
                logging.info("[%d/%d] extracting %s", i + 1, n, wav_name)
                _analyze_and_write(analyzer, args, x, f0_time, feat_name)
                fill()
        return

    for i, wav_name, feat_name in _pending_jobs(wav_list, args):
        logging.info("[%d/%d] extracting %s", i + 1, n, wav_name)
        x = _load_wav(wav_name, args)
        _analyze_and_write(analyzer, args, x, None, feat_name)


def _restore_jobs(wav_list, args):
    """(index, restored_name, feat_name) for utterances still to render."""
    n = len(wav_list)
    jobs = []
    for i, wav_name in enumerate(wav_list):
        if args.feature_dir is None:
            restored_name = wav_name.replace(
                "wav", args.feature_format + "_restored")
            restored_name = restored_name.replace(
                ".%s" % (args.feature_format + "_restored"), ".wav")
            feat_name = wav_name.replace("wav", args.feature_format)
        else:
            restored_name = retarget_path(
                wav_name, newdir=args.feature_dir + "restored")
            feat_name = retarget_path(wav_name,
                                      extname=args.feature_format,
                                      newdir=args.feature_dir)
        if os.path.exists(restored_name) and not args.overwrite:
            logging.info("[%d/%d] %s already synthesized, skipping",
                         i + 1, n, restored_name)
            continue
        jobs.append((i, restored_name, feat_name))
    return jobs


def _load_restore_inputs(feat_name, args):
    """One utterance's (f0, mcep, ap, codeap) from its feature file.
    `codeap` is None when a raw /ap dataset overrides the coded one;
    `ap` is decoded lazily (None when codeap is available — the device
    path decodes on chip)."""
    if not check_hdf5(feat_name, "/world"):
        logging.error("missing feature file %s (run extraction first)",
                      feat_name)
        sys.exit(1)
    h = read_hdf5(feat_name, "/world")
    if check_hdf5(feat_name, "/f0"):
        f0 = read_hdf5(feat_name, "/f0")
    else:
        uv = h[:, 0].copy()
        f0 = h[:, args.f0_dim_idx].copy()
        f0[uv == 0.0] = 0.0
    ap, codeap = None, None
    if check_hdf5(feat_name, "/ap"):
        ap = read_hdf5(feat_name, "/ap")
    else:
        codeap = h[:, args.ap_dim_idx:].copy()
    mcep = h[:, args.mcep_dim_start: args.mcep_dim_end].copy()
    return f0, mcep, ap, codeap


def _write_restored(restored_name, wav, fs):
    wav = np.clip(wav, -32768, 32767)
    os.makedirs(os.path.dirname(restored_name), exist_ok=True)
    wavfile.write(restored_name, fs, wav.astype(np.int16))


def world_speech_synthesis(wav_list, args):
    """Analysis-synthesis restore pass (reference feature_extract.py:215-274).

    Under `--dsp_backend jax` the pulse construction runs on the device
    (dsp/world/device_synthesis.py) with utterance k+1's pass queued while
    the device still renders k: the same depth-2 pipelining as the fused
    extraction path."""
    backend = args.dsp_backend
    synthesizer = WorldSynthesizer(fs=args.fs, fftl=args.fftl,
                                   shiftms=args.shiftms, backend=backend,
                                   device=args.device)
    n = len(wav_list)
    jobs = _restore_jobs(wav_list, args)
    if backend == "jax":
        from collections import deque

        pending = deque()

        def drain():
            (i, restored_name), handle = pending.popleft()
            logging.info("[%d/%d] re-synthesizing %s", i + 1, n,
                         restored_name)
            _write_restored(restored_name,
                            synthesizer.synthesis_fetch(handle), args.fs)

        for i, restored_name, feat_name in jobs:
            f0, mcep, ap, codeap = _load_restore_inputs(feat_name, args)
            if codeap is not None:
                # fused device restore: decode + mc2sp + synthesis in one
                # pass, a coded-feature-sized upload
                handle = synthesizer.restore_async(
                    f0, mcep, codeap, alpha=args.mcep_alpha)
            else:
                handle = synthesizer.synthesis_async(
                    f0, mcep, ap, alpha=args.mcep_alpha)
            pending.append(((i, restored_name), handle))
            while len(pending) > 2:
                drain()
        while pending:
            drain()
        return
    for i, restored_name, feat_name in jobs:
        logging.info("[%d/%d] re-synthesizing %s", i + 1, n, restored_name)
        f0, mcep, ap, codeap = _load_restore_inputs(feat_name, args)
        if ap is None:
            ap = decode_aperiodicity(codeap, args.fs, args.fftl)
        wav = synthesizer.synthesis(f0, mcep, ap, alpha=args.mcep_alpha)
        _write_restored(restored_name, wav, args.fs)


def featpath_create(wav_list, feature_format):
    for wav_name in wav_list:
        feat_name = wav_name.replace("wav", feature_format)
        dirname = os.path.dirname(feat_name)
        if dirname:
            os.makedirs(dirname, exist_ok=True)


def wavpath_create(wav_list, feature_format):
    for wav_name in wav_list:
        restored = wav_name.replace("wav", feature_format + "_restored")
        dirname = os.path.dirname(restored)
        if dirname:
            os.makedirs(dirname, exist_ok=True)


def main(argv=None):
    args = get_arguments(argv)
    set_loglevel(args.verbose)
    for key, value in vars(args).items():
        logging.info("%s = %s", key, str(value))
    if os.path.isdir(args.waveforms):
        file_list = sorted(find_files(args.waveforms, "*.wav"))
    else:
        file_list = read_txt(args.waveforms)
    logging.info("number of utterances = %d", len(file_list))

    if args.inv:
        target_fn, path_create = world_feature_extract, featpath_create
        if args.dsp_backend == "jax" and args.n_jobs > 1:
            # one device, one process (no spawned child opens a CUDA
            # context); the host F0 stage runs in a thread pool of the
            # requested width, pipelined ahead of the device spectral stage
            args.f0_threads = min(args.n_jobs, os.cpu_count() or 1)
            logging.info("dsp_backend=jax: 1 worker process with %d "
                         "host F0 threads", args.f0_threads)
            args.n_jobs = 1
        if args.f0_backend == "jax" and args.n_jobs > 1:
            logging.info("f0_backend=jax: 1 worker process owns the "
                         "device")
            args.n_jobs = 1
    else:
        target_fn, path_create = world_speech_synthesis, wavpath_create
        if args.dsp_backend == "jax" and args.n_jobs > 1:
            logging.info("dsp_backend=jax: 1 worker process owns the "
                         "device for the restore pass")
            args.n_jobs = 1
    if args.feature_dir is None:
        path_create(file_list, args.feature_format)
    else:
        os.makedirs(args.feature_dir, exist_ok=True)
        os.makedirs(args.feature_dir + "restored/", exist_ok=True)
    multi_processing(file_list, target_fn, args.n_jobs, args)


if __name__ == "__main__":
    main()
