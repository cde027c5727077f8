"""Pre-emphasize training waveforms with the corpus-mean MLSA filter.

Recipe stage (reference src/bin/noise_shaping.py): QPNet trains on mu-law
classes, so shaping the targets with a differential mel-cepstral filter
whitens the quantization noise; decoding later restores the spectrum with
the inverse filter (bin/noise_restored.py).  The argv surface matches the
reference worker; the filter engine lives in dsp/emphasis.py.

Input wavs come from the scp list (or a directory); each output lands next
to its input with the `wav` path component renamed to `wav_<fmt>_<type>`.
The port of `qpnet_tpu/bin/noise_shaping.py`, the same argv; the filter
runs in the port's host C++ core.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from qpnet_tpu_torch.data import find_files, read_txt
from qpnet_tpu_torch.dsp.emphasis import emphasis_coefs, filter_wav_file
from qpnet_tpu_torch.utils import multi_processing, set_loglevel


def strtobool(v: str) -> bool:
    return str(v).lower() in ("y", "yes", "t", "true", "on", "1")


def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--waveforms", default=None, type=str)
    parser.add_argument("--stats", default=None, type=str)
    parser.add_argument("--feature_type", default="world", type=str)
    parser.add_argument("--feature_format", default="h5", type=str)
    parser.add_argument("--wavtype", default="ns", type=str)
    parser.add_argument("--fs", default=22050, type=int)
    parser.add_argument("--shiftms", default=5.0, type=float)
    parser.add_argument("--fftl", default=1024, type=int)
    parser.add_argument("--mcep_dim_start", default=2, type=int)
    parser.add_argument("--mcep_dim_end", default=37, type=int)
    parser.add_argument("--mcep_alpha", default=0.455, type=float)
    parser.add_argument("--mag", default=0.5, type=float)
    parser.add_argument("--verbose", default=1, type=int)
    parser.add_argument("--n_jobs", default=10, type=int)
    parser.add_argument("--inv", default=True, type=strtobool)
    return parser.parse_args(argv)


def _output_path(wav_path: str, wav_set: str) -> str:
    return wav_path.replace("wav", wav_set).replace(".%s" % wav_set, ".wav")


def shape_worker(wav_list, wav_set, args):
    coefs = emphasis_coefs(args.stats, args.feature_type,
                           args.mcep_dim_start, args.mcep_dim_end,
                           args.mag, invert=args.inv)
    total = len(wav_list)
    for i, src in enumerate(wav_list, start=1):
        logging.info("shaping [%d/%d] %s", i, total, src)
        try:
            filter_wav_file(src, _output_path(src, wav_set), args.fs,
                            coefs, args.mcep_alpha, args.shiftms)
        except ValueError as e:
            logging.error("%s", e)
            sys.exit(1)


def main(argv=None):
    args = get_arguments(argv)
    set_loglevel(args.verbose)
    for key, value in vars(args).items():
        logging.info("%s = %s", key, str(value))
    if os.path.isdir(args.waveforms):
        wav_list = sorted(find_files(args.waveforms, "*.wav"))
    else:
        wav_list = read_txt(args.waveforms)
    wav_set = "wav_%s_%s" % (args.feature_format, args.wavtype)
    logging.info("shaping %d utterances -> %s/", len(wav_list), wav_set)
    multi_processing(wav_list, shape_worker, args.n_jobs, wav_set, args)


if __name__ == "__main__":
    main()
