"""De-emphasize generated waveforms: the inverse of bin/noise_shaping.py.

Recipe stage (reference src/bin/noise_restored.py): generated audio was
produced from noise-shaped targets, so its spectrum carries the shaping
pre-emphasis; this worker applies the same corpus-mean MLSA filter with
un-flipped signs (`--inv false`, the default direction here) to restore
it.  Paths are template-driven: `--outdir`/`--writedir` contain the
literal token `feat_id`, substituted per utterance (runQP.py step 4 builds
these templates).  The filter engine lives in dsp/emphasis.py.  The port
of `qpnet_tpu/bin/noise_restored.py`, with its argv and defaults (which
are not noise_shaping's: --fs 16000, --mcep_dim_end 27, --mcep_alpha 0.41,
--n_jobs 40).
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
    parser.add_argument("--feats", required=True, type=str)
    parser.add_argument("--stats", required=True, type=str)
    parser.add_argument("--outdir", required=True, type=str,
                        help="generated wav path template with feat_id")
    parser.add_argument("--writedir", required=True, type=str,
                        help="restored wav path template with feat_id")
    parser.add_argument("--feature_type", default="world", type=str)
    parser.add_argument("--feature_format", default="h5", type=str)
    parser.add_argument("--pow_adjust", default=1.0, type=float)
    parser.add_argument("--fs", default=16000, type=int)
    parser.add_argument("--shiftms", default=5, type=float)
    parser.add_argument("--fftl", default=1024, type=int)
    parser.add_argument("--mcep_dim_start", default=2, type=int)
    parser.add_argument("--mcep_dim_end", default=27, type=int)
    parser.add_argument("--mcep_alpha", default=0.41, type=float)
    parser.add_argument("--mag", default=0.5, type=float)
    parser.add_argument("--verbose", default=1, type=int)
    parser.add_argument("--n_jobs", default=40, type=int)
    parser.add_argument("--inv", default=False, type=strtobool)
    return parser.parse_args(argv)


def restore_worker(feat_ids, args):
    coefs = emphasis_coefs(args.stats, args.feature_type,
                           args.mcep_dim_start, args.mcep_dim_end,
                           args.mag, invert=args.inv)
    total = len(feat_ids)
    for i, feat_id in enumerate(feat_ids, start=1):
        src = args.outdir.replace("feat_id", feat_id)
        dst = args.writedir.replace("feat_id", feat_id)
        logging.info("restoring [%d/%d] %s", i, total, src)
        try:
            filter_wav_file(src, dst, args.fs, coefs, args.mcep_alpha,
                            args.shiftms)
        except ValueError as e:
            logging.error("%s", e)
            sys.exit(1)


def main(argv=None):
    args = get_arguments(argv)
    set_loglevel(args.verbose)
    for key, value in vars(args).items():
        logging.info("%s = %s", key, str(value))
    if os.path.isdir(args.feats):
        feat_list = sorted(find_files(args.feats,
                                      "*.%s" % args.feature_format))
    elif os.path.isfile(args.feats):
        feat_list = read_txt(args.feats)
    else:
        logging.error("--feats should be a directory or an scp list.")
        sys.exit(1)
    suffix = ".%s" % args.feature_format
    feat_ids = [os.path.basename(f)[: -len(suffix)] for f in feat_list]
    logging.info("restoring %d utterances", len(feat_ids))
    multi_processing(feat_ids, restore_worker, args.n_jobs, args)


if __name__ == "__main__":
    main()
