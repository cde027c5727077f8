"""Feature statistics worker (reference src/bin/calc_stats.py), the port of
`qpnet_tpu/bin/calc_stats.py`: the same argv and the same stats file.

  python -m qpnet_tpu_torch.bin.calc_stats --features feats.scp \\
      --stats data/stats.h5
"""

from __future__ import annotations

import argparse
import logging

from qpnet_tpu_torch.data import read_txt
from qpnet_tpu_torch.data.stats import calc_stats
from qpnet_tpu_torch.utils import set_loglevel


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", required=True,
                        help="list of hdf5 feature files")
    parser.add_argument("--feature_type", default="world", choices=["world"])
    parser.add_argument("--stats", required=True,
                        help="output stats h5 filename")
    parser.add_argument("--verbose", default=1, type=int)
    args = parser.parse_args(argv)
    set_loglevel(args.verbose)
    for key, value in vars(args).items():
        logging.info("%s = %s", key, str(value))
    file_list = read_txt(args.features)
    logging.info("number of utterances = %d", len(file_list))
    calc_stats(file_list, args.stats, args.feature_type)


if __name__ == "__main__":
    main()
