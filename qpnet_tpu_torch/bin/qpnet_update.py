"""SD-QPNet adaptation worker on one GPU: fine-tunes the full network from
an SI `checkpoint-final.pkl` or `.orbax` (`--pretrain`, fresh optimizer,
iterations reset) or resumes an interrupted update (`--resume`).  Network
hyper-parameters come from the SI run's `model.conf`.  Same argv as
`qpnet_tpu.bin.qpnet_update`, plus --device.
"""

from __future__ import annotations

import argparse
import logging
import os

from qpnet_tpu_torch.config import RunConfig, TrainConfig
from qpnet_tpu_torch.utils import set_loglevel


def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--waveforms", required=True, type=str)
    parser.add_argument("--feats", required=True, type=str)
    parser.add_argument("--stats", required=True, type=str)
    parser.add_argument("--expdir", required=True, type=str)
    parser.add_argument("--config", required=True, type=str,
                        help="model.conf of the SI model")
    parser.add_argument("--pretrain", required=True, type=str,
                        help="SI checkpoint-final.pkl")
    parser.add_argument("--batch_length", default=20000, type=int)
    parser.add_argument("--batch_size", default=1, type=int)
    parser.add_argument("--max_length", default=30000, type=int)
    parser.add_argument("--f0_threshold", default=0, type=int)
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--weight_decay", default=0.0, type=float)
    parser.add_argument("--iters", default=3000, type=int)
    parser.add_argument("--checkpoint_interval", default=100, type=int)
    parser.add_argument("--intervals", default=100, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--resume", default=None, nargs="?", type=str)
    parser.add_argument("--n_gpus", default=1, type=int)
    parser.add_argument("--dtype", default="float32", type=str,
                        choices=("float32", "bfloat16"),
                        help="step math: float32 = reference parity; "
                             "bfloat16 = mixed precision")
    parser.add_argument("--fixed_engine", default="auto", type=str,
                        choices=("auto", "pallas", "xla"),
                        help="auto and xla: the plain PyTorch engine; "
                             "pallas: the fused training kernel")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu runs the kernel's plain PyTorch twin")
    parser.add_argument("--verbose", default=1, type=int)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_arguments(argv)
    set_loglevel(args.verbose)
    from qpnet_tpu_torch.models.qpnet import resolve_device
    resolve_device(args.device)
    for key, value in vars(args).items():
        logging.info("%s = %s", key, str(value))
    os.makedirs(args.expdir, exist_ok=True)

    run_cfg = RunConfig.load(args.config)
    cfg = run_cfg.model
    tcfg = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, iters=args.iters,
        checkpoint_interval=args.checkpoint_interval,
        batch_length=args.batch_length, batch_size=args.batch_size,
        max_length=args.max_length, f0_threshold=args.f0_threshold,
        seed=args.seed, intervals=args.intervals, dtype=args.dtype,
        fixed_engine=args.fixed_engine)

    from qpnet_tpu_torch.bin.qpnet_train import resolve_lists
    args.feature_format = run_cfg.feature_format
    wav_list, feat_list = resolve_lists(args)
    logging.info("number of adaptation data = %d.", len(wav_list))

    resume = args.resume if args.resume and args.resume != "None" else None
    from qpnet_tpu_torch.train.trainer import run_training
    run_training(cfg, tcfg, wav_list, feat_list, args.stats, args.expdir,
                 feature_type=run_cfg.feature_type, resume=resume,
                 pretrain=args.pretrain, device=args.device)
    # the SD expdir carries the network config for decoding
    sd_conf = os.path.join(args.expdir, "model.conf")
    if os.path.abspath(sd_conf) != os.path.abspath(args.config):
        run_cfg.save(sd_conf)


if __name__ == "__main__":
    main()
