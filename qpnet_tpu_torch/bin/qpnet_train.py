"""SI-QPNet training worker on one GPU.  Same argv as
`qpnet_tpu.bin.qpnet_train`, plus --device; writes the same `model.conf`.

  python -m qpnet_tpu_torch.bin.qpnet_train --waveforms <dir|list> \\
      --feats <dir|list> --stats stats.h5 --expdir exp --config exp/model.conf \\
      --fixed_engine pallas

--fixed_engine pallas runs the residual stack through the fused training
kernel (CUDA on the card, its plain twin with --device cpu); auto and xla
run the plain PyTorch engine.  Multi-device and multi-host training and the
orbax checkpoint backend are not ported (NotImplementedError).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from qpnet_tpu_torch.config import ModelConfig, RunConfig, TrainConfig
from qpnet_tpu_torch.data import find_files, read_txt
from qpnet_tpu_torch.utils import set_loglevel


def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--waveforms", required=True, type=str)
    parser.add_argument("--feats", required=True, type=str)
    parser.add_argument("--stats", required=True, type=str)
    parser.add_argument("--expdir", required=True, type=str)
    parser.add_argument("--config", required=True, type=str)
    parser.add_argument("--n_quantize", default=256, type=int)
    parser.add_argument("--n_aux", default=39, type=int)
    parser.add_argument("--n_resch", default=512, type=int)
    parser.add_argument("--n_skipch", default=256, type=int)
    parser.add_argument("--dilationF_depth", default=4, type=int)
    parser.add_argument("--dilationF_repeat", default=3, type=int)
    parser.add_argument("--dilationA_depth", default=4, type=int)
    parser.add_argument("--dilationA_repeat", default=1, type=int)
    parser.add_argument("--kernel_size", default=2, type=int)
    parser.add_argument("--dense_factor", default=8, type=int)
    parser.add_argument("--upsampling_factor", default=110, type=int)
    parser.add_argument("--feature_type", default="world", type=str)
    parser.add_argument("--feature_format", default="h5", type=str)
    parser.add_argument("--batch_length", default=20000, type=int)
    parser.add_argument("--batch_size", default=1, type=int)
    parser.add_argument("--max_length", default=30000, type=int)
    parser.add_argument("--f0_threshold", default=0, type=int)
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--weight_decay", default=0.0, type=float)
    parser.add_argument("--iters", default=200000, type=int)
    parser.add_argument("--checkpoint_interval", default=10000, type=int)
    parser.add_argument("--intervals", default=100, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--resume", default=None, nargs="?", type=str,
                        help="checkpoint path, or 'auto' to resume from "
                             "the newest checkpoint in expdir")
    parser.add_argument("--n_gpus", default=1, type=int,
                        help="accepted for CLI parity")
    parser.add_argument("--n_devices", default=1, type=int,
                        help="data-parallel devices; only 1 is ported")
    parser.add_argument("--tp", default=1, type=int,
                        help="tensor-parallel group size; only 1 is ported")
    parser.add_argument("--sp", default=1, type=int,
                        help="sequence-parallel group size; only 1 is "
                             "ported")
    parser.add_argument("--pp", default=1, type=int,
                        help="pipeline-parallel group size; only 1 is "
                             "ported")
    parser.add_argument("--pp_microbatches", default=0, type=int,
                        help="GPipe microbatches; pipeline parallelism is "
                             "not ported")
    parser.add_argument("--coordinator", default=None, type=str,
                        help="multi-host coordinator; not ported")
    parser.add_argument("--n_hosts", default=None, type=int,
                        help="multi-host process count; not ported")
    parser.add_argument("--host_id", default=None, type=int,
                        help="multi-host process id; not ported")
    parser.add_argument("--pretrain", default=None, nargs="?", type=str,
                        help="weights-only init (the SD-update path)")
    parser.add_argument("--dtype", default="float32", type=str,
                        choices=("float32", "bfloat16"),
                        help="step math: float32 = reference parity; "
                             "bfloat16 = mixed precision (f32 master "
                             "weights, bf16 products/activations)")
    parser.add_argument("--fixed_engine", default="auto", type=str,
                        choices=("auto", "pallas", "xla"),
                        help="auto and xla: the plain PyTorch engine; "
                             "pallas: the fused training kernel")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu runs the kernel's plain PyTorch twin")
    parser.add_argument("--verbose", default=1, type=int)
    return parser.parse_args(argv)


def check_ported(args) -> None:
    """Raise on argv that asks for what the port does not have yet."""
    from qpnet_tpu_torch.train.checkpoint import checkpoint_backend
    from qpnet_tpu_torch.train.step import MULTI_DEVICE
    multi = (args.n_devices > 1 or args.tp > 1 or args.sp > 1
             or args.pp > 1 or args.pp_microbatches
             or args.coordinator is not None
             or (args.n_hosts is not None and args.n_hosts > 1)
             or args.host_id is not None
             or os.environ.get("QPNET_COORDINATOR"))
    if multi:
        raise NotImplementedError(MULTI_DEVICE)
    checkpoint_backend()


def build_configs(args):
    cfg = ModelConfig(
        n_quantize=args.n_quantize, n_aux=args.n_aux,
        n_resch=args.n_resch, n_skipch=args.n_skipch,
        dilationF_depth=args.dilationF_depth,
        dilationF_repeat=args.dilationF_repeat,
        dilationA_depth=args.dilationA_depth,
        dilationA_repeat=args.dilationA_repeat,
        kernel_size=args.kernel_size, dense_factor=args.dense_factor,
        upsampling_factor=args.upsampling_factor)
    tcfg = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, iters=args.iters,
        checkpoint_interval=args.checkpoint_interval,
        batch_length=args.batch_length, batch_size=args.batch_size,
        max_length=args.max_length, f0_threshold=args.f0_threshold,
        seed=args.seed, intervals=args.intervals, dtype=args.dtype,
        fixed_engine=args.fixed_engine)
    return cfg, tcfg


def resolve_lists(args):
    feat_ext = ".%s" % args.feature_format
    if os.path.isdir(args.waveforms):
        filenames = sorted(find_files(args.waveforms, "*.wav",
                                      use_dir_name=False))
        wav_list = [args.waveforms + "/" + f for f in filenames]
        feat_list = [args.feats + "/" + f.replace(".wav", feat_ext)
                     for f in filenames]
    elif os.path.isfile(args.waveforms):
        wav_list = read_txt(args.waveforms)
        feat_list = read_txt(args.feats)
    else:
        logging.error("--waveforms should be directory or list.")
        sys.exit(1)
    assert len(wav_list) == len(feat_list)
    return wav_list, feat_list


def main(argv=None):
    args = get_arguments(argv)
    set_loglevel(args.verbose)
    check_ported(args)
    from qpnet_tpu_torch.models.qpnet import resolve_device
    resolve_device(args.device)   # before anything is written
    for key, value in vars(args).items():
        logging.info("%s = %s", key, str(value))
    os.makedirs(args.expdir, exist_ok=True)

    cfg, tcfg = build_configs(args)
    run_cfg = RunConfig(model=cfg, train=tcfg,
                        feature_type=args.feature_type,
                        feature_format=args.feature_format)
    run_cfg.save(args.config)

    wav_list, feat_list = resolve_lists(args)
    logging.info("number of training data = %d.", len(wav_list))

    from qpnet_tpu_torch.train.trainer import run_training
    resume = args.resume if args.resume and args.resume != "None" else None
    pretrain = (args.pretrain if args.pretrain and args.pretrain != "None"
                else None)
    run_training(cfg, tcfg, wav_list, feat_list, args.stats, args.expdir,
                 feature_type=args.feature_type, resume=resume,
                 pretrain=pretrain, device=args.device)


if __name__ == "__main__":
    main()
