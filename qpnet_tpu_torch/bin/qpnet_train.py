"""SI-QPNet training worker.  Same argv as `qpnet_tpu.bin.qpnet_train`,
plus --device; writes the same `model.conf`.

  python -m qpnet_tpu_torch.bin.qpnet_train --waveforms <dir|list> \\
      --feats <dir|list> --stats stats.h5 --expdir exp --config exp/model.conf \\
      --fixed_engine pallas [--n_devices N]

--fixed_engine pallas runs the residual stack through the fused training
kernel (CUDA on the card, its plain twin with --device cpu); auto and xla
run the plain PyTorch engine.

Data parallelism (parallel/): --n_devices N spawns N local ranks, one per
card (cuda:0..N-1), or N CPU ranks with --device cpu.  --coordinator
host:port --n_hosts H --host_id h (or QPNET_COORDINATOR / QPNET_NUM_HOSTS /
QPNET_HOST_ID) joins a multi-host world with one rank per visible card of
each host, or --n_devices CPU ranks.  --tp N shards the residual channels
over tp groups of N consecutive ranks of a host, Megatron-style; --sp N
shards each window's time axis over sp groups (halos exchanged between
neighbours); --pp N runs the residual stack as N GPipe stages over
--pp_microbatches microbatches of each dp shard (default N; pp composes
with dp only).  All three run the plain engine.  One host runs
max(--n_devices, tp * sp * pp) ranks, a (dp, tp, sp) or (dp, pp) mesh with
dp = ranks / (tp * sp * pp); --batch_size is the global batch and must
divide over dp.  The launcher forwards SIGTERM to its ranks (each saves at
the agreed iteration and exits) and fails if any rank fails.
QPNET_CKPT_BACKEND=orbax writes `.orbax` checkpoint directories
(`train/orbax_format.py`); under a mesh the lead rank writes the gathered
state, as for pickles.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import signal
import sys
import tempfile

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
                        help="data-parallel ranks on this host, one per "
                             "card (batch_size must divide over all ranks)")
    parser.add_argument("--tp", default=1, type=int,
                        help="tensor-parallel group size: the residual "
                             "channels shard over a (dp = ranks / tp, tp) "
                             "mesh (tp must divide the ranks of a host and "
                             "n_resch)")
    parser.add_argument("--sp", default=1, type=int,
                        help="sequence-parallel group size: the training "
                             "window's time axis shards over an sp mesh "
                             "axis (tp*sp*pp must divide the ranks of a "
                             "host, sp the window's frames)")
    parser.add_argument("--pp", default=1, type=int,
                        help="pipeline-parallel group size: the residual "
                             "stack splits into pp GPipe stages (pp must "
                             "divide the block count; composes with dp "
                             "only)")
    parser.add_argument("--pp_microbatches", default=0, type=int,
                        help="GPipe microbatch count per dp shard "
                             "(0 = pp size); must divide the per-shard "
                             "batch")
    parser.add_argument("--coordinator", default=None, type=str,
                        help="multi-host: host:port of rank 0's rendezvous "
                             "(or env QPNET_COORDINATOR)")
    parser.add_argument("--n_hosts", default=None, type=int,
                        help="multi-host: number of hosts "
                             "(or env QPNET_NUM_HOSTS)")
    parser.add_argument("--host_id", default=None, type=int,
                        help="multi-host: this host's id "
                             "(or env QPNET_HOST_ID)")
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


def dp_layout(args):
    """(hosts, local_ranks): hosts is (coordinator, n_hosts, host_id) or
    None for one host.  A multi-host run takes one rank per visible card
    (--device cuda) or max(--n_devices, tp*sp*pp) CPU ranks; one host,
    max(--n_devices, tp*sp*pp) ranks, as the JAX CLI's mesh.  Raises
    ValueError when the cards are fewer than the ranks, when tp*sp*pp does
    not divide a host's ranks, when batch_size does not divide over dp,
    when sp does not divide the window's frames, or on a pipeline shape
    that does not fit (`train/pipeline.py::check_pipeline`)."""
    from qpnet_tpu_torch.data.batcher import padded_shape
    from qpnet_tpu_torch.parallel.distributed import resolve_multihost
    from qpnet_tpu_torch.parallel.mesh import Mesh, check_axes, make_mesh
    axes = dict(tp=args.tp, sp=args.sp, pp=args.pp)
    model = args.tp * args.sp * args.pp
    hosts = resolve_multihost(args.coordinator, args.n_hosts, args.host_id)
    local = max(args.n_devices, model)
    if args.device == "cuda" and (hosts is not None or local > 1):
        local = make_mesh(None if hosts else local, "cuda", **axes).size
    else:
        check_axes(local, where=f"{local} ranks of a host: ", **axes)
    dp = (hosts[1] if hosts else 1) * local // model
    if dp > 1 and args.batch_size % dp:
        raise ValueError(f"batch_size {args.batch_size} must divide over "
                         f"the dp axis ({dp} of {dp * model} ranks at "
                         f"tp={args.tp} sp={args.sp} pp={args.pp})")
    frames = padded_shape(args.max_length, args.upsampling_factor) \
        // args.upsampling_factor
    if frames % args.sp:
        raise ValueError(f"the window's time axis is sharded over "
                         f"sp={args.sp}: its {frames} frames should be "
                         f"divisible by {args.sp}")
    if args.pp > 1:
        from qpnet_tpu_torch.train.pipeline import check_pipeline
        cfg, _ = build_configs(args)
        check_pipeline(cfg, Mesh(["cpu"] * dp * model, **axes),
                       args.pp_microbatches, args.batch_size // dp)
    return hosts, local


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


def run_rank(local_rank: int, args, hosts, local_ranks: int,
             init_method: str) -> None:
    """One dp rank: join the world, train on its rows, leave."""
    from qpnet_tpu_torch.parallel import distributed as PD
    from qpnet_tpu_torch.train.trainer import run_training
    set_loglevel(args.verbose)   # a spawned rank starts unconfigured
    host_id, n_hosts = (hosts[2], hosts[1]) if hosts else (0, 1)
    device = f"cuda:{local_rank}" if args.device == "cuda" else "cpu"
    PD.init_world(init_method, host_id, n_hosts, local_rank, local_ranks,
                  device, tp=args.tp, sp=args.sp, pp=args.pp)
    try:
        cfg, tcfg = build_configs(args)
        wav_list, feat_list = resolve_lists(args)
        run_training(cfg, tcfg, wav_list, feat_list, args.stats, args.expdir,
                     feature_type=args.feature_type,
                     resume=_none(args.resume), pretrain=_none(args.pretrain),
                     mesh=PD.rank_mesh(),
                     n_microbatches=args.pp_microbatches or None)
    finally:
        PD.shutdown()


def _none(v):
    return v if v and v != "None" else None


def spawn_ranks(args, hosts, local_ranks: int, init_method: str) -> None:
    """Run `local_ranks` ranks of this host in spawned processes; SIGTERM
    is forwarded to them, and a failed rank ends the others and raises."""
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(run_rank, args=(args, hosts, local_ranks,
                                              init_method),
                              nprocs=local_ranks, join=False,
                              start_method="spawn")

    def forward(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    try:
        prev = signal.signal(signal.SIGTERM, forward)
    except ValueError:   # not the main thread: nothing to forward
        prev = None
    try:
        while not ctx.join(timeout=5):
            pass
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        for p in ctx.processes:   # after a failure join() has ended them
            if p.is_alive():
                p.kill()
                p.join()


def main(argv=None):
    args = get_arguments(argv)
    set_loglevel(args.verbose)
    hosts, local_ranks = dp_layout(args)
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

    if hosts is None and local_ranks == 1:
        from qpnet_tpu_torch.train.trainer import run_training
        run_training(cfg, tcfg, wav_list, feat_list, args.stats, args.expdir,
                     feature_type=args.feature_type,
                     resume=_none(args.resume), pretrain=_none(args.pretrain),
                     device=args.device)
        return
    if args.device == "cuda" and args.fixed_engine == "pallas":
        from qpnet_tpu_torch.ops import train_kernel
        train_kernel.build()   # once here, not once per rank
    if hosts is not None:
        init_method, store = f"tcp://{hosts[0]}", None
    else:
        store = tempfile.mkdtemp(prefix="qpnet_dp_")
        init_method = "file://" + os.path.join(store, "rendezvous")
    try:
        if local_ranks == 1:
            run_rank(0, args, hosts, 1, init_method)
        else:
            spawn_ranks(args, hosts, local_ranks, init_method)
    finally:
        if store is not None:
            shutil.rmtree(store, ignore_errors=True)


if __name__ == "__main__":
    main()
