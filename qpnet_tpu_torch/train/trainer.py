"""The training loop shared by the SI-train and SD-update workers, on one
device.  The JAX package's `qpnet_tpu/train/trainer.py` behaviour: prefetched
batches, the loss averaged every `intervals` iterations and logged with an
ETA, `checkpoint-<iter>.pkl` every `checkpoint_interval`, the weights-only
`checkpoint-final.pkl` (`.orbax` directories under QPNET_CKPT_BACKEND=orbax),
the `loss-final.yml` history, `--resume` (a path, or "auto" for the newest
checkpoint of either backend in expdir), `--pretrain` (weights only, fresh
optimizer) and cooperative preemption.

`run_training` reads the corpus from wav/h5 lists; `train_loop` is the loop
itself over any stream of the batcher's batches (chip_smoke.py feeds it the
windowing of an in-memory corpus).

Under a dp mesh (one process per rank, `parallel/distributed.py`), as in the
JAX package's multi-host loop: each host reads its strided slice of the
lists and batches batch_size / n_hosts windows with seed + host_id, and
each of its ranks trains on its rows of that batch; the replicas start from
rank 0's parameters; the step's valid_len gather carries the preemption
flag, so every rank stops at the same iteration; only the lead rank writes
checkpoints and the loss record; at the end the ranks check that their
parameters agree.  Under a (dp, tp) mesh the ranks of a tp group share
their dp index's rows; the state is sharded after init, resume or
pretrain (`train/step.py::shard_train_state`), and each checkpoint gathers
the shards of the lead's tp group into the JAX layout, so it loads in
either package at any tp.  Under sp or pp every rank holds the whole
replicated state (the ranks of an sp group train on slices of their dp
index's windows, those of a pp group run its GPipe stages): the lead
writes it as at dp, and the replicas' check covers every rank.
"""

from __future__ import annotations

import logging
import os
import re
import signal
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from qpnet_tpu_torch.config import ModelConfig, TrainConfig
from qpnet_tpu_torch.data.batcher import (background, padded_shape,
                                          train_window_generator)
from qpnet_tpu_torch.models.qpnet import (count_params, init_params,
                                          params_from_numpy, resolve_device)
from qpnet_tpu_torch.train.checkpoint import (adam_state_from_optax,
                                              load_checkpoint,
                                              save_checkpoint, save_final)
from qpnet_tpu_torch.train.step import (TrainState, batch_to_device,
                                        full_optimizer_state, gather_params,
                                        load_optimizer_state, make_optimizer,
                                        make_train_step,
                                        resolve_fixed_engine,
                                        shard_train_state, sharded_axes,
                                        tree_leaves)
from qpnet_tpu_torch.utils import profiler
from qpnet_tpu_torch.utils.yamlconf import read_loss_record, write_loss_record


class PreemptionGuard:
    """Cooperative preemption for the training loop: a SIGTERM (an
    eviction notice) lets the step in flight finish, a `checkpoint-<iter>`
    is written and the process exits cleanly, so a restarted job with
    `--resume auto` continues from that iteration.

    `QPNET_PREEMPT_AFTER=N` trips the guard after N steps of this process
    (deterministic fault injection for tests).
    """

    def __init__(self):
        self.signum: Optional[int] = None
        self._prev = None
        self._installed = False
        after = os.environ.get("QPNET_PREEMPT_AFTER")
        self._after = int(after) if after else None
        self._steps = 0

    def install(self) -> "PreemptionGuard":
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)
            self._installed = True
        except ValueError:
            # not the main thread: the env knob still works
            pass
        return self

    def uninstall(self):
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
            self._installed = False

    def _on_signal(self, signum, frame):
        self.signum = signum

    def tripped_after_step(self) -> bool:
        """Call once per completed training iteration."""
        self._steps += 1
        if self._after is not None and self._steps >= self._after:
            return True
        return self.signum is not None


def _newest_checkpoint(expdir: str) -> Optional[str]:
    cands = []
    for name in os.listdir(expdir) if os.path.isdir(expdir) else []:
        m = re.fullmatch(r"checkpoint-(\d+)\.(pkl|orbax)", name)
        if m:
            cands.append((int(m.group(1)), name))
    return os.path.join(expdir, max(cands)[1]) if cands else None


def run_training(cfg: ModelConfig, tcfg: TrainConfig,
                 wav_list: Sequence[str], feat_list: Sequence[str],
                 stats_path: str, expdir: str, feature_type: str = "world",
                 resume: Optional[str] = None,
                 pretrain: Optional[str] = None, mesh=None,
                 n_microbatches: Optional[int] = None,
                 device="cuda") -> TrainState:
    """Train on the wav/h5 pairs of two lists (see `train_loop`).  Under a
    mesh each host batches its slice of the lists (module docstring);
    batch_size divides over dp = ranks / (tp * sp * pp), and a pp mesh
    splits each dp shard's rows into n_microbatches (default pp)."""
    from qpnet_tpu_torch.data.stats import load_scaler
    local_bs, seed = tcfg.batch_size, tcfg.seed
    if mesh is not None:
        from qpnet_tpu_torch.parallel import distributed as PD
        w = PD.require_world(mesh)
        if tcfg.batch_size % w.dp:
            raise ValueError(f"global batch_size {tcfg.batch_size} must "
                             f"divide over the dp axis ({w.dp} of "
                             f"{w.size} ranks at tp={w.tp} sp={w.sp} "
                             f"pp={w.pp})")
        local_bs = tcfg.batch_size // w.n_hosts
        wav_list = PD.host_shard_list(wav_list)
        feat_list = PD.host_shard_list(feat_list)
        seed = tcfg.seed + PD.process_index()
        logging.info("host %d/%d: %d utterances, host batch %d over %d "
                     "ranks (tp=%d sp=%d pp=%d)", w.host_id, w.n_hosts,
                     len(wav_list), local_bs, w.local_ranks, w.tp, w.sp, w.pp)
    scaler = load_scaler(stats_path, feature_type)
    batches = background(2)(train_window_generator)(
        wav_list, feat_list, cfg, feat_transform=scaler.transform,
        feature_type=feature_type, batch_length=tcfg.batch_length,
        batch_size=local_bs, max_length=tcfg.max_length,
        f0_threshold=tcfg.f0_threshold, shuffle=True, seed=seed, loop=True)
    return train_loop(cfg, tcfg, batches, expdir, resume=resume,
                      pretrain=pretrain, device=device, mesh=mesh,
                      n_microbatches=n_microbatches)


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, batches: Iterator[dict],
               expdir: str, resume: Optional[str] = None,
               pretrain: Optional[str] = None,
               device="cuda", mesh=None,
               n_microbatches: Optional[int] = None) -> TrainState:
    """Run iterations up to `tcfg.iters` over the batcher's numpy batches;
    returns the final state (parameters and optimizer on `device`).  Under
    a mesh the batches are this rank's host's, the device is the rank's,
    `tcfg.batch_size` is the global batch, and under tp the returned state
    is this rank's shard.  Each iteration is the span train.step, with
    train.next_batch, train.to_device, train.step_fn (the host's enqueue of
    the step), train.log (the interval's mean loss, which waits for the
    card) and train.save inside."""
    world = None
    if mesh is not None:
        from qpnet_tpu_torch.parallel import distributed as PD
        world = PD.require_world(mesh)
        device = world.device
    device = resolve_device(device)
    is_lead = world is None or world.rank == 0
    # the ranks that take part in writing a checkpoint: the lead's tp
    # group gathers the shards
    writes = world is None or world.dp_rank == 0
    os.makedirs(expdir, exist_ok=True)
    np.random.seed(tcfg.seed)
    params = init_params(tcfg.seed, cfg, device=device)
    logging.info("number of model parameters: %d", count_params(params))
    tx = make_optimizer(lr=tcfg.lr, weight_decay=tcfg.weight_decay)
    compute_dtype = (torch.bfloat16 if tcfg.dtype in ("bfloat16", "bf16")
                     else torch.float32)
    # recompute the plain engine's blocks in the backward once a batch's
    # activations get large (the JAX package's thresholds)
    T = padded_shape(tcfg.max_length, cfg.upsampling_factor)
    remat_threshold = 130_000 if compute_dtype == torch.float32 else 260_000
    per_rank = max(1, tcfg.batch_size // (mesh.dp if mesh else 1))
    remat = per_rank * T // (mesh.sp if mesh else 1) > remat_threshold
    if compute_dtype == torch.bfloat16:
        logging.info("mixed precision: bf16 products/activations, "
                     "f32 master weights and loss accumulation")
    step_fn = make_train_step(cfg, tx, mesh=mesh, remat=remat,
                              compute_dtype=compute_dtype,
                              fixed_engine=tcfg.fixed_engine,
                              n_microbatches=n_microbatches)
    engine = resolve_fixed_engine(tcfg.fixed_engine, cfg, tcfg.batch_size, T,
                                  compute_dtype)
    if engine == "pallas":
        logging.info("residual stack: fused training kernel "
                     "(ops/train_kernel.py)")

    iterations = 0
    loss_record: List[float] = []
    flossyml = os.path.join(expdir, "loss-final.yml")
    if resume == "auto":
        resume = _newest_checkpoint(expdir)
        if resume:
            logging.info("autoresume from %s", resume)
    if resume and not os.path.exists(resume):
        raise FileNotFoundError(
            f"--resume checkpoint {resume} does not exist (refusing to "
            f"silently restart from scratch)")
    if resume:
        ckpt = load_checkpoint(resume)
        params = params_from_numpy(ckpt["model"], device)
        opt = tx.init(params)
        load_optimizer_state(opt, params,
                             adam_state_from_optax(ckpt["optimizer"]))
        iterations = int(ckpt["iterations"])
        logging.info("restored from %d-iter checkpoint.", iterations)
        if os.path.exists(flossyml):
            loss_record = read_loss_record(flossyml)
    else:
        if pretrain:
            params = params_from_numpy(load_checkpoint(pretrain)["model"],
                                       device)
            logging.info("loaded pretrained model %s (fresh optimizer).",
                         pretrain)
        opt = tx.init(params)
    if world is not None:
        # the replicas start equal: rank 0's parameters, at one iteration
        PD.check_agreed(iterations, "the iteration to start from")
        PD.broadcast_(tree_leaves(params))
    state = TrainState(params, opt, iterations)
    if world is not None and world.tp > 1:
        state = shard_train_state(mesh, state)
        logging.info("tensor parallel: residual channels sharded over "
                     "tp=%d (%d of %d per rank)", world.tp,
                     cfg.n_resch // world.tp, cfg.n_resch)

    def maxd_bucket(d_np):
        """The adaptive layers fuse into the kernel only on request
        (QPNET_FUSE_ADAPTIVE=1) and, as in the JAX package, not under a
        mesh."""
        if (engine != "pallas" or world is not None
                or not os.environ.get("QPNET_FUSE_ADAPTIVE")):
            return None
        from qpnet_tpu_torch.models.generate import bucket_maxd
        return int(bucket_maxd(float(np.ceil(d_np.max()))))

    def save(it):
        """The lead writes checkpoint-<it>; under tp the lead's tp group
        gathers the shards first (every rank of it calls save).  The span
        train.save."""
        with profiler.span("train.save", iteration=it):
            params = gather_params(mesh, state.params)
            opt_state = full_optimizer_state(mesh, state.opt_state,
                                             state.params)
            if is_lead:
                save_checkpoint(expdir, params, opt_state, it,
                                weight_decay=tcfg.weight_decay)

    # losses stay on the device until the logging interval
    pending = []
    interval_start = time.time()
    logging.info("training start!")
    guard = PreemptionGuard().install()
    local_tripped = False    # trip state after the previous iteration
    trip_synced = False      # its OR over the ranks (rides the vl gather)
    try:
        for i in range(iterations, tcfg.iters):
            with profiler.span("train.step", iteration=i):
                with profiler.span("train.next_batch"):
                    batch_np = next(batches)
                batch_np.pop("window_lens", None)
                if world is not None:
                    # every rank masks the same positions; the one gather
                    # of the step also carries the preemption flag, sampled
                    # again here so a SIGTERM that lands now rides this
                    # step's gather
                    local_tripped = local_tripped or guard.signum is not None
                    with profiler.span("train.to_device"):
                        vl, trip_synced = PD.global_min_and_any(
                            batch_np["valid_len"], local_tripped)
                        batch = PD.make_global_batch(
                            mesh, {k: batch_np[k] for k in ("x", "h", "t",
                                                            "d")})
                        batch["valid_len"] = int(vl)
                    with profiler.span("train.step_fn"):
                        state, loss = step_fn(state, batch)
                else:
                    with profiler.span("train.to_device"):
                        batch = batch_to_device(batch_np, device)
                    with profiler.span("train.step_fn"):
                        state, loss = step_fn(state, batch,
                                              maxd_bucket(batch_np["d"]))
                pending.append(loss)
                logged = (i + 1) % tcfg.intervals == 0
                if logged:
                    with profiler.span("train.log"):
                        # waits for the card
                        avg = float(torch.stack(pending).mean())
                    sec = (time.time() - interval_start) / len(pending)
                    eta = int((tcfg.iters - (i + 1)) * sec)
                    logging.info("(iter:%d) average loss = %.6f (%.3f sec "
                                 "/ batch) ETA %02d:%02d:%02d", i + 1, avg,
                                 sec, eta // 3600, (eta % 3600) // 60,
                                 eta % 60)
                    loss_record.append(avg)
                    pending = []
                saved_here = (i + 1) % tcfg.checkpoint_interval == 0
                if saved_here and writes:
                    # the dp replicas are equal: only the lead writes
                    t_save = time.time()
                    save(i + 1)
                    # checkpoint seconds do not count in the next sec/batch
                    interval_start += time.time() - t_save
                    if is_lead:
                        logging.info("%d-iter checkpoint created.", i + 1)
                if logged:
                    interval_start = time.time()
                local_tripped = guard.tripped_after_step()
                # ranks agree on the stop: one lone early exit would leave
                # the others waiting in the next step's collectives
                tripped = trip_synced if world is not None else local_tripped
                if tripped and (i + 1) < tcfg.iters:
                    if writes and not saved_here:
                        save(i + 1)
                    if is_lead:
                        logging.warning(
                            "preemption%s at iteration %d: checkpoint saved,"
                            " exiting (resume with --resume auto)",
                            f" (signal {guard.signum})" if guard.signum
                            else "", i + 1)
                        write_loss_record(flossyml, loss_record)
                    return state
    finally:
        guard.uninstall()
    if world is not None:
        _check_replicas(state, world, mesh)
    final = gather_params(mesh, state.params) if writes else None
    if is_lead:
        save_final(expdir, final)
        logging.info("final checkpoint created.")
        write_loss_record(flossyml, loss_record)
    return state


def _check_replicas(state: TrainState, world, mesh) -> None:
    """Log the gradient all-reduce's cost, and raise unless the replicas
    agree: a float64 checksum of the replicated leaves, gathered over every
    rank (the dp replicas, and the ranks of each sp or pp group, which hold
    the whole state), and under tp one of this rank's sharded leaves,
    gathered over its gradient group."""
    from qpnet_tpu_torch.parallel import distributed as PD
    spec = tree_leaves(sharded_axes(mesh, state.params))
    sums = [0.0, 0.0]
    for p, axis in zip(tree_leaves(state.params), spec):
        sums[axis is not None] += float(p.detach().double().sum())
    PD.check_agreed(sums[0], "the replicated parameters' checksum")
    what = "parameter checksum %.17g equal on the %d ranks (dp=%d sp=%d " \
        "pp=%d)" % (sums[0] + sums[1], world.size, world.dp, world.sp,
                    world.pp)
    if world.tp > 1:
        PD.check_agreed(sums[1], "the sharded parameters' checksum",
                        dp_only=True)
        what = ("replicated parameters' checksum %.17g equal on the %d "
                "ranks, this shard's %.17g on its %d gradient-group ranks "
                "(dp=%d sp=%d)" % (sums[0], world.size, sums[1],
                                   world.size // world.tp, world.dp,
                                   world.sp))
    logging.info("dp: %d gradient all-reduces over %s, %.3f ms each (host "
                 "clock); %s", world.reduces, world.grad_backend,
                 world.reduce_seconds / max(world.reduces, 1) * 1e3, what)
