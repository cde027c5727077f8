"""Pipeline-parallel training: a GPipe microbatch schedule over a pp axis,
the port's counterpart of `qpnet_tpu/train/pipeline.py`.

Each rank of a pp group is one stage and holds the whole replicated train
state, as JAX's replicated state; stage s runs blocks [s L/S, (s+1) L/S)
of the L = 12 fixed + 4 adaptive blocks.  Every block runs in gather form
(`models/qpnet.py::lookback_block`: JAX's `_unified_block`), its look-back
index and left-edge mask computed once from d before the blocks
(`lookback_index`: JAX's `_lookback_tables`), so a fixed block's zero fill
is `shift_time`'s and the pipelined logits equal `forward`'s bit for bit
wherever the products do not depend on the row count.

Stage 0 runs the embedding; every stage runs `upsample_aux` (the
upsampler's gradient is summed over pp with the others); the last stage
runs the post-net and the loss over the whole batch.  The schedule is
GPipe fill and drain over M microbatches of the rank's rows: stage s takes
microbatch m from stage s - 1 (`distributed.pp_recv`), runs its blocks and
sends the (o, skip) carry on (`pp_isend`), so a rank waits through its
bubble ticks instead of computing on garbage.  The backward runs the
reverse schedule: the last stage's loss backward yields the gradients of
its inputs, and each earlier stage receives those of its outputs and runs
`torch.autograd.backward(outputs_m, grad_m)` per microbatch, from the last
to the first.  The bubble share is (S - 1) / (M + S - 1).

Sends never block (isend, waited at the end of each direction) and each
stage receives in the order its neighbour sends, so no two stages wait on
each other.  Over gloo the carry goes through the host (gloo sends no CUDA
tensor point to point); over NCCL, between ranks that own distinct cards,
it goes card to card.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models.qpnet import (Params, _act_dtype, embed,
                                          lookback_block, lookback_index,
                                          postprocess, upsample_aux)


def n_blocks(cfg: ModelConfig) -> int:
    return len(cfg.dilationsF) + len(cfg.dilationsA)


def check_pipeline(cfg: ModelConfig, mesh, n_microbatches: Optional[int],
                   rows: Optional[int] = None) -> int:
    """The pipeline's shape checks, in JAX's words; returns the microbatch
    count M (default: pp).  `rows` is a dp shard's batch."""
    pp, dp = getattr(mesh, "pp", 1), mesh.dp
    if pp <= 1:
        raise ValueError("pipeline_forward needs a pp axis of size > 1")
    if mesh.tp > 1 or mesh.sp > 1:
        raise ValueError("pp composes with dp only (not tp/sp)")
    L = n_blocks(cfg)
    if L % pp:
        raise ValueError(f"pp={pp} must divide the {L}-block stack")
    M = int(n_microbatches) if n_microbatches else pp
    if rows is not None and rows % M:
        raise ValueError(f"per-dp-shard batch {rows * dp}//{dp} must split "
                         f"into {M} microbatches")
    return M


def bubble_share(pp: int, M: int) -> float:
    return (pp - 1) / (M + pp - 1)


def _stages(w, params: Params, cfg: ModelConfig, x, h, d, M: int,
            compute_dtype, remat: bool, grad: bool) -> dict:
    """The forward of this rank's stage (w: its world) over M microbatches
    (module docstring).  The record holds the leaves the backward starts
    from and ends at: the detached upsampled aux ("h_up", "h_leaf") and,
    on stage 0, embedding ("o0", "o0_leaf"); each microbatch's received
    carry ("ins") and its carry out ("outs")."""
    from qpnet_tpu_torch.parallel import distributed as PD
    S, s = w.pp, w.pp_rank
    B, T = x.shape
    Bm, R, Sk = B // M, cfg.n_resch, cfg.n_skipch
    act = _act_dtype(compute_dtype)
    L_l = n_blocks(cfg) // S
    blocks = (list(params["fixed"]) + list(params["adaptive"]))[
        s * L_l:(s + 1) * L_l]
    look = lookback_index(cfg, d)[s * L_l:(s + 1) * L_l]
    block = lookback_block
    if remat:
        def block(*args):
            return checkpoint(lookback_block, *args, use_reentrant=False)

    rec = {"h_up": upsample_aux(params, h, cfg.upsampling_factor).to(act),
           "ins": [], "outs": []}
    rec["h_leaf"] = rec["h_up"].detach().requires_grad_(grad)
    if s == 0:
        rec["o0"] = embed(params, x).to(act)
        rec["o0_leaf"] = rec["o0"].detach().requires_grad_(grad)
    sends = []
    for m in range(M):
        rows = slice(m * Bm, (m + 1) * Bm)
        if s == 0:
            o = rec["o0_leaf"][rows]
            skip = torch.zeros((Bm, T, Sk), dtype=torch.float32,
                               device=x.device)
        else:
            o = PD.pp_recv((Bm, T, R), act, s - 1, 2 * m)
            skip = PD.pp_recv((Bm, T, Sk), torch.float32, s - 1, 2 * m + 1)
            o.requires_grad_(grad)
            skip.requires_grad_(grad)
            rec["ins"].append((o, skip))
        for p, (idx, mask) in zip(blocks, look):
            o, sk = block(p, o, rec["h_leaf"][rows], idx[rows],
                          None if mask is None else mask[rows],
                          compute_dtype, act)
            skip = skip + sk
        if s < S - 1:
            sends += [PD.pp_isend(o, s + 1, 2 * m),
                      PD.pp_isend(skip, s + 1, 2 * m + 1)]
        rec["outs"].append((o, skip))
    for work, _ in sends:
        work.wait()
    return rec


def pipeline_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     h: torch.Tensor, d: torch.Tensor, mesh,
                     n_microbatches: Optional[int] = None,
                     compute_dtype=torch.float32,
                     remat: bool = False) -> Optional[torch.Tensor]:
    """Teacher-forced forward with the residual stack pipelined over the
    mesh's pp axis (no autograd): `models/qpnet.py::forward`'s contract on
    this rank's dp rows, whose logits the last stage returns (None on the
    other stages).  Every rank of the pp group calls it."""
    M = check_pipeline(cfg, mesh, n_microbatches, x.shape[0])
    from qpnet_tpu_torch.parallel.distributed import require_world
    w = require_world(mesh)
    with torch.no_grad():
        rec = _stages(w, params, cfg, x, h, d, M, compute_dtype, remat,
                      False)
    if w.pp_rank < w.pp - 1:
        return None
    return postprocess(params, torch.cat([sk for _, sk in rec["outs"]]),
                       compute_dtype)


def pipeline_backward(params: Params, cfg: ModelConfig, batch: dict, mesh,
                      n_microbatches: Optional[int], compute_dtype,
                      remat: bool) -> torch.Tensor:
    """One GPipe forward and backward of this rank's stage on its dp rows
    (the train step's batch): the gradients of the parameters its stage
    reaches accumulate in their .grad; returns the masked loss on the last
    stage and 0 on the others, so their sum over pp is the dp shard's
    loss."""
    from qpnet_tpu_torch.parallel import distributed as PD
    from qpnet_tpu_torch.train.step import masked_ce_loss
    w = PD.require_world(mesh)
    M = check_pipeline(cfg, mesh, n_microbatches, batch["x"].shape[0])
    S, s = w.pp, w.pp_rank
    rec = _stages(w, params, cfg, batch["x"], batch["h"], batch["d"], M,
                  compute_dtype, remat, True)
    outs = rec["outs"]
    if s == S - 1:
        logits = postprocess(params, torch.cat([sk for _, sk in outs]),
                             compute_dtype)
        loss = masked_ce_loss(logits, batch["t"], batch["valid_len"])
        loss.backward()
    else:
        loss = torch.zeros((), dtype=torch.float32, device=batch["x"].device)
    sends = []
    for m in reversed(range(M)):
        if s < S - 1:
            o, skip = outs[m]
            g_o = PD.pp_recv(o.shape, o.dtype, s + 1, 2 * M + 2 * m)
            g_skip = PD.pp_recv(skip.shape, skip.dtype, s + 1,
                                2 * M + 2 * m + 1)
            torch.autograd.backward([o, skip], [g_o, g_skip])
        if s > 0:
            o_in, skip_in = rec["ins"][m]
            sends += [PD.pp_isend(o_in.grad, s - 1, 2 * M + 2 * m),
                      PD.pp_isend(skip_in.grad, s - 1, 2 * M + 2 * m + 1)]
    roots, grads = [rec["h_up"]], [rec["h_leaf"].grad]
    if s == 0:
        roots.append(rec["o0"])
        grads.append(rec["o0_leaf"].grad)
    torch.autograd.backward(roots, grads)
    for work, _ in sends:
        work.wait()
    return loss.detach()


def log_schedule(cfg: ModelConfig, mesh, M: int) -> None:
    logging.info("pipeline parallel: %d-block stack over pp=%d GPipe "
                 "stages", n_blocks(cfg), mesh.pp)
    logging.info("GPipe: %d microbatches a step, bubble share (S-1)/(M+S-1)"
                 " = %.3f", M, bubble_share(mesh.pp, M))
