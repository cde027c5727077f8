"""Processes that train as one: the port's counterpart of
`qpnet_tpu/parallel/distributed.py`, over torch.distributed.

A world is `n_hosts` hosts with `local_ranks` ranks each, one process per
rank and one device per process: rank = host_id * local_ranks +
local_rank.  As in JAX, `process_index()` and `process_count()` count
hosts: each host reads its slice of the corpus (`host_shard_list`) and
batches it, and each of its ranks takes its rows of the host's batch
(`make_global_batch`).  So the global batch of an iteration is the JAX
package's for the same argv and corpus.

With tp, sp or pp > 1 the world is a (dp, tp, sp) or (dp, pp) mesh
(`mesh.Mesh`, rank order (dp, pp, sp, tp)): the ranks of one dp index
are consecutive, on one host, and share that dp index's rows.  The
families of subgroups:
- the gradient groups (one per tp index: dp x sp, or dp x pp), over
  which the gradients of each shard are summed over sp and pp and
  averaged over dp in one all-reduce (`all_reduce_mean_`);
- the tp groups (one per (dp, sp) index), which carry the activations
  of the tensor-parallel forward and backward (`copy_to_tp`,
  `reduce_from_tp`, `gather_from_tp`: the collectives GSPMD inserts in
  JAX, written out as autograd functions, Megatron-style);
- the sp groups (one per (dp, tp) index), which carry the halos of the
  time-sharded forward (`sp_halo`: an all-gather of each rank's last rows
  forward, an all-reduce of their gradients backward) and agree each
  block's halo length (`sp_max`);
- the pp groups (one per dp index), which carry the GPipe stage-to-stage
  (o, skip) carry and its gradient point to point (`pp_isend`,
  `pp_recv`).

Every world opens a gloo group (the default group): it carries the control
scalars of each step (valid_len and the preemption flag,
`global_min_and_any`) on the host.  The ranks then gather their (hostname,
CUDA device UUID) pairs.  The gradients and the tp, sp and pp traffic go
over NCCL groups only when every rank owns a distinct card; on the CPU,
or where ranks share a card (NCCL refuses two ranks on one GPU), they go
over gloo, which moves a card's tensors through the host in its
collectives.  gloo sends no CUDA tensor point to point, so over gloo the
pipeline's carry is staged through the host explicitly.  The choice is
logged.

Activation: pass --coordinator/--n_hosts/--host_id to the train CLI, or
set QPNET_COORDINATOR / QPNET_NUM_HOSTS / QPNET_HOST_ID.  The coordinator
(host:port) is where rank 0 opens the rendezvous store.
"""

from __future__ import annotations

import logging
import os
import socket
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from qpnet_tpu_torch.parallel.mesh import (Mesh, check_axes, shard_rows,
                                           take, time_slice)


@dataclass
class World:
    """This process's place in the world, and its groups."""
    host_id: int
    n_hosts: int
    local_rank: int
    local_ranks: int
    devices: List[torch.device]    # each rank's device, as its host names it
    grad_backend: str              # "nccl" or "gloo"
    grad_group: Any = None         # this rank's gradient group; None: the
                                   # world
    tp: int = 1
    tp_group: Any = None           # this rank's tp group (tp > 1)
    dp_control: Any = None         # its gradient group over gloo (tp > 1)
    sp: int = 1
    sp_group: Any = None           # this rank's sp group (sp > 1)
    sp_control: Any = None         # the same over gloo
    pp: int = 1
    pp_group: Any = None           # this rank's pp group (pp > 1)
    reduce_seconds: float = 0.0    # host clock over the all-reduces (gloo
                                   # waits for them; NCCL's only enqueue)
    reduces: int = 0

    @property
    def rank(self) -> int:
        return self.host_id * self.local_ranks + self.local_rank

    @property
    def size(self) -> int:
        return self.n_hosts * self.local_ranks

    @property
    def model(self) -> int:
        """Ranks per dp index: tp * sp * pp."""
        return self.tp * self.sp * self.pp

    @property
    def dp(self) -> int:
        return self.size // self.model

    @property
    def dp_rank(self) -> int:
        return self.rank // self.model

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def sp_rank(self) -> int:
        return self.rank // self.tp % self.sp

    @property
    def pp_rank(self) -> int:
        return self.rank // (self.tp * self.sp) % self.pp

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]


_world: Optional[World] = None


def resolve_multihost(coordinator: Optional[str] = None,
                      num_hosts: Optional[int] = None,
                      host_id: Optional[int] = None
                      ) -> Optional[Tuple[str, int, int]]:
    """(coordinator, num_hosts, host_id) from the flags, then the QPNET_*
    environment; None for a single-host run (no coordinator, or fewer than
    two hosts), as in the JAX package."""
    coordinator = coordinator or os.environ.get("QPNET_COORDINATOR")
    if num_hosts is None:
        num_hosts = int(os.environ.get("QPNET_NUM_HOSTS", "0")) or None
    if host_id is None and "QPNET_HOST_ID" in os.environ:
        host_id = int(os.environ["QPNET_HOST_ID"])
    if not coordinator or not num_hosts or num_hosts <= 1:
        return None
    if host_id is None or not 0 <= host_id < num_hosts:
        raise ValueError(f"a {num_hosts}-host run needs --host_id (or "
                         f"QPNET_HOST_ID) in [0, {num_hosts}), got {host_id}")
    return coordinator, int(num_hosts), int(host_id)


def _card_id(device: torch.device) -> Optional[str]:
    if device.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(device).uuid)


def _grad_groups(size: int, tp: int, backend: str):
    """Every gradient group (the ranks of one tp index), opened in the same
    order on every rank, as new_group requires."""
    return [dist.new_group(list(range(j, size, tp)), backend=backend)
            for j in range(tp)]


def _tp_groups(size: int, tp: int, backend: str):
    """Every tp group (tp consecutive ranks), in the same order on every
    rank."""
    return [dist.new_group(list(range(i * tp, (i + 1) * tp)),
                           backend=backend) for i in range(size // tp)]


def _sp_groups(size: int, tp: int, sp: int, backend: str):
    """Every sp group (the ranks of one (dp, tp) index, tp apart), in the
    same order on every rank: group i * tp + j holds i * sp * tp + j +
    s * tp for s < sp."""
    return [dist.new_group([i * sp * tp + s * tp + j for s in range(sp)],
                           backend=backend)
            for i in range(size // (sp * tp)) for j in range(tp)]


def _pp_groups(size: int, pp: int, backend: str):
    """Every pp group (pp consecutive ranks), in the same order on every
    rank."""
    return [dist.new_group(list(range(i * pp, (i + 1) * pp)),
                           backend=backend) for i in range(size // pp)]


def init_world(init_method: str, host_id: int, n_hosts: int,
               local_rank: int, local_ranks: int, device,
               tp: int = 1, sp: int = 1, pp: int = 1) -> World:
    """Join the world at `init_method` (tcp://host:port, or file://path
    for ranks of one host), choose the backend of the gradients and the
    model-parallel traffic and, with tp, sp or pp > 1, open their
    groups."""
    global _world
    if _world is not None:
        raise RuntimeError("this process already belongs to a dp world")
    check_axes(local_ranks, tp, sp, pp)
    if pp > 1 and tp * sp > 1:
        raise ValueError("pp composes with dp only (not tp/sp)")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = host_id * local_ranks + local_rank
    size = n_hosts * local_ranks
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=size, rank=rank)
    mine = (socket.gethostname(), _card_id(device), str(device))
    peers: List[Any] = [None] * size
    dist.all_gather_object(peers, mine)
    cards = [(host, card) for host, card, _ in peers]
    on_cards = all(card is not None for _, card in cards)
    distinct = on_cards and len(set(cards)) == size
    if distinct and dist.is_nccl_available():
        backend, why = "nccl", "each rank owns a distinct card"
    else:
        backend = "gloo"
        why = ("the ranks run on the CPU" if not on_cards else
               "the ranks share a card" if not distinct else
               "this torch has no NCCL")
    groups = {}
    if tp > 1:
        groups["grad_group"] = _grad_groups(size, tp, backend)[rank % tp]
        groups["tp_group"] = _tp_groups(size, tp, backend)[rank // tp]
        groups["dp_control"] = (
            groups["grad_group"] if backend == "gloo"
            else _grad_groups(size, tp, "gloo")[rank % tp])
    elif backend == "nccl":
        groups["grad_group"] = dist.new_group(backend="nccl")
    if sp > 1:
        mine_sp = rank // (sp * tp) * tp + rank % tp
        groups["sp_group"] = _sp_groups(size, tp, sp, backend)[mine_sp]
        groups["sp_control"] = (
            groups["sp_group"] if backend == "gloo"
            else _sp_groups(size, tp, sp, "gloo")[mine_sp])
    if pp > 1:
        groups["pp_group"] = _pp_groups(size, pp, backend)[rank // pp]
    _world = World(host_id, n_hosts, local_rank, local_ranks,
                   [torch.device(d) for _, _, d in peers], backend,
                   tp=tp, sp=sp, pp=pp, **groups)
    logging.info("world: rank %d of %d (host %d of %d, local rank %d of "
                 "%d) on %s, mesh dp=%d tp=%d sp=%d pp=%d; gradient "
                 "all-reduce over %s (%s), the tp, sp and pp traffic too",
                 rank, size, host_id, n_hosts, local_rank, local_ranks,
                 device, _world.dp, tp, sp, pp, backend, why)
    return _world


def initialize_multihost(coordinator: Optional[str] = None,
                         num_hosts: Optional[int] = None,
                         host_id: Optional[int] = None,
                         local_rank: int = 0, local_ranks: int = 1,
                         device="cpu") -> bool:
    """Connect this process to the multi-host world; True when one was
    joined, False for the single-host case (no coordinator or fewer than
    two hosts, from the flags or the QPNET_* environment)."""
    hosts = resolve_multihost(coordinator, num_hosts, host_id)
    if hosts is None:
        return False
    coordinator, num_hosts, host_id = hosts
    init_world(f"tcp://{coordinator}", host_id, num_hosts, local_rank,
               local_ranks, device)
    return True


def shutdown() -> None:
    """Leave the dp world (a no-op outside one)."""
    global _world
    if _world is not None:
        _world = None
        dist.destroy_process_group()


def rank_mesh() -> Mesh:
    """The mesh of the world, one device per rank, at this rank."""
    if _world is None:
        raise RuntimeError("no dp world: call init_world or "
                           "initialize_multihost first")
    return Mesh(_world.devices, rank=_world.rank, tp=_world.tp,
                sp=_world.sp, pp=_world.pp)


def require_world(mesh: Mesh) -> World:
    """The world a process-spanning mesh stands for; raise if there is none
    or it does not match."""
    if mesh.rank is None or _world is None or _world.size != mesh.size \
            or _world.rank != mesh.rank or (_world.tp, _world.sp,
                                             _world.pp) != (mesh.tp, mesh.sp,
                                                            mesh.pp):
        raise ValueError(
            f"{mesh} does not span this process's dp world "
            f"({'none' if _world is None else _world.size} ranks): dp "
            f"training runs one process per rank (init_world, rank_mesh)")
    return _world


def process_index() -> int:
    return 0 if _world is None else _world.host_id


def process_count() -> int:
    return 1 if _world is None else _world.n_hosts


def host_shard_list(items: Sequence) -> list:
    """This host's slice of a work list (strided so sorted-by-length lists
    stay balanced across hosts)."""
    return list(items)[process_index()::process_count()]


def make_global_batch(mesh: Mesh, tree: dict) -> dict:
    """This rank's part of its host's batch (a dict of arrays with the
    batch first; scalars pass through), as tensors on its device: the
    host's rows split over its dp indices, the same rows for every rank of
    a tp, sp or pp group; under sp, the rank's slice of the time axis and
    the one sample of x before it ("x_prev", `mesh.time_slice`)."""
    w = require_world(mesh)
    n = {np.shape(v)[0] for v in tree.values() if np.ndim(v) > 0}
    if len(n) != 1:
        raise ValueError(f"batch entries disagree on the batch size: {n}")
    rows = shard_rows(n.pop(), w.local_ranks // w.model)[
        w.local_rank // w.model]
    if w.sp > 1:
        tree = time_slice(tree, w.sp, w.sp_rank)
    return {k: take(v, rows, w.device) for k, v in tree.items()}


def _gather(values, dtype=np.int64, group=None) -> np.ndarray:
    """(ranks, len(values)) of every rank's values in `group` (default:
    the world), over gloo."""
    mine = torch.as_tensor(np.asarray(values, dtype).reshape(-1))
    out = [torch.empty_like(mine)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, mine, group=group)
    return torch.stack(out).numpy()


def global_min_and_any(value, flag) -> tuple:
    """(min of a scalar over the ranks, OR of a flag over the ranks) in ONE
    host-side all-gather (no-op outside a world).  The trainer's per-step
    valid_len sync carries the preemption flag this way, so one rank's
    trip stops every rank at the same iteration."""
    val = np.asarray(value)
    if _world is None or _world.size == 1:
        return val, bool(flag)
    g = _gather([int(value), int(bool(flag))])
    return np.asarray(g[:, 0].min(), val.dtype), bool(g[:, 1].max())


def global_min_scalar(value) -> np.ndarray:
    """Minimum of a scalar over the ranks (no-op outside a world)."""
    if _world is None or _world.size == 1:
        return np.asarray(value)
    return np.asarray(_gather([int(value)])[:, 0].min(),
                      np.asarray(value).dtype)


def all_reduce_mean_(flat: torch.Tensor) -> torch.Tensor:
    """Replace `flat` by its sum over this rank's gradient group (the
    ranks of its tp index: the world when tp = 1) divided by dp, in place,
    over NCCL or gloo: the mean over the dp replicas of the sum over the
    sp slices or pp stages, whose gradients and losses are partial."""
    w = _world
    t0 = time.perf_counter()
    if w.size // w.tp > 1:
        dist.all_reduce(flat, group=w.grad_group)
        flat.div_(w.dp)
    w.reduce_seconds += time.perf_counter() - t0
    w.reduces += 1
    return flat


def check_agreed(value, what: str, dp_only: bool = False) -> np.ndarray:
    """Every rank's value of a float scalar (with dp_only, every rank of
    this rank's gradient group); raise unless they are all equal (a no-op
    outside a world)."""
    if _world is None:
        return np.asarray([value], np.float64)
    got = _gather([value], np.float64,
                  _world.dp_control if dp_only else None)[:, 0]
    if not (got == got[0]).all():
        raise RuntimeError(f"the ranks disagree on {what}: {got.tolist()}")
    return got


def broadcast_(leaves: Sequence[torch.Tensor]) -> None:
    """Overwrite the tensors with rank 0's, in place, in one broadcast of
    one buffer over the gloo group (through the host for card tensors)."""
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1).cpu() for t in leaves])
        dist.broadcast(flat, src=0)
        off = 0
        for t in leaves:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


# ---------------------------------------------------------------------------
# the tensor-parallel collectives (over this rank's tp group)
# ---------------------------------------------------------------------------

def _tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=_world.tp_group)
    return out


class _CopyToTp(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the tp group
    (the input is replicated, and each rank's products reach only its
    slice of the channels)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tp_all_reduce(g)


class _ReduceFromTp(torch.autograd.Function):
    """Sum over the tp group forward (row-parallel partial products);
    identity backward."""

    @staticmethod
    def forward(ctx, x):
        return _tp_all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromTp(torch.autograd.Function):
    """Every rank's slice of the last axis, concatenated in tp order;
    the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x):
        ctx.width = x.shape[-1]
        return torch.cat(tp_all_gather(x), -1)

    @staticmethod
    def backward(ctx, g):
        k = _world.tp_rank
        return g[..., k * ctx.width:(k + 1) * ctx.width].contiguous()


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    return _CopyToTp.apply(x)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromTp.apply(x)


def gather_from_tp(x: torch.Tensor) -> torch.Tensor:
    return _GatherFromTp.apply(x)


def tp_all_gather(x: torch.Tensor) -> List[torch.Tensor]:
    """Every tp rank's tensor of x's shape, in tp order (no autograd)."""
    parts = [torch.empty_like(x) for _ in range(_world.tp)]
    dist.all_gather(parts, x.contiguous(), group=_world.tp_group)
    return parts


# ---------------------------------------------------------------------------
# the sequence-parallel halo (over this rank's sp group)
# ---------------------------------------------------------------------------

def sp_position() -> Tuple[int, int]:
    """(this rank's index in its sp group, the group's size); (0, 1)
    outside a world."""
    return (0, 1) if _world is None else (_world.sp_rank, _world.sp)


def sp_max(values) -> np.ndarray:
    """The elementwise max of an int vector over this rank's sp group, in
    one host-side all-gather (gloo)."""
    return _gather(values, group=_world.sp_control).max(0)


def _halo_span(k: int, H: int, T_l: int) -> Tuple[int, int, int]:
    """(Hc, first, n): each rank contributes its last Hc = min(H, T_l)
    rows; the halo of rank k takes the tails of ranks first .. first + n -
    1 (n = min(k, ceil(H / Hc)), the ranks just before it), which cover
    global [t0 - n Hc, t0) when Hc = H or Hc = T_l."""
    Hc = min(H, T_l)
    n = min(k, -(-H // Hc))
    return Hc, k - n, n


class _SpHalo(torch.autograd.Function):
    """The H rows of o (B, T/sp, C) that precede this rank's first sample
    in the global window, zeros before global t = 0: an all-gather of every
    rank's last min(H, T/sp) rows over the sp group, so rows that lie on
    several predecessors (H > T/sp) arrive in the one collective.  The
    backward puts each slice of the halo's gradient in its owner's slot of
    an (sp, B, Hc, C) buffer and sums the buffer over the group: each rank
    then adds its slot to the gradient of its own last rows."""

    @staticmethod
    def forward(ctx, o, H: int):
        w = _world
        B, T_l, C = o.shape
        Hc, first, n = _halo_span(w.sp_rank, H, T_l)
        ctx.meta = (H, T_l, Hc, first, n)
        tails = [torch.empty((B, Hc, C), dtype=o.dtype, device=o.device)
                 for _ in range(w.sp)]
        dist.all_gather(tails, o[:, T_l - Hc:].contiguous(),
                        group=w.sp_group)
        have = torch.cat(tails[first:first + n] or [o[:, :0]], 1)
        have = have[:, max(0, n * Hc - H):]
        return torch.cat([o.new_zeros((B, H - have.shape[1], C)), have], 1)

    @staticmethod
    def backward(ctx, g):
        w = _world
        H, T_l, Hc, first, n = ctx.meta
        B, _, C = g.shape
        mine = min(H, n * Hc)
        spread = g.new_zeros((B, n * Hc, C))
        spread[:, n * Hc - mine:] = g[:, H - mine:]
        buf = g.new_zeros((w.sp, B, Hc, C))
        buf[first:first + n] = spread.view(B, n, Hc, C).transpose(0, 1)
        dist.all_reduce(buf, group=w.sp_group)
        grad = g.new_zeros((B, T_l, C))
        grad[:, T_l - Hc:] = buf[w.sp_rank]
        return grad, None


def sp_halo(o: torch.Tensor, H: int) -> torch.Tensor:
    """(B, H, C): the H rows of the time-sharded o (B, T/sp, C) before this
    rank's slice, zeros before global t = 0 (`_SpHalo`).  Every rank of the
    sp group calls it with the same H; H = 0 exchanges nothing."""
    if H == 0:
        return o[:, :0]
    return _SpHalo.apply(o, int(H))


# ---------------------------------------------------------------------------
# the pipeline's carry (point to point within this rank's pp group)
# ---------------------------------------------------------------------------

def _stage_rank(stage: int) -> int:
    """The rank of `stage` in this rank's pp group (pp ranks are
    consecutive: pp composes with dp only)."""
    return _world.rank - _world.pp_rank + stage


def pp_isend(t: torch.Tensor, stage: int, tag: int):
    """Start sending t to `stage` of this rank's pp group; returns the
    pending work and the buffer it reads (keep both until `wait`).  Over
    NCCL the buffer is t itself; over gloo, which sends no CUDA tensor
    point to point, a host copy."""
    w = _world
    buf = (t.detach().contiguous() if w.grad_backend == "nccl"
           else t.detach().to("cpu").contiguous())
    return dist.isend(buf, dst=_stage_rank(stage), group=w.pp_group,
                      tag=tag), buf


def pp_recv(shape, dtype, stage: int, tag: int) -> torch.Tensor:
    """Receive a tensor of `shape` and `dtype` from `stage` of this rank's
    pp group, on this rank's device (through the host over gloo)."""
    w = _world
    where = w.device if w.grad_backend == "nccl" else "cpu"
    buf = torch.empty(shape, dtype=dtype, device=where)
    dist.recv(buf, src=_stage_rank(stage), group=w.pp_group, tag=tag)
    return buf.to(w.device)
