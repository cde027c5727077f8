"""Processes that train as one: the port's counterpart of
`qpnet_tpu/parallel/distributed.py`, over torch.distributed.

A world is `n_hosts` hosts with `local_ranks` ranks each, one process per
rank and one device per process: rank = host_id * local_ranks +
local_rank.  As in JAX, `process_index()` and `process_count()` count
hosts: each host reads its slice of the corpus (`host_shard_list`) and
batches it, and each of its ranks takes its rows of the host's batch
(`make_global_batch`).  So the global batch of an iteration is the JAX
package's for the same argv and corpus.

With tp > 1 the world is a (dp, tp) mesh (`mesh.Mesh`): the tp ranks of
one dp index are consecutive, on one host, and share that dp index's
rows.  Two families of subgroups are opened: the dp groups (one per tp
index), over which the gradients of each shard are averaged, and the tp
groups (one per dp index), which carry the activations of the tensor-
parallel forward and backward (`copy_to_tp`, `reduce_from_tp`,
`gather_from_tp`: the collectives GSPMD inserts in JAX, written out as
autograd functions, Megatron-style).

Every world opens a gloo group (the default group): it carries the control
scalars of each step (valid_len and the preemption flag,
`global_min_and_any`) on the host.  The ranks then gather their (hostname,
CUDA device UUID) pairs.  The gradients go over an NCCL group only when
every rank owns a distinct card; on the CPU, or where ranks share a card
(NCCL refuses two ranks on one GPU), they go over gloo, which reduces a
card's tensors through the host.  The choice is logged.

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

from qpnet_tpu_torch.parallel.mesh import Mesh, shard_rows, take


@dataclass
class World:
    """This process's place in the world, and its groups."""
    host_id: int
    n_hosts: int
    local_rank: int
    local_ranks: int
    devices: List[torch.device]    # each rank's device, as its host names it
    grad_backend: str              # "nccl" or "gloo"
    grad_group: Any = None         # this rank's dp group; None: the world
    tp: int = 1
    tp_group: Any = None           # this rank's tp group (tp > 1)
    dp_control: Any = None         # its dp group over gloo (tp > 1)
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
    def dp(self) -> int:
        return self.size // self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

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


def _dp_groups(size: int, tp: int, backend: str):
    """Every dp group (the ranks of one tp index), opened in the same order
    on every rank, as new_group requires."""
    return [dist.new_group([i * tp + j for i in range(size // tp)],
                           backend=backend) for j in range(tp)]


def _tp_groups(size: int, tp: int, backend: str):
    """Every tp group (the ranks of one dp index), in the same order on
    every rank."""
    return [dist.new_group(list(range(i * tp, (i + 1) * tp)),
                           backend=backend) for i in range(size // tp)]


def init_world(init_method: str, host_id: int, n_hosts: int,
               local_rank: int, local_ranks: int, device,
               tp: int = 1) -> World:
    """Join the world at `init_method` (tcp://host:port, or file://path
    for ranks of one host), choose the gradients' backend and, with tp > 1,
    open the dp and tp groups."""
    global _world
    if _world is not None:
        raise RuntimeError("this process already belongs to a dp world")
    if tp < 1 or local_ranks % tp:
        raise ValueError(f"tp={tp} must divide the {local_ranks} ranks of a "
                         f"host: a tp group stays on one host")
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
    group = tp_group = dp_control = None
    if tp > 1:
        group = _dp_groups(size, tp, backend)[rank % tp]
        tp_group = _tp_groups(size, tp, backend)[rank // tp]
        dp_control = (group if backend == "gloo"
                      else _dp_groups(size, tp, "gloo")[rank % tp])
    elif backend == "nccl":
        group = dist.new_group(backend="nccl")
    _world = World(host_id, n_hosts, local_rank, local_ranks,
                   [torch.device(d) for _, _, d in peers], backend, group,
                   tp, tp_group, dp_control)
    logging.info("world: rank %d of %d (host %d of %d, local rank %d of "
                 "%d) on %s, mesh dp=%d tp=%d; gradient all-reduce over %s "
                 "(%s)", rank, size, host_id, n_hosts, local_rank,
                 local_ranks, device, size // tp, tp, backend, why)
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
    """The (dp, tp) mesh of the world, one device per rank, at this
    rank."""
    if _world is None:
        raise RuntimeError("no dp world: call init_world or "
                           "initialize_multihost first")
    return Mesh(_world.devices, rank=_world.rank, tp=_world.tp)


def require_world(mesh: Mesh) -> World:
    """The world a process-spanning mesh stands for; raise if there is none
    or it does not match."""
    if mesh.rank is None or _world is None or _world.size != mesh.size \
            or _world.rank != mesh.rank or _world.tp != mesh.tp:
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
    """This rank's rows of its host's batch (a dict of arrays with the batch
    first; scalars pass through), as tensors on its device: the host's
    rows split over its dp indices, the same rows for every rank of a tp
    group."""
    w = require_world(mesh)
    n = {np.shape(v)[0] for v in tree.values() if np.ndim(v) > 0}
    if len(n) != 1:
        raise ValueError(f"batch entries disagree on the batch size: {n}")
    rows = shard_rows(n.pop(), w.local_ranks // w.tp)[w.local_rank // w.tp]
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
    """Replace `flat` by its mean over this rank's dp group (the world when
    tp = 1), in place, over the gradient group (NCCL, or gloo)."""
    w = _world
    t0 = time.perf_counter()
    if w.dp > 1:
        dist.all_reduce(flat, group=w.grad_group)
        flat.div_(w.dp)
    w.reduce_seconds += time.perf_counter() - t0
    w.reduces += 1
    return flat


def check_agreed(value, what: str, dp_only: bool = False) -> np.ndarray:
    """Every rank's value of a float scalar (with dp_only, every rank of
    this rank's dp group); raise unless they are all equal (a no-op
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
