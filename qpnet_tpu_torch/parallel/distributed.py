"""Processes that train as one: the port's counterpart of
`qpnet_tpu/parallel/distributed.py`, over torch.distributed.

A dp world is `n_hosts` hosts with `local_ranks` ranks each, one process
per rank and one device per process: rank = host_id * local_ranks +
local_rank.  As in JAX, `process_index()` and `process_count()` count
hosts: each host reads its slice of the corpus (`host_shard_list`) and
batches it, and each of its ranks takes its rows of the host's batch
(`make_global_batch`).  So the global batch of an iteration is the JAX
package's for the same argv and corpus.

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
    """This process's place in the dp world, and its gradient group."""
    host_id: int
    n_hosts: int
    local_rank: int
    local_ranks: int
    devices: List[torch.device]    # each rank's device, as its host names it
    grad_backend: str              # "nccl" or "gloo"
    grad_group: Any = None         # None: the default (gloo) group
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


def init_world(init_method: str, host_id: int, n_hosts: int,
               local_rank: int, local_ranks: int, device) -> World:
    """Join the dp world at `init_method` (tcp://host:port, or file://path
    for ranks of one host) and choose the gradients' backend."""
    global _world
    if _world is not None:
        raise RuntimeError("this process already belongs to a dp world")
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
        group = dist.new_group(backend="nccl")
    else:
        backend, group = "gloo", None
        why = ("the ranks run on the CPU" if not on_cards else
               "the ranks share a card" if not distinct else
               "this torch has no NCCL")
    _world = World(host_id, n_hosts, local_rank, local_ranks,
                   [torch.device(d) for _, _, d in peers], backend, group)
    logging.info("dp world: rank %d of %d (host %d of %d, local rank %d of "
                 "%d) on %s; gradient all-reduce over %s (%s)", rank, size,
                 host_id, n_hosts, local_rank, local_ranks, device, backend,
                 why)
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
    """The dp mesh of the world, one device per rank, at this rank."""
    if _world is None:
        raise RuntimeError("no dp world: call init_world or "
                           "initialize_multihost first")
    return Mesh(_world.devices, rank=_world.rank)


def require_world(mesh: Mesh) -> World:
    """The world a process-spanning mesh stands for; raise if there is none
    or it does not match."""
    if mesh.rank is None or _world is None or _world.size != mesh.size \
            or _world.rank != mesh.rank:
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
    first; scalars pass through), as tensors on its device."""
    w = require_world(mesh)
    n = {np.shape(v)[0] for v in tree.values() if np.ndim(v) > 0}
    if len(n) != 1:
        raise ValueError(f"batch entries disagree on the batch size: {n}")
    rows = shard_rows(n.pop(), w.local_ranks)[w.local_rank]
    return {k: take(v, rows, w.device) for k, v in tree.items()}


def _gather(values, dtype=np.int64) -> np.ndarray:
    """(size, len(values)) of every rank's values, over the gloo group."""
    mine = torch.as_tensor(np.asarray(values, dtype).reshape(-1))
    out = [torch.empty_like(mine) for _ in range(_world.size)]
    dist.all_gather(out, mine)
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
    """Replace `flat` by its mean over the ranks, in place, over the
    gradient group (NCCL, or gloo)."""
    w = _world
    t0 = time.perf_counter()
    dist.all_reduce(flat, group=w.grad_group)
    flat.div_(w.size)
    w.reduce_seconds += time.perf_counter() - t0
    w.reduces += 1
    return flat


def check_agreed(value, what: str) -> np.ndarray:
    """Every rank's value of a float scalar; raise unless they are all
    equal (a no-op outside a world)."""
    if _world is None:
        return np.asarray([value], np.float64)
    got = _gather([value], np.float64)[:, 0]
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
