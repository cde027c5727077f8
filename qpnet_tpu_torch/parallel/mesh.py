"""The training and decode mesh: an ordered list of torch devices over a
"dp" axis and, in training, a "tp" axis; the port's counterpart of
`qpnet_tpu/parallel/mesh.py`.

JAX shards arrays over a `jax.sharding.Mesh` and lets GSPMD insert the
collectives.  The port names a device per shard instead: decode runs one
thread per shard of the utterance batch, each on its device
(`models/generate.py::batch_fast_generate(mesh=...)`), and training runs
one process per rank (`parallel/distributed.py`), whose gradients meet in
one all-reduce a step (`train/step.py`).  Batches shard over dp and
parameters are replicated, as in JAX.

A tp axis (training only) has shape (dp = n / tp, tp): rank r sits at
(r // tp, r % tp), so a tp group is tp consecutive ranks, which stay on
one host.  Its ranks share the batch rows of their dp index and hold
slices of the residual channels (`train/step.py::param_sharding_tree`).
sp and pp are not ported: they raise NotImplementedError naming their
ROADMAP.md items.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

SP = ("sequence parallelism (sp) is not ported yet: ROADMAP.md, Queue 1 "
      "item 11")
PP = ("pipeline parallelism (pp, GPipe microbatches) is not ported yet: "
      "ROADMAP.md, Queue 1 item 12")


def check_ported_axes(sp: int = 1, pp: int = 1) -> None:
    """Raise NotImplementedError for an sp or pp axis of size > 1."""
    for size, msg in ((sp, SP), (pp, PP)):
        if size and size > 1:
            raise NotImplementedError(msg)


class Mesh:
    """A (dp, tp) mesh over `devices`, in rank order; tp = 1 is the dp
    mesh.

    A device may appear more than once: its shards then share it, as the
    JAX package's virtual CPU devices share one host (`Mesh(["cpu"] * 4)`
    in the CPU tests, `Mesh(["cuda:0"] * 2)` on a one-card machine).
    `make_mesh` takes distinct CUDA devices.  `rank` is this process's
    shard when the mesh spans processes (training, one rank each:
    `distributed.rank_mesh`), and None when one process drives every
    shard (decode, dp only)."""

    def __init__(self, devices: Sequence, rank: Optional[int] = None,
                 tp: int = 1):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if rank is not None and not 0 <= rank < len(self.devices):
            raise ValueError(f"rank {rank} outside a {len(self.devices)}-"
                             f"device mesh")
        if tp < 1 or len(self.devices) % tp:
            raise ValueError(f"tp={tp} must divide the "
                             f"{len(self.devices)}-device mesh")
        self.rank, self.tp = rank, int(tp)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def dp(self) -> int:
        return self.size // self.tp

    @property
    def axis_names(self) -> tuple:
        return ("dp", "tp") if self.tp > 1 else ("dp",)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp} if self.tp > 1 else \
            {"dp": self.dp}

    def __repr__(self) -> str:
        names = [str(d) for d in self.devices]
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return (f"Mesh({axes}, devices={names}"
                + ("" if self.rank is None else f", rank={self.rank}") + ")")


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              tp: int = 1, sp: int = 1, pp: int = 1) -> Mesh:
    """A (dp = n / tp, tp) mesh over the first `n_devices` distinct devices
    of type `device` (default: all of them).  Fewer than asked for raises:
    a silently truncated mesh would hide wrong sharding; so does a tp that
    does not divide them.  The CPU is one device; a mesh of CPU shards is
    built with `Mesh` directly."""
    check_ported_axes(sp, pp)
    kind = torch.device(device).type
    if kind == "cuda":
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        names = [f"cuda:{i}" for i in range(avail)]
    elif kind == "cpu":
        names = ["cpu"]
    else:
        raise ValueError(f"make_mesh takes cuda or cpu devices, got {device}")
    if n_devices is not None:
        if n_devices > len(names):
            raise ValueError(
                f"make_mesh: {n_devices} {kind} devices requested but only "
                f"{len(names)} available; a silently truncated mesh would "
                f"hide wrong sharding")
        names = names[:n_devices]
    if not names:
        raise ValueError(f"make_mesh: no {kind} device is available")
    if len(names) % tp:
        raise ValueError(f"make_mesh: tp={tp} must divide the "
                         f"{len(names)}-device mesh")
    return Mesh(names, tp=tp)


def shard_rows(n_rows: int, n_shards: int) -> List[slice]:
    """Equal row blocks, one per shard; n_rows must divide."""
    if n_rows % n_shards:
        raise ValueError(f"{n_rows} rows do not divide over {n_shards} "
                         f"shards")
    per = n_rows // n_shards
    return [slice(i * per, (i + 1) * per) for i in range(n_shards)]


def take(value, rows: slice, device):
    """Rows of a batch entry on `device`; a scalar passes through."""
    if np.ndim(value) == 0:
        return value
    if isinstance(value, torch.Tensor):
        return value[rows].to(device)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(value)[rows])).to(
        device)


def shard_batch(mesh: Mesh, tree: dict) -> List[dict]:
    """Each device's rows of a batch (a dict of arrays or tensors with the
    batch first; scalars are replicated), as tensors on that device."""
    n = {np.shape(v)[0] for v in tree.values() if np.ndim(v) > 0}
    if len(n) != 1:
        raise ValueError(f"batch entries disagree on the batch size: {n}")
    return [{k: take(v, rows, dev) for k, v in tree.items()}
            for rows, dev in zip(shard_rows(n.pop(), mesh.size),
                                 mesh.devices)]
