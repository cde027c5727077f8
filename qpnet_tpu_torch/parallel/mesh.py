"""The training and decode mesh: an ordered list of torch devices over a
"dp" axis and, in training, "tp", "sp" or "pp" axes; the port's
counterpart of `qpnet_tpu/parallel/mesh.py`.

JAX shards arrays over a `jax.sharding.Mesh` and lets GSPMD insert the
collectives.  The port names a device per shard instead: decode runs one
thread per shard of the utterance batch, each on its device
(`models/generate.py::batch_fast_generate(mesh=...)`), and training runs
one process per rank (`parallel/distributed.py`), whose gradients meet in
one all-reduce a step (`train/step.py`).  Batches shard over dp and
parameters are replicated, as in JAX.

The axes (training only beyond dp):
  tp: the ranks of a tp group share the batch rows of their dp index and
      hold slices of the residual channels (`train/step.py::
      param_sharding_tree`);
  sp: the ranks of an sp group share those rows and hold consecutive
      slices of the window's time axis (`time_slice`): x, t and d by
      samples, h by frames, with the halos of the shifted products and the
      pitch gather exchanged explicitly (`distributed.sp_halo`);
  pp: the ranks of a pp group share those rows and run consecutive stages
      of the residual stack (`train/pipeline.py`); pp composes with dp only.

Rank order is (dp, pp, sp, tp), tp fastest: rank = ((dp_rank * pp +
pp_rank) * sp + sp_rank) * tp + tp_rank.  So a tp group is tp consecutive
ranks (as before sp), an sp group spans sp * tp consecutive ranks and a pp
group pp consecutive ranks: every group stays on one host.  JAX's
`make_mesh` orders its axes (dp, tp, sp, pp); the shapes and axis names
below are JAX's, the placement of ranks is the port's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

MODEL_AXES = ("tp", "sp", "pp")


def check_axes(n: int, tp: int = 1, sp: int = 1, pp: int = 1,
               where: str = "") -> None:
    """Raise ValueError unless every axis is >= 1 and tp * sp * pp divides
    the n devices (JAX's "must divide" words, naming the axes > 1)."""
    sizes = dict(zip(MODEL_AXES, (tp, sp, pp)))
    if any(int(v) < 1 for v in sizes.values()) or n % (tp * sp * pp):
        axes = " x ".join(f"{k}={v}" for k, v in sizes.items() if v != 1)
        raise ValueError(f"{where}{axes} must divide the {n}-device mesh")


class Mesh:
    """A (dp, tp, sp) or (dp, pp) mesh over `devices`, in rank order (see
    the module docstring); tp = sp = pp = 1 is the dp mesh.

    A device may appear more than once: its shards then share it, as the
    JAX package's virtual CPU devices share one host (`Mesh(["cpu"] * 4)`
    in the CPU tests, `Mesh(["cuda:0"] * 2)` on a one-card machine).
    `make_mesh` takes distinct CUDA devices.  `rank` is this process's
    shard when the mesh spans processes (training, one rank each:
    `distributed.rank_mesh`), and None when one process drives every
    shard (decode, dp only)."""

    def __init__(self, devices: Sequence, rank: Optional[int] = None,
                 tp: int = 1, sp: int = 1, pp: int = 1):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if rank is not None and not 0 <= rank < len(self.devices):
            raise ValueError(f"rank {rank} outside a {len(self.devices)}-"
                             f"device mesh")
        check_axes(len(self.devices), tp, sp, pp)
        self.rank = rank
        self.tp, self.sp, self.pp = int(tp), int(sp), int(pp)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def dp(self) -> int:
        return self.size // (self.tp * self.sp * self.pp)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def shape(self) -> dict:
        """{"dp": n, then "tp", "sp", "pp" where > 1}, JAX's axis order."""
        return {"dp": self.dp, **{k: getattr(self, k) for k in MODEL_AXES
                                  if getattr(self, k) > 1}}

    def coords(self, rank: int) -> dict:
        """{"dp", "pp", "sp", "tp"} indices of a rank."""
        tp_rank, rest = rank % self.tp, rank // self.tp
        sp_rank, rest = rest % self.sp, rest // self.sp
        return {"dp": rest // self.pp, "pp": rest % self.pp, "sp": sp_rank,
                "tp": tp_rank}

    def __repr__(self) -> str:
        names = [str(d) for d in self.devices]
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return (f"Mesh({axes}, devices={names}"
                + ("" if self.rank is None else f", rank={self.rank}") + ")")


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              tp: int = 1, sp: int = 1, pp: int = 1) -> Mesh:
    """A (dp, tp, sp) or (dp, pp) mesh over the first `n_devices` distinct
    devices of type `device` (default: all of them).  Fewer than asked for
    raises: a silently truncated mesh would hide wrong sharding; so does a
    tp * sp * pp that does not divide them.  The CPU is one device; a mesh
    of CPU shards is built with `Mesh` directly."""
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
    check_axes(len(names), tp, sp, pp, "make_mesh: ")
    return Mesh(names, tp=tp, sp=sp, pp=pp)


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


def time_slice(tree: dict, sp: int, k: int) -> dict:
    """Rank k's slice of an sp group's time axis, the counterpart of the
    "sp" entry of JAX's `batch_sharding`: samples [k T/sp, (k+1) T/sp) of
    x, t and d, frames [k F/sp, (k+1) F/sp) of h (every entry's second
    axis), scalars unchanged, and "x_prev": x's one sample before the
    slice, for the embedding's shift (zeros where k = 0: the embedding
    zero-fills global t = 0).  Raises ValueError, in the words of JAX's
    `device_put`, unless sp divides every time axis: F frames, so T/sp is
    whole frames (no uneven shards, as in JAX)."""
    out = {}
    for key, v in tree.items():
        if np.ndim(v) < 2:
            out[key] = v
            continue
        n = v.shape[1]
        if n % sp:
            raise ValueError(
                f"batch entry {key!r} is time-sharded over sp={sp}: the "
                f"global size of its dimension 1 should be divisible by "
                f"{sp}, but it is equal to {n} (full shape: "
                f"{tuple(v.shape)})")
        out[key] = v[:, k * (n // sp):(k + 1) * (n // sp)]
    if "x" in tree:
        x, t0 = tree["x"], k * (tree["x"].shape[1] // sp)
        out["x_prev"] = x[:, t0 - 1:t0] if k else x[:, :1] * 0
    return out


def shard_batch(mesh: Mesh, tree: dict) -> List[dict]:
    """Each rank's part of a batch (a dict of arrays or tensors with the
    batch first; scalars are replicated), as tensors on its device: its
    dp index's rows and, under sp, its slice of the time axis
    (`time_slice`)."""
    n = {np.shape(v)[0] for v in tree.values() if np.ndim(v) > 0}
    if len(n) != 1:
        raise ValueError(f"batch entries disagree on the batch size: {n}")
    rows = shard_rows(n.pop(), mesh.dp)
    out = []
    for r, dev in enumerate(mesh.devices):
        c = mesh.coords(r)
        part = time_slice(tree, mesh.sp, c["sp"]) if mesh.sp > 1 else tree
        out.append({k: take(v, rows[c["dp"]], dev) for k, v in part.items()})
    return out
