"""Training and eval steps: masked cross-entropy, Adam with the L2 term in
the gradient, and the step that runs the forward with either engine and
updates the parameters in place, on one device or as one rank of a dp
world.

The JAX package's `make_optimizer` chains `add_decayed_weights(wd)` (when
wd > 0), `scale_by_adam(0.9, 0.999, 1e-8)` and `scale(-lr)`: the decay
enters the gradient before the moments, which is the update of
`torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)`.
Adam's moments map to the JAX package's checkpoint as {"count": step,
"mu": exp_avg tree, "nu": exp_avg_sq tree} in the parameters' layout.

Under a dp mesh (`parallel.distributed.rank_mesh`) each rank takes the
masked loss of its own rows; the gradients and the loss then meet in one
all-reduce of one flattened buffer, in the parameter tree's fixed order, and
every rank takes their mean before Adam steps.  The rows and T are equal per
rank and valid_len is agreed over the ranks, so the mean of the local losses
is the global batch's loss, as in the JAX package's GSPMD step.

Under a (dp, tp) mesh each rank holds its shard of the parameters and of
Adam's moments (`param_sharding_tree`, `shard_train_state`) and runs
`models/qpnet.py::forward(tp=True)`, whose collectives over the tp group take
the place of the ones GSPMD inserts in JAX; the gradients of each shard are
then averaged over its dp group only, since the shards differ from tp rank
to tp rank.  The tp forward is the plain engine: K2 runs the whole width.

Under sp each rank runs `forward(sp=True)` on its slice of the window and
takes `masked_ce_loss` over it by global t, its numerator local and its
count global, so the sum of the losses over the sp group is the window's;
under pp each rank runs its GPipe stage (`train/pipeline.py`) and the last
stage takes the loss.  In both the gradients (and the loss) are partial:
one all-reduce over the gradient group sums them over sp or pp and
averages them over dp.  Both run the plain engine, as JAX does under a
mesh.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models.qpnet import Params, forward, tree_map

# the gate's leaves: their 2R axis holds [s | t], and a tp shard takes the
# same R/tp channels of both halves
GATE_KEYS = ("W_cur", "W_prev", "W_aux", "b_gate")


class TrainState(NamedTuple):
    params: Params
    opt_state: torch.optim.Optimizer   # holds the params it updates in place
    iterations: int


def tree_leaves(tree):
    """Leaves in the JAX package's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


class Adam:
    """The optimizer's settings; `init(params)` makes its state, a
    torch.optim.Adam over the parameter leaves (marked as needing grads)."""

    def __init__(self, lr: float = 1e-4, weight_decay: float = 0.0):
        self.lr, self.weight_decay = float(lr), float(weight_decay)

    @classmethod
    def of(cls, opt: torch.optim.Adam) -> "Adam":
        """The settings an Adam made by `init` was made with."""
        group = opt.param_groups[0]
        return cls(group["lr"], group["weight_decay"])

    def init(self, params: Params) -> torch.optim.Adam:
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        return torch.optim.Adam(leaves, lr=self.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=self.weight_decay)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.0) -> Adam:
    return Adam(lr, weight_decay)


def optimizer_state(opt: torch.optim.Optimizer, params: Params) -> dict:
    """{"count": int, "mu": tree, "nu": tree} of numpy arrays (zeros
    before the first step)."""
    count = 0

    def moment(key):
        def get(p):
            st = opt.state.get(p, {})
            if key not in st:
                return np.zeros(tuple(p.shape), np.float32)
            return st[key].detach().cpu().numpy()
        return tree_map(get, params)

    for p in tree_leaves(params):
        if "step" in opt.state.get(p, {}):
            count = int(float(opt.state[p]["step"]))
            break
    return {"count": count, "mu": moment("exp_avg"),
            "nu": moment("exp_avg_sq")}


def load_optimizer_state(opt: torch.optim.Optimizer, params: Params,
                         state: dict) -> None:
    """Load {"count", "mu", "nu"} (numpy trees in the params' layout) into
    `opt`, whose parameters are the leaves of `params`."""
    leaves = tree_leaves(params)
    mus, nus = tree_leaves(state["mu"]), tree_leaves(state["nu"])
    if not len(leaves) == len(mus) == len(nus):
        raise ValueError("optimizer state does not match the parameters")
    count = int(np.asarray(state["count"]))
    for p, mu, nu in zip(leaves, mus, nus):
        like = dict(dtype=p.dtype, device=p.device)
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.asarray(mu), **like).reshape(
                p.shape).clone(),
            "exp_avg_sq": torch.as_tensor(np.asarray(nu), **like).reshape(
                p.shape).clone(),
        }


# ---------------------------------------------------------------------------
# tensor parallelism: the layout of a rank's shard
# ---------------------------------------------------------------------------

def param_sharding_tree(mesh, params: Params):
    """Each parameter leaf's sharded axis under the mesh's tp axis, or None
    for a replicated leaf (every leaf when tp = 1): the JAX package's
    layout (`qpnet_tpu/train/step.py::param_sharding_tree`).  The gate
    projections W_cur, W_prev, W_aux and b_gate are column-parallel over
    the 2R axis, with each rank's columns paired (`shard_leaf`); W_skip and
    W_res row-parallel over their R input rows; the causal embeddings and
    b_causal over R; the upsampler, the post-net, b_skip and b_res
    replicated.  Raises ValueError unless tp divides n_resch."""
    tp = getattr(mesh, "tp", 1)
    if tp > 1:
        R = (list(params["fixed"])
             + list(params["adaptive"]))[0]["W_res"].shape[0]
        if R % tp:
            raise ValueError(f"tp={tp} must divide n_resch={R}")
    return sharded_axes(mesh, params)


def sharded_axes(mesh, tree):
    """`param_sharding_tree` without its check: the layout of any tree in
    the parameters' layout, whole or one rank's shard."""
    if getattr(mesh, "tp", 1) == 1:
        return tree_map(lambda _: None, tree)

    def block(_):
        return {"W_cur": 1, "W_prev": 1, "W_aux": 1, "b_gate": 0,
                "W_skip": 0, "b_skip": None, "W_res": 0, "b_res": None}

    return {
        "embed_prev": 1, "embed_cur": 1, "b_causal": 0, "up_w": None,
        "up_b": None, "fixed": [block(b) for b in tree["fixed"]],
        "adaptive": [block(b) for b in tree["adaptive"]],
        "W_post1": None, "b_post1": None, "W_post2": None, "b_post2": None,
    }


def map_sharded(fn, tree, spec, key=None):
    """fn(leaf, axis, paired) over a parameter tree (or a tree in its
    layout) and its `param_sharding_tree`; paired marks the gate's
    leaves."""
    if isinstance(tree, dict):
        return {k: map_sharded(fn, tree[k], spec[k], k) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [map_sharded(fn, t, s, key) for t, s in zip(tree, spec)]
    return fn(tree, spec, key in GATE_KEYS)


def shard_leaf(t: torch.Tensor, axis, paired: bool, k: int,
               tp: int) -> torch.Tensor:
    """Rank k's slice of a whole leaf, as a new contiguous tensor: the
    k-th of tp equal blocks of the axis or, for a gate leaf, the k-th
    block of each half of its 2R axis (columns [kR/tp, (k+1)R/tp) and R +
    the same), so that a rank holds s and t of the same channels."""
    t = t.detach()
    if axis is None:
        return t.clone()
    n = t.shape[axis]
    if paired:
        half, w = n // 2, n // 2 // tp
        return torch.cat([t.narrow(axis, k * w, w),
                          t.narrow(axis, half + k * w, w)], axis)
    w = n // tp
    return t.narrow(axis, k * w, w).clone(
        memory_format=torch.contiguous_format)


def unshard_leaf(parts, axis, paired: bool) -> torch.Tensor:
    """The whole leaf from every rank's slice, in tp order (the JAX
    layout: a gate leaf's halves un-paired)."""
    if axis is None:
        return parts[0]
    if paired:
        w = parts[0].shape[axis] // 2
        return torch.cat([p.narrow(axis, 0, w) for p in parts]
                         + [p.narrow(axis, w, w) for p in parts], axis)
    return torch.cat(list(parts), axis)


def shard_train_state(mesh, state: "TrainState") -> "TrainState":
    """This rank's shard of a whole TrainState under the mesh's tp axis:
    its slice of every sharded parameter, and a new Adam (the same
    settings) over the slices whose moments and step count are the same
    slices of the old one's.  The state unchanged when tp = 1."""
    if getattr(mesh, "tp", 1) == 1:
        return state
    from qpnet_tpu_torch.parallel.distributed import require_world
    w = require_world(mesh)
    old = state.opt_state
    moments = []

    def cut(p, axis, paired):
        new = shard_leaf(p, axis, paired, w.tp_rank, w.tp)
        st = old.state.get(p)
        if st:
            moments.append((new, {
                "step": st["step"].clone(),
                "exp_avg": shard_leaf(st["exp_avg"], axis, paired,
                                      w.tp_rank, w.tp),
                "exp_avg_sq": shard_leaf(st["exp_avg_sq"], axis, paired,
                                         w.tp_rank, w.tp)}))
        return new

    params = map_sharded(cut, state.params,
                         param_sharding_tree(mesh, state.params))
    opt = Adam.of(old).init(params)
    for p, st in moments:
        opt.state[p] = st
    return TrainState(params, opt, state.iterations)


def gather_params(mesh, tree):
    """The whole tree (the JAX layout) from every tp rank's shard of a
    tree in the parameters' layout (the parameters, their gradients or
    Adam's moments): an all-gather over the tp group for each sharded
    leaf.  Every rank of the tp group must call it; the tree unchanged
    when tp = 1."""
    if getattr(mesh, "tp", 1) == 1:
        return tree
    from qpnet_tpu_torch.parallel.distributed import tp_all_gather
    return map_sharded(
        lambda t, axis, paired: t if axis is None else
        unshard_leaf(tp_all_gather(t.detach()), axis, paired), tree,
        sharded_axes(mesh, tree))


def full_optimizer_state(mesh, opt: torch.optim.Optimizer,
                         params: Params) -> dict:
    """`optimizer_state` (numpy trees) in the JAX layout: under tp the
    moments of every rank's shard, gathered (a collective over the tp
    group)."""
    local = optimizer_state(opt, params)
    if getattr(mesh, "tp", 1) == 1:
        return local
    dev = tree_leaves(params)[0].device
    return {"count": local["count"], **{
        k: tree_map(lambda t: t.cpu().numpy(), gather_params(mesh, tree_map(
            lambda a: torch.from_numpy(a).to(dev), local[k])))
        for k in ("mu", "nu")}}


def masked_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                   valid_len, offset: int = 0,
                   total: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy over the last `valid_len` positions of each
    sequence of `total` positions (default: T), of which logits hold T
    from global position `offset` (an sp rank's slice): the sum over the
    slice's positions divided by the count over the whole sequences, so
    the slices' losses sum to the sequences'."""
    B, T, Q = logits.shape
    total = T if total is None else total
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    t = offset + torch.arange(T, device=logits.device)[None, :].expand(B, T)
    valid_len = torch.as_tensor(valid_len, device=logits.device)
    mask = (t >= total - valid_len).float()
    count = B * torch.clamp(valid_len, 0, total).float()
    return (nll * mask).sum() / torch.clamp(count, min=1.0)


def batch_to_device(batch: dict, device) -> dict:
    """Numpy batch (the batcher's) -> tensors on `device`."""
    out = {k: torch.as_tensor(np.asarray(batch[k])).to(device)
           for k in ("x", "h", "t", "d")}
    out["valid_len"] = int(batch["valid_len"])
    return out


def _loss_fn(params, cfg, batch, compute_dtype, remat, fixed_engine="xla",
             maxd_bucket=None, tp=False, sp=(0, 1)):
    """The masked loss of a forward; sp = (this rank's index, the group's
    size) takes the loss of the rank's time slice (`masked_ce_loss`)."""
    k, n = sp
    logits = forward(params, cfg, batch["x"], batch["h"], batch["d"],
                     compute_dtype=compute_dtype, remat=remat,
                     fixed_engine=fixed_engine, maxd_bucket=maxd_bucket,
                     tp=tp, sp=n > 1,
                     x_prev=batch.get("x_prev") if k else None)
    T_l = batch["x"].shape[1]
    return masked_ce_loss(logits, batch["t"], batch["valid_len"], k * T_l,
                          n * T_l)


def resolve_fixed_engine(fixed_engine: str, cfg: ModelConfig, B: int,
                         T: int, compute_dtype) -> str:
    """'auto' -> 'xla', the plain engine, as in the JAX package: the fused
    kernel is opt-in ('pallas') until measurements on the card decide."""
    if fixed_engine not in ("auto", "xla", "pallas"):
        raise ValueError("fixed_engine should be auto, xla or pallas")
    return "xla" if fixed_engine == "auto" else fixed_engine


def make_train_step(cfg: ModelConfig, tx: Adam, mesh: Optional[Any] = None,
                    compute_dtype=torch.float32, remat: bool = True,
                    fixed_engine: str = "auto",
                    n_microbatches: Optional[int] = None):
    """Returns step(state, batch, maxd_bucket=None) -> (state, loss).

    batch: {"x": (B,T) int, "h": (B,F,A) f32, "t": (B,T) int, "d": (B,T)
    f32, "valid_len": int} as tensors on the parameters' device: under a
    mesh, this rank's rows, with valid_len agreed over the ranks.  The
    parameters are updated in place by the optimizer held in the state;
    the loss is returned as a device tensor (no host sync on one device;
    under a mesh, the global loss after the all-reduce).  fixed_engine
    "auto" resolves to "xla"; "pallas" runs K2 on each rank's rows.  Under
    a tp mesh the state is this rank's shard (`shard_train_state`), the
    forward is `forward(tp=True)`; under sp it is `forward(sp=True)` on the
    rank's time slice (the batch also holds "x_prev", as
    `make_global_batch` gives it); under pp it is the rank's GPipe stage
    over n_microbatches (default pp; ignored without a pp axis, as in
    JAX).  Under tp, sp or pp "pallas" raises ValueError.
    """
    world = None
    if mesh is not None:
        from qpnet_tpu_torch.parallel.distributed import require_world
        world = require_world(mesh)
    tp = world is not None and world.tp > 1
    sp = (world.sp_rank, world.sp) if world is not None else (0, 1)
    pp = world is not None and world.pp > 1
    if fixed_engine == "pallas" and world is not None and world.model > 1:
        why = (f"under tp={world.tp} a rank holds n_resch/{world.tp} "
               f"channels" if tp else
               f"under sp={world.sp} a rank holds a slice of the window"
               if world.sp > 1 else
               f"under pp={world.pp} a rank runs a stage of the stack")
        raise ValueError(
            f"fixed_engine='pallas' runs the fused training kernel over the "
            f"whole residual width, window and stack, and {why}: use 'auto' "
            f"or 'xla' (the plain engine, as the JAX package runs under a "
            f"mesh)")
    if pp:
        from qpnet_tpu_torch.train import pipeline as PL
        M = PL.check_pipeline(cfg, mesh, n_microbatches)
        PL.log_schedule(cfg, mesh, M)

    def step(state: TrainState, batch, maxd_bucket=None):
        B, T = batch["x"].shape
        engine = resolve_fixed_engine(fixed_engine, cfg, B, T, compute_dtype)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        if pp:
            loss = PL.pipeline_backward(state.params, cfg, batch, mesh, M,
                                        compute_dtype, remat)
        else:
            loss = _loss_fn(state.params, cfg, batch, compute_dtype, remat,
                            engine,
                            maxd_bucket if engine == "pallas" else None, tp,
                            sp)
            loss.backward()
        for p in tree_leaves(state.params):
            # a leaf no output depends on (the last block's W_res) gets a
            # zero gradient, as in JAX, so Adam and the decay still step it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if world is not None:
            loss = _all_reduce_mean(tree_leaves(state.params), loss)
        opt.step()
        return TrainState(state.params, opt, state.iterations + 1), \
            loss.detach()

    return step


def _all_reduce_mean(leaves, loss: torch.Tensor) -> torch.Tensor:
    """Sum the leaves' gradients and the loss over this rank's gradient
    group and divide them by dp (`all_reduce_mean_`) in one all-reduce of
    one buffer: [grads in leaf order, loss]."""
    from qpnet_tpu_torch.parallel.distributed import all_reduce_mean_
    flat = torch.cat([p.grad.reshape(-1) for p in leaves]
                     + [loss.detach().reshape(1).to(leaves[0].grad.dtype)])
    all_reduce_mean_(flat)
    off = 0
    for p in leaves:
        p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
        off += p.numel()
    return flat[-1]


def make_eval_step(cfg: ModelConfig, compute_dtype=torch.float32):
    """Teacher-forced loss only."""

    def step(params: Params, batch) -> torch.Tensor:
        with torch.no_grad():
            return _loss_fn(params, cfg, batch, compute_dtype, remat=False)

    return step
