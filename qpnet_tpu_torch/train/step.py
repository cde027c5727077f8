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
is the global batch's loss, as in the JAX package's GSPMD step.  Tensor,
sequence and pipeline parallelism (and GPipe microbatches) are not ported:
ROADMAP.md, Queue 1 items 10-12.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models.qpnet import Params, forward, tree_map
from qpnet_tpu_torch.parallel.mesh import PP


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


def masked_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                   valid_len) -> torch.Tensor:
    """Mean cross-entropy over the last `valid_len` positions of each
    sequence."""
    B, T, Q = logits.shape
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    t = torch.arange(T, device=logits.device)[None, :].expand(B, T)
    valid_len = torch.as_tensor(valid_len, device=logits.device)
    mask = (t >= T - valid_len).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def batch_to_device(batch: dict, device) -> dict:
    """Numpy batch (the batcher's) -> tensors on `device`."""
    out = {k: torch.as_tensor(np.asarray(batch[k])).to(device)
           for k in ("x", "h", "t", "d")}
    out["valid_len"] = int(batch["valid_len"])
    return out


def _loss_fn(params, cfg, batch, compute_dtype, remat, fixed_engine="xla",
             maxd_bucket=None):
    logits = forward(params, cfg, batch["x"], batch["h"], batch["d"],
                     compute_dtype=compute_dtype, remat=remat,
                     fixed_engine=fixed_engine, maxd_bucket=maxd_bucket)
    return masked_ce_loss(logits, batch["t"], batch["valid_len"])


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
    "auto" resolves to "xla"; "pallas" runs K2 on each rank's rows.
    """
    if n_microbatches:
        raise NotImplementedError(PP)
    world = None
    if mesh is not None:
        from qpnet_tpu_torch.parallel.distributed import require_world
        world = require_world(mesh)

    def step(state: TrainState, batch, maxd_bucket=None):
        B, T = batch["x"].shape
        engine = resolve_fixed_engine(fixed_engine, cfg, B, T, compute_dtype)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = _loss_fn(state.params, cfg, batch, compute_dtype, remat,
                        engine, maxd_bucket if engine == "pallas" else None)
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
    """Average the leaves' gradients and the loss over the ranks in one
    all-reduce of one buffer: [grads in leaf order, loss]."""
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
