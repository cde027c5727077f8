"""Quasi-Periodic WaveNet in PyTorch: parameters and the teacher-forced
forward, with the same math, layout and parameter keys as
`qpnet_tpu/models/qpnet.py`.

Parameters are a plain tree: a dict of tensors whose `fixed` and `adaptive`
entries are lists of per-block dicts.  Activations are channels-last
(B, T, C), so every 1x1 and k=2 convolution is a product on the last axis;
sequences stay full-length and end-aligned, past samples shifted in with zero
fill.

`forward(tp=True)` is the tensor-parallel form, run by each rank of a tp
group on its shard of the parameters (`train/step.py::shard_train_state`):
the rank's R/tp residual channels, its gate columns paired as [s | t] of
those channels.  `forward(sp=True)` is the sequence-parallel form, run by
each rank of an sp group on its slice of the window's time axis
(`parallel/mesh.py::time_slice`): every block reads its look-back rows
from the halo of its predecessors' last rows (`parallel/distributed.py::
sp_halo`) in gather form (`lookback_block`), the form the GPipe stages of
`train/pipeline.py` run too.

Precision: compute_dtype=float32 is the parity mode.  compute_dtype=bfloat16
rounds every product's operands to bf16, accumulates in f32, and stores the
per-block activations in bf16, while the skip sum and the logits stay f32 —
the JAX package's storage points.  The plain engine also runs in float64
(with float64 parameters), as a reference for the f32 engines' gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from qpnet_tpu_torch.config import ModelConfig

Params = Dict[str, Any]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device that is missing
    raises: nothing falls back to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree, device="cuda", dtype=torch.float32) -> Params:
    """Carry a parameter tree of arrays (numpy, or anything `np.asarray`
    takes, e.g. the JAX package's params) across to tensors on `device`."""
    device = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype), tree)


def params_to(params: Params, device) -> Params:
    return tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# initialization: Xavier-uniform over the reference convolution shapes
# ---------------------------------------------------------------------------

def _xavier(gen, shape, fan_in, fan_out, dtype, device):
    bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return (u * (2 * bound) - bound).to(dtype)


def init_params(seed: int, cfg: ModelConfig, dtype=torch.float32,
                device="cuda") -> Params:
    """Random parameters from `seed` (an explicit torch.Generator on
    `device`).  Bounds and shapes are those of the JAX package; the draws
    are not, since the two generators differ."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    Q, A, R, S = cfg.n_quantize, cfg.n_aux, cfg.n_resch, cfg.n_skipch
    k = cfg.kernel_size
    if k != 2:
        raise ValueError("kernel_size=2 is the only supported value")

    def xav(shape, fan_in, fan_out):
        return _xavier(gen, shape, fan_in, fan_out, dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def res_block(kind: str) -> Params:
        # fixed stack: one k=2 conv per branch -> fan 2R/2R;
        # adaptive stack: two k=1 convs per branch -> fan R/R
        fan = 2 * R if kind == "fixed" else R
        return {
            "W_cur": torch.cat([xav((R, R), fan, fan) for _ in range(2)], 1),
            "W_prev": torch.cat([xav((R, R), fan, fan) for _ in range(2)], 1),
            "W_aux": torch.cat([xav((A, R), A, R) for _ in range(2)], 1),
            "b_gate": zeros(2 * R),
            "W_skip": xav((R, S), R, S),
            "b_skip": zeros(S),
            "W_res": xav((R, R), R, R),
            "b_res": zeros(R),
        }

    causal_w = xav((2, Q, R), Q * k, R * k)
    return {
        "embed_prev": causal_w[0],
        "embed_cur": causal_w[1],
        "b_causal": zeros(R),
        # the upsampler starts as exact frame repetition
        "up_w": torch.ones((cfg.upsampling_factor,), dtype=dtype,
                           device=device),
        "up_b": zeros(),
        "fixed": [res_block("fixed") for _ in cfg.dilationsF],
        "adaptive": [res_block("adaptive") for _ in cfg.dilationsA],
        "W_post1": xav((S, S), S, S),
        "b_post1": zeros(S),
        "W_post2": xav((S, Q), S, Q),
        "b_post2": zeros(Q),
    }


def count_params(params: Params) -> int:
    n = 0

    def add(t):
        nonlocal n
        n += t.numel()
    tree_map(add, params)
    return n


# ---------------------------------------------------------------------------
# forward building blocks
# ---------------------------------------------------------------------------

def upsample_aux(params: Params, h: torch.Tensor, up: int) -> torch.Tensor:
    """(B, F, A) frame-rate aux -> (B, F*up, A) sample rate: a learned
    per-phase scale and a scalar bias."""
    B, F_, A = h.shape
    h_up = torch.repeat_interleave(h, up, dim=1)
    phase = params["up_w"].repeat(F_)
    return h_up * phase[None, :, None] + params["up_b"]


def shift_time(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[:, t-d] with zero fill for t<d (end-aligned causal shift)."""
    if d == 0:
        return x
    out = torch.zeros_like(x)
    out[:, d:] = x[:, : x.shape[1] - d]
    return out


def _gate(z: torch.Tensor, R: int) -> torch.Tensor:
    return torch.sigmoid(z[..., :R]) * torch.tanh(z[..., R:])


def _matmul(a, w, dtype, out_dtype=None):
    """Product on the last axis with operands rounded to `dtype`, summed in
    f32 and stored as `out_dtype` (default f32).  dtype=float64 sums and
    stores in f64: a reference for checking f32 gradients."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    return (a.to(dtype).to(acc) @ w.to(dtype).to(acc)).to(out_dtype or acc)


def _act_dtype(dtype):
    """Activation storage type for a product type: f32 math stores f32,
    bf16 math stores bf16."""
    return torch.float32 if dtype == torch.float32 else dtype


def residual_block(p: Params, o: torch.Tensor, past_of, h_up: torch.Tensor,
                   dtype, act, tp: bool = False):
    """One residual block; returns (o + res, skip).  past_of(o) gives the
    look-back rows of the block's input (its fixed or pitch-adaptive
    dilation).  The skip and residual outputs are one product with
    [W_skip | W_res].  With tp, p is this rank's shard (`train/step.py::
    shard_train_state`): the input is copied to the tp group before the
    gate products (its gradient summed over the group), the gate runs on
    the rank's R/tp paired columns, and the partial skip and residual
    products meet in one sum over the group, b_skip and b_res added once
    after it."""
    if tp:
        from qpnet_tpu_torch.parallel.distributed import (copy_to_tp,
                                                          reduce_from_tp)
        oc = copy_to_tp(o)
    else:
        oc = o
    z = (_matmul(oc, p["W_cur"], dtype, act)
         + _matmul(past_of(oc), p["W_prev"], dtype, act)
         + _matmul(h_up, p["W_aux"], dtype, act)
         + p["b_gate"].to(act))
    g = _gate(z, p["W_res"].shape[0])
    S = p["W_skip"].shape[1]
    out = _matmul(g, torch.cat([p["W_skip"], p["W_res"]], 1), dtype)
    if tp:
        out = reduce_from_tp(out)
    return (o + (out[..., S:].to(act) + p["b_res"].to(act)),
            out[..., :S] + p["b_skip"])


def fixed_block(p: Params, o: torch.Tensor, h_up: torch.Tensor, dil: int,
                dtype, act, tp: bool = False):
    """One fixed residual block, looking back `dil` rows."""
    return residual_block(p, o, lambda x: shift_time(x, dil), h_up, dtype,
                          act, tp)


def adaptive_block(p: Params, o: torch.Tensor, h_up: torch.Tensor,
                   r: torch.Tensor, dtype, act, tp: bool = False):
    """One pitch-adaptive residual block.  r: (B, T) int look-back
    round(d(t) * dilation); the gather index t - r is clipped to [0, T-1]."""
    return residual_block(p, o, lambda x: gather_past(x, r), h_up, dtype,
                          act, tp)


def gather_past(o: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """o[:, t - r] per row, the index clipped to [0, T-1]."""
    B, T, C = o.shape
    t = torch.arange(T, device=o.device)[None, :]
    idx = torch.clamp(t - r, 0, T - 1).long()
    return torch.gather(o, 1, idx[..., None].expand(B, T, C))


def lookback_index(cfg: ModelConfig, d: torch.Tensor, t0: int = 0,
                   total: Optional[int] = None) -> list:
    """Per block, fixed then adaptive, the global row each row of the
    block's input looks back to, (B, T_l) long, and a left-edge mask, for
    a slice of T_l rows at global offset t0 of a `total`-row window
    (default: the slice is the window): a fixed block reads t - dil, zero
    where t < dil (`shift_time`'s fill: the mask); an adaptive block reads
    t - round(d(t) dil) clipped to [0, total - 1] (mask None).  JAX's
    `train/pipeline.py::_lookback_tables`, as indices."""
    B, T_l = d.shape
    total = T_l if total is None else total
    t = t0 + torch.arange(T_l, device=d.device)[None, :].expand(B, T_l)
    out = [((t - dil).clamp(min=0), t >= dil) for dil in cfg.dilationsF]
    out += [(torch.clamp(t - round_look_back(d, dil), 0, total - 1).long(),
             None) for dil in cfg.dilationsA]
    return out


def gather_rows(ext: torch.Tensor, idx: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """ext[:, idx] per row, zero where mask is False: the gather form of
    `shift_time` (with a mask) and `gather_past` (without), equal to them
    bit for bit."""
    B, _, C = ext.shape
    past = torch.gather(ext, 1, idx[..., None].expand(B, idx.shape[1], C))
    return past if mask is None else torch.where(mask[..., None], past, 0)


def lookback_block(p: Params, o: torch.Tensor, h_up: torch.Tensor,
                   idx: torch.Tensor, mask: Optional[torch.Tensor], dtype,
                   act, halo: Optional[torch.Tensor] = None,
                   tp: bool = False):
    """One residual block in gather form (JAX's pipeline `_unified_block`):
    its look-back rows are ext[idx] (`gather_rows`), ext = [halo | o] along
    time (o alone without a halo).  Under tp the halo, like o, is copied
    to the tp group (its gradient summed over the group)."""
    def past_of(oc):
        if halo is None:
            return gather_rows(oc, idx, mask)
        before = halo
        if tp:
            from qpnet_tpu_torch.parallel.distributed import copy_to_tp
            before = copy_to_tp(halo)
        return gather_rows(torch.cat([before, oc], 1), idx, mask)

    return residual_block(p, o, past_of, h_up, dtype, act, tp)


def round_look_back(d: torch.Tensor, dil: int) -> torch.Tensor:
    """round(d * dil), half to even, as an int32 look-back."""
    return torch.round(d.float() * dil).to(torch.int32)


def postprocess(params: Params, skip_sum: torch.Tensor, dtype) -> torch.Tensor:
    u = F.relu(skip_sum)
    u = F.relu(_matmul(u, params["W_post1"], dtype) + params["b_post1"])
    return _matmul(u, params["W_post2"], dtype) + params["b_post2"]


# ---------------------------------------------------------------------------
# teacher-forced forward
# ---------------------------------------------------------------------------

def embed(params: Params, x: torch.Tensor,
          x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal input layer: c[t] = E_cur[x[t]] + E_prev[x[t-1]] + b, with
    x[-1] the (B, 1) `x_prev` of a time slice, or zero fill without it."""
    x = x.long()
    if x_prev is None:
        prev = shift_time(params["embed_prev"][x], 1)
    else:
        prev = params["embed_prev"][torch.cat([x_prev.long(), x[:, :-1]], 1)]
    return params["embed_cur"][x] + prev + params["b_causal"]


def forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
            h: Optional[torch.Tensor], d: torch.Tensor,
            compute_dtype=torch.float32,
            h_up: Optional[torch.Tensor] = None,
            remat: bool = False, fixed_engine: str = "xla",
            maxd_bucket: Optional[int] = None,
            tp: bool = False, sp: bool = False,
            x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced forward over a full window.

    x: (B, T) int mu-law classes (end-aligned, history on the left);
    h: (B, T // upsampling_factor, n_aux) standardized aux, ignored when a
    sample-rate `h_up` (B, T, n_aux) is given; d: (B, T) dilation factors.
    fixed_engine: "xla" runs the block loop below (autograd through plain
    PyTorch); "pallas" runs the residual stack through the fused training
    kernel (ops/train_kernel.py: CUDA on the card, its twin on the CPU),
    whose gradient is the backward kernel.  The names are the JAX
    package's, so `model.conf` and the CLI argv read the same in both.
    remat: recompute each block of the plain engine in the backward
    (torch.utils.checkpoint) instead of keeping its activations.
    maxd_bucket: with "pallas", a bucket >= ceil(max d) also fuses the
    pitch-adaptive layers into the kernel; it needs frame-constant d (the
    training batcher's), read at frame rate as d[:, ::up].
    tp: params is this rank's shard of a tp group (plain engine only): the
    embedding runs on the rank's R/tp channels and is gathered, the aux is
    copied to every rank (its gradient summed over the group), and each
    block is `residual_block`'s tp form.  The post-net is replicated.
    sp: x, h and d are this rank's time slice of an sp group's window
    (plain engine only), x_prev the one sample of x before it (None on the
    slice at global t = 0); every block reads its look-back from the halo
    its predecessors send (`sp_tables`).  Composes with tp.
    Returns (B, T, n_quantize) f32 logits; logits[:, t] predicts x[t+1],
    equal on every rank of a tp group (under sp: the rank's time slice).
    """
    if fixed_engine not in ("xla", "pallas"):
        raise ValueError("fixed_engine should be 'xla' or 'pallas'")
    if sp and fixed_engine == "pallas":
        raise ValueError("forward(sp=True) runs the plain engine only")
    R = cfg.n_resch
    act = _act_dtype(compute_dtype)
    if h_up is None:
        h_up = upsample_aux(params, h, cfg.upsampling_factor)
    h_up = h_up.to(act)
    o = embed(params, x, x_prev if sp else None)
    if tp:
        from qpnet_tpu_torch.parallel.distributed import (copy_to_tp,
                                                          gather_from_tp)
        h_up, o = copy_to_tp(h_up), gather_from_tp(o)
    o = o.to(act)
    skip_sum = torch.zeros(o.shape[:2] + (cfg.n_skipch,),
                           dtype=torch.float32, device=o.device)
    if remat:
        def fblock(*args):
            return checkpoint(fixed_block, *args, use_reentrant=False)

        def ablock(*args):
            return checkpoint(adaptive_block, *args, use_reentrant=False)
    else:
        fblock, ablock = fixed_block, adaptive_block
    if fixed_engine == "pallas":
        from qpnet_tpu_torch.ops import train_kernel as TK
        up = cfg.upsampling_factor
        fuse = maxd_bucket is not None and len(cfg.dilationsA) > 0
        layers = list(params["fixed"]) + (
            list(params["adaptive"]) if fuse else [])
        W = TK.stack_weights(layers, cfg.n_aux)
        h_pad = F.pad(h_up, (0, TK.AUX_PAD - cfg.n_aux))
        if fuse:
            d_frames = d[:, ::up].detach().float().contiguous()
            static = (tuple(cfg.dilationsF), tuple(cfg.dilationsA),
                      int(maxd_bucket), up, R, cfg.n_skipch)
        else:
            d_frames = None
            static = (tuple(cfg.dilationsF), (), 1, up, R, cfg.n_skipch)
        o, skip = TK.fixed_stack_fused(static, compute_dtype, W, o, h_pad,
                                       d_frames)
        skip_sum = skip_sum + skip + sum(p["b_skip"] for p in layers)
        adaptive_rest = [] if fuse else \
            list(zip(params["adaptive"], cfg.dilationsA))
    elif sp:
        from qpnet_tpu_torch.parallel.distributed import sp_halo
        block = lookback_block
        if remat:
            def block(*args):
                return checkpoint(lookback_block, *args, use_reentrant=False)
        for p, (idx, mask), H in zip(
                list(params["fixed"]) + list(params["adaptive"]),
                *sp_tables(cfg, d)):
            # the exchange runs outside the recomputed region: a collective
            # inside it would run again in the backward
            halo = sp_halo(o, H)
            o, skip = block(p, o, h_up, idx, mask, compute_dtype, act, halo,
                            tp)
            skip_sum = skip_sum + skip
        adaptive_rest = []
    else:
        for p, dil in zip(params["fixed"], cfg.dilationsF):
            o, skip = fblock(p, o, h_up, dil, compute_dtype, act, tp)
            skip_sum = skip_sum + skip
        adaptive_rest = list(zip(params["adaptive"], cfg.dilationsA))
    for p, dil in adaptive_rest:
        o, skip = ablock(p, o, h_up, round_look_back(d, dil), compute_dtype,
                         act, tp)
        skip_sum = skip_sum + skip
    return postprocess(params, skip_sum, compute_dtype)


def sp_tables(cfg: ModelConfig, d: torch.Tensor):
    """Per block of the sp forward, fixed then adaptive: (its look-back
    index into [halo | o] and mask, as `lookback_index` gives them for
    this rank's slice), and its halo length H, agreed over the sp group.
    A rank's reach is the rows before its slice that its look-backs read:
    min(dil, t0) for a fixed block, t0 - min(index) for an adaptive one
    (bounded by maxd * dil, not dil); H is the group's largest, in one
    small all-gather for every block."""
    from qpnet_tpu_torch.parallel.distributed import sp_max, sp_position
    B, T_l = d.shape
    k, sp = sp_position()
    t0 = k * T_l
    look = lookback_index(cfg, d, t0, sp * T_l)
    nF = len(cfg.dilationsF)
    t = t0 + torch.arange(T_l, device=d.device)
    adaptive = [torch.stack([t0 - idx.min(), (idx - t).max()])
                for idx, _ in look[nF:]]
    got = torch.stack(adaptive).cpu().numpy() if adaptive else \
        np.zeros((0, 2), np.int64)
    if (got[:, 1] > 0).any():
        raise ValueError("sequence parallelism needs look-backs >= 0 "
                         "(dilation factors d > 0)")
    reach = [min(dil, t0) for dil in cfg.dilationsF] + \
        [max(int(v), 0) for v in got[:, 0]]
    Hs = [int(v) for v in sp_max(reach)]
    return ([(idx - (t0 - H), mask) for (idx, mask), H in zip(look, Hs)],
            Hs)
