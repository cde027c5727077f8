"""The fused residual stack of the training step (K2): forward and backward
kernels, their plain PyTorch twins, and the autograd function around them.

`fixed_stack_fused` computes what the JAX package's
`qpnet_tpu/ops/train_kernel.py::fixed_stack_fused` computes: the residual
stack of the teacher-forced forward from the causal layer's output `o0` to
the last block's output and the skip sum (without the `b_skip` terms), for
the fixed layers alone (`dilsA=()`) or followed by the pitch-adaptive
layers (`dilsA` set, with frame-constant look-backs bounded by the `maxd`
bucket).  Its gradient is the backward kernel, not autograd through the
forward.

On CUDA tensors `stack_forward` and `stack_backward` launch the kernels of
`csrc/train_kernel.cu` (see the note there for the design and the bound);
on CPU tensors they run `fixed_stack_reference_fwd` and
`fixed_stack_reference_bwd`, the plain twins, which follow the TPU
kernel's arithmetic and bf16 storage points: z in f32; st and o' stored in
the act type; g = (s * t) rounded from f32; in the backward g rebuilt from
the stored s and t, [dskip | do] rounded to the compute type, and the gate
derivative chain run at the compute type's precision.  The backward twin
is written out from the TPU kernel's math, not taken from autograd.  The
twins' products take operands rounded to the compute type and sum in f32
through `torch.matmul`.  The kernels' tensor cores sum in an order no
plain code repeats, so the checks on the card also run the twins with
`f64_sums=True` (every product and bias-gradient sum in float64, rounded
once to f32, at the same storage points) and hold both the bf16 kernel
and the f32-summing twin to that.  Nothing else selects between kernel
and twin.

Inputs (as in the JAX package): o0 (B, T, R) and h_up (B, T, AUX_PAD) in
the act type (= the compute type), d_frames (B, ceil(T/up)) f32 frame-rate
dilation factors (None without adaptive layers), and the weights
{"W_in": (L, 2R, 2R), "W_aux": (L, AUX_PAD, 2R), "b_gate": (L, 2R),
"W_out": (L, R, S+R), "b_res": (L, R)}, f32 masters, fixed layers first.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from qpnet_tpu_torch.utils import profiler

AUX_PAD = 48

# kernel launches made through `stack_forward` / `stack_backward` (one per
# call on CUDA tensors) are the registry's counters k2.fwd and k2.bwd;
# `fwd_launch_count` and `bwd_launch_count` read them
_COUNTERS = {"fwd_launch_count": "k2.fwd", "bwd_launch_count": "k2.bwd"}

# the backward's weight gradients sum over all B*T rows in this many row
# ranges, whose partial sums are added in order (deterministic): 11 ranges
# make the 24 output tiles of dW_out (R x (S+R) in 128 x 128 tiles at the
# default widths) 264 blocks and the 72 of [dW_in; dW_aux] 792, two and six
# per SM of the card's 132
BWD_SPLITS = 11

# the gate's weight columns as the forward kernel reads them: tile p of
# 2 * GATE_HALF columns holds columns [p, p + 1) * GATE_HALF of the s half
# next to the same columns of the t half
GATE_HALF = 64


def __getattr__(name: str):
    if name in _COUNTERS:
        return profiler.counters().get(_COUNTERS[name], 0)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launch_counts() -> None:
    profiler.reset_counters("k2.")


def _unpack(static):
    dilsF, dilsA, maxd, up, R, S = static
    return tuple(dilsF), tuple(dilsA), int(maxd), int(up), int(R), int(S)


def look_back_rows(d_frames: torch.Tensor, T: int, up: int, dil: int,
                   maxd: int) -> torch.Tensor:
    """(B, T) int64: the row position t's adaptive layer reads,
    max(t - r, 0) with r = clip(round(d_f * dil), 0, maxd * dil) of frame
    f = t // up (round half to even)."""
    r = torch.round(d_frames.float() * dil).clamp(0, maxd * dil).long()
    r = torch.repeat_interleave(r, up, dim=1)[:, :T]
    t = torch.arange(T, device=d_frames.device)[None, :]
    return (t - r).clamp(min=0)


def _past(o: torch.Tensor, dil: int, rows: Optional[torch.Tensor]):
    """Layer input at the look-back: o[t - dil] with zero fill (fixed), or
    o[rows] (adaptive)."""
    if rows is None:
        out = torch.zeros_like(o)
        out[:, dil:] = o[:, : o.shape[1] - dil]
        return out
    return torch.gather(o, 1, rows[..., None].expand_as(o))


def _mm(a, w, dtype, f64_sums=False):
    """a (..., K) @ w (K, N) with both operands rounded to `dtype`, summed
    in f32 by torch.matmul, or with f64_sums in float64 and rounded once
    to f32."""
    a, w = a.to(dtype), w.to(dtype)
    if f64_sums:
        return (a.double() @ w.double()).float()
    return a.float() @ w.float()


def _mm_tn(a, b, dtype, f64_sums=False):
    """a^T @ b summed over every row of (B, T, K) and (B, T, N), as _mm."""
    return _mm(a.reshape(-1, a.shape[-1]).T, b.reshape(-1, b.shape[-1]),
               dtype, f64_sums)


def _colsum(x, f64_sums=False):
    """Sum over every row of (B, T, N), in f32 (float64 with f64_sums)."""
    x = x.reshape(-1, x.shape[-1])
    return (x.double() if f64_sums else x.float()).sum(0).float()


def _gather_back(dprev, rows):
    """Transpose of the adaptive gather: row p receives the gradient of
    every t with rows[t] == p (rows below 0 read row 0, so row 0 also takes
    theirs), added in order of t, as the kernel adds them."""
    B, T, _ = dprev.shape
    back = torch.zeros_like(dprev)
    t = torch.arange(T, device=rows.device)
    for b in range(B):
        order = torch.argsort(rows[b] * T + t)        # by target, then t
        tgt = rows[b][order]
        first = torch.searchsorted(tgt, tgt, right=False)
        rank = torch.arange(T, device=rows.device) - first
        for r in range(int(rank.max()) + 1):
            sel = rank == r
            dst, src = tgt[sel], order[sel]
            back[b, dst] = back[b, dst] + dprev[b, src]
    return back


def _layer_rows(static, d_frames, T):
    dilsF, dilsA, maxd, up, _, _ = _unpack(static)
    return ([None] * len(dilsF)
            + [look_back_rows(d_frames, T, up, dil, maxd) for dil in dilsA])


def fixed_stack_reference_fwd(static, dtype, weights: Dict[str, torch.Tensor],
                              o0: torch.Tensor, h_up: torch.Tensor,
                              d_frames: Optional[torch.Tensor],
                              f64_sums: bool = False):
    """Plain forward: (o_out (B,T,R) act, skip (B,T,S) f32, oall (L,B,T,R)
    act, st (L,B,T,2R) act).  f64_sums: the products sum in float64."""
    dilsF, dilsA, _, _, R, S = _unpack(static)
    B, T, _ = o0.shape
    act = dtype
    rows = _layer_rows(static, d_frames, T)
    o = o0.to(act)
    skip = torch.zeros((B, T, S), dtype=torch.float32, device=o0.device)
    oall, st = [], []
    for l, dil in enumerate(dilsF + dilsA):
        oall.append(o)
        xin = torch.cat([o, _past(o, dil, rows[l]), h_up], -1)
        W = torch.cat([weights["W_in"][l], weights["W_aux"][l]], 0)
        z = _mm(xin, W, dtype, f64_sums) + weights["b_gate"][l].float()
        s = torch.reciprocal(1.0 + torch.exp(-z[..., :R]))
        t = torch.tanh(z[..., R:])
        st.append(torch.cat([s, t], -1).to(act))
        g = (s * t).to(dtype)
        out = _mm(g, weights["W_out"][l], dtype, f64_sums)
        o = (o.float() + out[..., S:] + weights["b_res"][l].float()).to(act)
        skip = skip + out[..., :S]
    return o, skip, torch.stack(oall), torch.stack(st)


def fixed_stack_reference_bwd(static, dtype, weights: Dict[str, torch.Tensor],
                              oall: torch.Tensor, st: torch.Tensor,
                              h_up: torch.Tensor,
                              d_frames: Optional[torch.Tensor],
                              do: torch.Tensor, dskip: torch.Tensor,
                              f64_sums: bool = False):
    """Plain backward of the stack, from the TPU kernel's math: returns
    (do0 (B,T,R) f32, dh (B,T,AUX_PAD) f32, {"W_in", "W_aux", "b_gate",
    "W_out", "b_res"} f32 gradients).  f64_sums: the products and the bias
    gradients sum in float64."""
    dilsF, dilsA, _, _, R, S = _unpack(static)
    dils = dilsF + dilsA
    L = len(dils)
    B, T, _ = do.shape
    rows = _layer_rows(static, d_frames, T)
    do = do.float()
    dskip = dskip.float()
    dh = torch.zeros((B, T, AUX_PAD), dtype=torch.float32, device=do.device)
    grads = {k: [None] * L for k in ("W_in", "W_aux", "b_gate", "W_out",
                                      "b_res")}
    for i in range(L - 1, -1, -1):
        o = oall[i]
        s, t = st[i][..., :R], st[i][..., R:]
        grads["b_res"][i] = _colsum(do, f64_sums)
        dout = torch.cat([dskip, do], -1)
        g = (s * t).to(dtype)
        grads["W_out"][i] = _mm_tn(g, dout, dtype, f64_sums)
        dg = _mm(dout, weights["W_out"][i].T, dtype, f64_sums)
        # the gate derivative at the compute type's precision
        dgc, sc, tc = dg.to(dtype), s.to(dtype), t.to(dtype)
        u = dgc * sc
        dzc = torch.cat([dgc * tc * sc * (1 - sc), u - u * tc * tc], -1)
        grads["b_gate"][i] = _colsum(dzc, f64_sums)
        W = torch.cat([weights["W_in"][i], weights["W_aux"][i]], 0)
        dx = _mm(dzc, W.T, dtype, f64_sums)           # (B, T, 2R + AUX_PAD)
        xin = torch.cat([o, _past(o, dils[i], rows[i]), h_up], -1)
        dW = _mm_tn(xin, dzc, dtype, f64_sums)
        grads["W_in"][i], grads["W_aux"][i] = dW[: 2 * R], dW[2 * R:]
        dprev = dx[..., R: 2 * R]
        if rows[i] is None:
            # transpose of the shift: row t's gradient lands on t - dil
            back = torch.zeros_like(dprev)
            back[:, : T - dils[i]] = dprev[:, dils[i]:]
        else:
            back = _gather_back(dprev, rows[i])
        do = (do + dx[..., :R]) + back
        dh = dh + dx[..., 2 * R:]
    return do, dh, {k: torch.stack(v) for k, v in grads.items()}


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGTYPES = [_P] * 13 + [_I] * 11 + [_P]
_BWD_ARGTYPES = [_P] * 21 + [_I] * 12 + [_P]


def _lib():
    from qpnet_tpu_torch.ops import _build
    lib = _build.load("train_kernel")
    lib.qp_train_fwd.argtypes = _FWD_ARGTYPES
    lib.qp_train_fwd.restype = ctypes.c_int
    lib.qp_train_bwd.argtypes = _BWD_ARGTYPES
    lib.qp_train_bwd.restype = ctypes.c_int
    lib.qp_train_part_floats.argtypes = [_I] * 6
    lib.qp_train_part_floats.restype = ctypes.c_longlong
    return lib


def build() -> None:
    """Compile and load the CUDA library now (otherwise at first launch)."""
    _lib()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def interleave_gate_columns(W: torch.Tensor, R: int) -> torch.Tensor:
    """(..., 2R) gate weights [s | t] -> the forward kernel's column order:
    tile p of 2 * GATE_HALF columns is s[:, p * GATE_HALF:(p + 1) *
    GATE_HALF] then t[:, the same]."""
    lead = W.shape[:-1]
    return W.reshape(*lead, 2, R // GATE_HALF, GATE_HALF).transpose(
        -3, -2).reshape(*lead, 2 * R)


def forward_weights(weights: Dict[str, torch.Tensor], dtype,
                    R: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's weights in the compute type, each layer's
    depth contiguous: (W_gate_t (L, 2R, 2R + AUX_PAD), the transpose of
    [W_in; W_aux] with its columns interleaved; W_out_t (L, S + R, R), the
    transpose of W_out)."""
    W_cat = torch.cat([weights["W_in"], weights["W_aux"]], 1).to(dtype)
    return (interleave_gate_columns(W_cat, R).transpose(1, 2).contiguous(),
            weights["W_out"].to(dtype).transpose(1, 2).contiguous())


def _check(static, dtype, o0, h_up, d_frames, weights):
    dilsF, dilsA, maxd, up, R, S = _unpack(static)
    L = len(dilsF) + len(dilsA)
    B, T = o0.shape[:2]
    dev = o0.device
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute dtype should be float32 or bfloat16")
    if R % GATE_HALF or S % 8:
        raise ValueError(f"the CUDA kernel needs n_resch a multiple of "
                         f"{GATE_HALF} and n_skipch a multiple of 8")
    expect = {"o0": (o0, (B, T, R), dtype), "h_up": (h_up, (B, T, AUX_PAD),
                                                     dtype)}
    if dilsA:
        if d_frames is None:
            raise ValueError("adaptive layers need d_frames")
        expect["d_frames"] = (d_frames, (B, -(-T // up)), torch.float32)
    for k, shape in (("W_in", (L, 2 * R, 2 * R)),
                     ("W_aux", (L, AUX_PAD, 2 * R)), ("b_gate", (L, 2 * R)),
                     ("W_out", (L, R, S + R)), ("b_res", (L, R))):
        expect[k] = (weights[k], shape, weights[k].dtype)
    for name, (t, shape, dt) in expect.items():
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")
        if name == "d_frames":
            if t.shape[0] != B or t.shape[1] < shape[1] or t.dtype != dt:
                raise ValueError(f"d_frames: expected ({B}, >={shape[1]}) "
                                 f"{dt}, got {tuple(t.shape)} {t.dtype}")
        elif tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: expected {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _geometry(static, B, T, d_frames):
    dilsF, dilsA, maxd, up, R, S = _unpack(static)
    dils = (ctypes.c_int * max(1, len(dilsF) + len(dilsA)))(*(dilsF + dilsA))
    F = d_frames.shape[1] if d_frames is not None else -(-T // up)
    return dils, [len(dilsF), len(dilsA), maxd, up, B, T, F, R, S, AUX_PAD]


def _launch_fwd(static, dtype, weights, o0, h_up, d_frames):
    _check(static, dtype, o0, h_up, d_frames, weights)
    dilsF, dilsA, _, _, R, S = _unpack(static)
    L = len(dilsF) + len(dilsA)
    B, T = o0.shape[:2]
    dev = o0.device
    W_gate_t, W_out_t = forward_weights(weights, dtype, R)
    b_gate = weights["b_gate"].float().contiguous()
    b_res = weights["b_res"].float().contiguous()
    o0, h_up = o0.contiguous(), h_up.contiguous()
    d = d_frames.float().contiguous() if dilsA else None
    oall = torch.empty((L, B, T, R), dtype=dtype, device=dev)
    st = torch.empty((L, B, T, 2 * R), dtype=dtype, device=dev)
    o_out = torch.empty((B, T, R), dtype=dtype, device=dev)
    skip = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    g = torch.empty((B * T, R), dtype=dtype, device=dev)
    dils, geo = _geometry(static, B, T, d)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qp_train_fwd(
            *map(_ptr, (o0, h_up, d, W_gate_t, b_gate, W_out_t, b_res, oall,
                        st, o_out, skip, g)),
            ctypes.cast(dils, ctypes.c_void_p), *geo,
            int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"train_kernel forward failed: CUDA error {err}")
    profiler.count("k2.fwd")
    return o_out, skip, oall, st


def _launch_bwd(static, dtype, weights, oall, st, h_up, d_frames, do, dskip):
    dilsF, dilsA, _, _, R, S = _unpack(static)
    L = len(dilsF) + len(dilsA)
    B, T = do.shape[:2]
    dev = do.device
    _check(static, dtype, oall[0], h_up, d_frames, weights)
    for name, t, shape, dt in (("oall", oall, (L, B, T, R), dtype),
                               ("st", st, (L, B, T, 2 * R), dtype),
                               ("do", do, (B, T, R), torch.float32),
                               ("dskip", dskip, (B, T, S), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: expected {shape} {dt} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    W_cat = torch.cat([weights["W_in"], weights["W_aux"]], 1).to(
        dtype).contiguous()
    W_out = weights["W_out"].to(dtype).contiguous()
    oall, st, h_up = oall.contiguous(), st.contiguous(), h_up.contiguous()
    do, dskip = do.contiguous(), dskip.contiguous()
    d = d_frames.float().contiguous() if dilsA else None
    K1 = 2 * R + AUX_PAD
    f32 = dict(dtype=torch.float32, device=dev)
    dwork = torch.empty((B, T, R), **f32)
    dh = torch.empty((B, T, AUX_PAD), **f32)
    dW_cat = torch.empty((L, K1, 2 * R), **f32)
    db_gate = torch.empty((L, 2 * R), **f32)
    dW_out = torch.empty((L, R, S + R), **f32)
    db_res = torch.empty((L, R), **f32)
    dz = torch.empty((B * T, 2 * R), dtype=dtype, device=dev)
    dx = torch.empty((B * T, K1), **f32)
    g = torch.empty((B * T, R), dtype=dtype, device=dev)
    # bf16 copies of do (per layer) and dskip (once); f32 reads the inputs
    bf = dtype == torch.bfloat16
    do_c = torch.empty((B * T, R), dtype=dtype, device=dev) if bf else None
    dskip_c = torch.empty((B * T, S), dtype=dtype, device=dev) if bf else None
    lib = _lib()
    part = torch.empty((int(lib.qp_train_part_floats(
        B, T, R, S, AUX_PAD, BWD_SPLITS)),), **f32)
    dils, geo = _geometry(static, B, T, d)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qp_train_bwd(
            *map(_ptr, (do, dskip, oall, st, h_up, d, W_cat, W_out, dwork, dh,
                        dW_cat, db_gate, dW_out, db_res, dz, dx, part, g, do_c,
                        dskip_c)),
            ctypes.cast(dils, ctypes.c_void_p), *geo, int(bf), BWD_SPLITS,
            stream)
    if err != 0:
        raise RuntimeError(f"train_kernel backward failed: CUDA error {err}")
    profiler.count("k2.bwd")
    return dwork, dh, {"W_in": dW_cat[:, : 2 * R], "W_aux": dW_cat[:, 2 * R:],
                       "b_gate": db_gate, "W_out": dW_out, "b_res": db_res}


def stack_forward(static, dtype, weights, o0, h_up, d_frames):
    """The forward kernel on CUDA tensors, its twin on CPU tensors:
    (o_out, skip, oall, st)."""
    if o0.device.type == "cpu":
        return fixed_stack_reference_fwd(static, dtype, weights, o0, h_up,
                                         d_frames)
    if o0.device.type != "cuda":
        raise ValueError(f"the training kernel runs on CUDA or CPU tensors, "
                         f"got {o0.device}")
    return _launch_fwd(static, dtype, weights, o0, h_up, d_frames)


def stack_backward(static, dtype, weights, oall, st, h_up, d_frames, do,
                   dskip):
    """The backward kernel on CUDA tensors, its twin on CPU tensors:
    (do0, dh, weight gradients), all f32."""
    if do.device.type == "cpu":
        return fixed_stack_reference_bwd(static, dtype, weights, oall, st,
                                         h_up, d_frames, do, dskip)
    if do.device.type != "cuda":
        raise ValueError(f"the training kernel runs on CUDA or CPU tensors, "
                         f"got {do.device}")
    return _launch_bwd(static, dtype, weights, oall, st, h_up, d_frames, do,
                       dskip)


_WEIGHT_KEYS = ("W_in", "W_aux", "b_gate", "W_out", "b_res")


class FixedStackFused(torch.autograd.Function):
    """(o_out, skip) = stack(o0, h_up[, d_frames]); the backward is the
    backward kernel.  d_frames gets no gradient; the gradient to o0 comes
    back in o0's type and the one to h_up in h_up's type."""

    @staticmethod
    def forward(ctx, static, dtype, o0, h_up, d_frames, *ws):
        weights = dict(zip(_WEIGHT_KEYS, ws))
        o_out, skip, oall, st = stack_forward(static, dtype, weights, o0,
                                              h_up, d_frames)
        ctx.save_for_backward(oall, st, h_up, d_frames, *ws)
        ctx.static, ctx.dtype = static, dtype
        return o_out, skip

    @staticmethod
    def backward(ctx, do_out, dskip):
        oall, st, h_up, d_frames, *ws = ctx.saved_tensors
        weights = dict(zip(_WEIGHT_KEYS, ws))
        B, T = h_up.shape[:2]
        S = ctx.static[5]
        if do_out is None:
            do_out = torch.zeros(oall.shape[1:], dtype=torch.float32,
                                 device=oall.device)
        if dskip is None:
            dskip = torch.zeros((B, T, S), dtype=torch.float32,
                                device=oall.device)
        do0, dh, dW = stack_backward(ctx.static, ctx.dtype, weights, oall, st,
                                     h_up, d_frames, do_out.float(),
                                     dskip.float())
        return (None, None, do0.to(oall.dtype), dh.to(h_up.dtype), None,
                *(dW[k] for k in _WEIGHT_KEYS))


def fixed_stack_fused(static: Tuple, dtype, weights: Dict[str, torch.Tensor],
                      o0: torch.Tensor, h_up: torch.Tensor,
                      d_frames: Optional[torch.Tensor]):
    """Fused residual stack with the kernels' gradient: (o_out (B,T,R) act,
    skip (B,T,S) f32 without the b_skip terms).

    static: (dilsF, dilsA, maxd, up, R, S); dilsA=() runs the fixed layers
    only.  dtype: the compute (and act) type, torch.float32 or bfloat16.
    """
    return FixedStackFused.apply(static, dtype, o0, h_up, d_frames,
                                 *(weights[k] for k in _WEIGHT_KEYS))


def stack_weights(layers: Sequence[dict], n_aux: int) -> Dict[str, torch.Tensor]:
    """The kernel's stacked weights from per-block parameters (autograd
    flows back through the stacking): W_in = [W_cur; W_prev], W_aux padded
    to AUX_PAD rows, W_out = [W_skip | W_res]."""
    pad = AUX_PAD - n_aux
    return {
        "W_in": torch.stack([torch.cat([p["W_cur"], p["W_prev"]], 0)
                             for p in layers]),
        "W_aux": torch.stack([torch.nn.functional.pad(p["W_aux"],
                                                      (0, 0, 0, pad))
                              for p in layers]),
        "b_gate": torch.stack([p["b_gate"] for p in layers]),
        "W_out": torch.stack([torch.cat([p["W_skip"], p["W_res"]], 1)
                              for p in layers]),
        "b_res": torch.stack([p["b_res"] for p in layers]),
    }
