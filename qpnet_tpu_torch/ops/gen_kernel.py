"""The autoregressive generation kernel (K1) and its plain PyTorch twin.

`generate` runs a chunk of whole frames of generation steps and returns the
samples (or, in forced mode, the logits) together with the carried ring and
x state, with the interface and state layout of the JAX package's
`qpnet_tpu/ops/gen_kernel.py::pallas_generate`.  On CUDA tensors it launches
the hand-written kernel of `csrc/gen_kernel.cu` (see the note there for its
design and bound); on CPU tensors it runs `generate_reference`, a per-step
loop in plain PyTorch with the kernel's arithmetic (its bf16 products
summed in another order) and the same bf16 storage points.  Nothing else
selects between the two.

quantize="w8a8" is the JAX kernel's other branch (`mmq`): W_in and W_out
are int8 with a scale per layer and output column (`pack_weights`), and
each product quantizes its activation rows on the fly with a per-row scale.

State layout (as in the JAX kernel):
  bufF (sum(dilsF), B, R) bf16: fixed rings flat-packed per layer; a layer
       reads and then overwrites slot t_abs % dil.
  bufA (sum(maxd*dilsA + 1), B, R) bf16: adaptive rings; a layer writes
       slot t_abs % size, then reads (t_abs - r_b) mod size with
       r_b = clip(round(d_b * dil), 0, size - 1), round half to even.
  x (2, B) int32: [x_prev, x_cur].
Time counts from 0 at the first generated sample (the priming origin
t0 = 0); `step_offset` is a chunk's absolute first step, `b_offset` the
global index of its first row, and the sampling hash keys off both, so a
chunked or batch-split run gives the same bits as one call.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import numpy as np
import torch

from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.utils import profiler

AUX_PAD = 48   # aux depth of the packed W_aux and of h_frames (zero-padded)
MODES = {"argmax": 0, "sampling": 1, "forced": 2}
QUANTIZE = {"none": 0, "w8a8": 1}

# kernel launches made through `generate` (one per call on a CUDA tensor),
# bf16 and w8a8 apart, are the registry's counters k1.launch.bf16 and
# k1.launch.w8a8; `launch_count` and `w8a8_launch_count` read them
_COUNTERS = {"launch_count": "k1.launch.bf16",
             "w8a8_launch_count": "k1.launch.w8a8"}


def __getattr__(name: str):
    if name in _COUNTERS:
        return profiler.counters().get(_COUNTERS[name], 0)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launch_count() -> None:
    profiler.reset_counters("k1.launch.")


def _q8(w: torch.Tensor):
    """JAX's q8: w (L, K, N) f32 -> (int8 (L, K, N), f32 scales (L, 1, N))
    with sc = max(max_k |w|, 1e-12) / 127 and qw = clip(rint(w / sc)).
    Both divisions are elementwise between tensors: a division by a Python
    scalar may run as a multiply by its reciprocal on the card."""
    amax = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    sc = amax / torch.full_like(amax, 127.0)
    qw = torch.round(w / sc).clamp(-127, 127).to(torch.int8)
    return qw, sc


def pack_weights(params: Dict[str, Any], cfg: ModelConfig,
                 quantize: str = "none") -> Dict[str, Any]:
    """Fuse, pad and cast the parameters into the kernel's layout, on the
    parameters' device.  Products are stored output-major ("_t": row n is
    output column n's contiguous depth), which is the row-major layout of
    the kernel's mma operand A (16 output columns by 16 or 32 of depth):
      W_in_t (L, 2R, 2R) = [W_cur; W_prev]^T, W_out_t (L, S+R, R) =
      [W_skip | W_res]^T, W_post1_t (S, S), W_post2_t (Q, S), all bf16;
      W_aux (L, AUX_PAD, 2R) bf16 (depth-major: one thread per column);
      E_cat (Q, 2R) bf16 = [E_cur | E_prev]; c_all (L, 2R) f32 = b_gate +
      up_b * sum_k W_aux[k]; b_res (L, R), b_skip_sum (1, S), up_w (128,),
      b_causal (1, R), b_post1 (1, S), b_post2 (1, Q) f32.
    quantize="w8a8" stores W_in_q_t (L, 2R, 2R) and W_out_q_t (L, S+R, R)
    int8 in place of W_in_t and W_out_t, quantized from the f32 params as
    the JAX package's q8 does, with their f32 column scales s_in (L, 2R)
    and s_out (L, S+R).
    """
    if quantize not in QUANTIZE:
        raise ValueError(f"unknown quantize {quantize!r}")
    A = cfg.n_aux
    bf16, f32 = torch.bfloat16, torch.float32
    layers = list(params["fixed"]) + list(params["adaptive"])
    W_in = torch.stack([torch.cat([p["W_cur"], p["W_prev"]], 0)
                        for p in layers]).to(f32)
    W_out = torch.stack([torch.cat([p["W_skip"], p["W_res"]], 1)
                         for p in layers]).to(f32)
    if quantize == "w8a8":
        (qi, si), (qo, so) = _q8(W_in), _q8(W_out)
        products = {"W_in_q_t": qi.transpose(1, 2).contiguous(),
                    "W_out_q_t": qo.transpose(1, 2).contiguous(),
                    "s_in": si[:, 0].contiguous(),
                    "s_out": so[:, 0].contiguous()}
    else:
        products = {"W_in_t": W_in.to(bf16).transpose(1, 2).contiguous(),
                    "W_out_t": W_out.to(bf16).transpose(1, 2).contiguous()}
    W_aux = torch.stack([torch.nn.functional.pad(p["W_aux"].to(f32),
                                                 (0, 0, 0, AUX_PAD - A))
                         for p in layers])
    up_b = params["up_b"].to(f32)
    c_all = torch.stack([p["b_gate"].to(f32)
                         + up_b * p["W_aux"].to(f32).sum(0) for p in layers])
    up_len = max(128, -(-cfg.upsampling_factor // 8) * 8)
    up_w = torch.zeros(up_len, dtype=f32, device=up_b.device)
    up_w[: cfg.upsampling_factor] = params["up_w"].to(f32)
    return {
        **products,
        "W_aux": W_aux.to(bf16).contiguous(),
        "c_all": c_all.contiguous(),
        "b_res": torch.stack([p["b_res"].to(f32) for p in layers]),
        "b_skip_sum": sum(p["b_skip"].to(f32) for p in layers)[None, :],
        "up_w": up_w,
        "E_cat": torch.cat([params["embed_cur"].to(bf16),
                            params["embed_prev"].to(bf16)], 1).contiguous(),
        "b_causal": params["b_causal"].to(f32)[None, :],
        "W_post1_t": params["W_post1"].to(bf16).t().contiguous(),
        "W_post2_t": params["W_post2"].to(bf16).t().contiguous(),
        "b_post1": params["b_post1"].to(f32)[None, :],
        "b_post2": params["b_post2"].to(f32)[None, :],
    }


# ---------------------------------------------------------------------------
# sampling hash (uint32 arithmetic held in int64 tensors)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v * c) mod 2**32 for 0 <= v < 2**32, with no int64 overflow: the
    constant is split into 16-bit halves."""
    lo = (v * (c & 0xFFFF)) & _M32
    hi = ((v * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_bits(seed: int, t_abs, idx) -> torch.Tensor:
    """The kernel's 32-bit counter hash of (seed, absolute step, idx),
    broadcast over the tensor arguments, where idx = global_row * Q + class.
    Returns the uint32 values held in int64."""
    t_abs = torch.as_tensor(t_abs, dtype=torch.int64) & _M32
    base = _mul32(torch.as_tensor(int(seed) & _M32, dtype=torch.int64),
                  0x85EBCA6B) ^ _mul32(t_abs, 2654435761)
    idx = torch.as_tensor(idx, dtype=torch.int64) & _M32
    v = (base + _mul32(idx, 0x9E3779B9)) & _M32
    v = v ^ (v >> 16)
    v = _mul32(v, 0x7FEB352D)
    v = v ^ (v >> 15)
    v = _mul32(v, 0x846CA68B)
    return v ^ (v >> 16)


def gumbel_noise(seed: int, t_abs: int, b_offset: int, B: int, Q: int,
                 device) -> torch.Tensor:
    """(B, Q) f32 Gumbel noise of step t_abs: -log(-log(u)) with
    u = (bits >> 8) * 2**-24 + 1e-12."""
    rows = (torch.arange(B, dtype=torch.int64, device=device) + b_offset) * Q
    q = torch.arange(Q, dtype=torch.int64, device=device)
    v = hash_bits(seed, torch.tensor(t_abs, device=device),
                  rows[:, None] + q[None, :])
    unif = (v >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-12
    return -torch.log(-torch.log(unif))


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

_WARP, _VEC = 32, 8


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, K) @ w (N, K)^T in f32, in a fixed order that is the same on
    every device: lane l of 32 accumulates depth k = (a * 32 + l) * 8 + i
    for a = 0, 1, ... and i = 0..7, one rounded multiply and one rounded add
    at a time, and the 32 lane sums are added by halves."""
    B, K = x.shape
    N = w.shape[0]
    per = _WARP * _VEC
    n_it = -(-K // per)
    pad = n_it * per - K
    if pad:  # zero depth adds +-0, which leaves every sum unchanged
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
    xr = x.reshape(B, 1, n_it, _WARP, _VEC)
    wr = w.reshape(1, N, n_it, _WARP, _VEC)
    acc = x.new_zeros((B, N, _WARP))
    for a in range(n_it):
        for i in range(_VEC):
            acc = acc + xr[:, :, a, :, i] * wr[:, :, a, :, i]
    half = _WARP // 2
    while half:
        acc = acc[..., :half] + acc[..., half:2 * half]
        half //= 2
    return acc[..., 0]


def _aux_projections(h_f: torch.Tensor, W_aux: torch.Tensor) -> torch.Tensor:
    """(L, B, 2R) = h_f (B, AUX_PAD) @ W_aux[l], summed over the depth in
    order as the kernel's one-thread-per-column loop does."""
    acc = h_f.new_zeros((W_aux.shape[0], h_f.shape[0], W_aux.shape[2]))
    for k in range(W_aux.shape[1]):
        acc = acc + h_f[None, :, k, None] * W_aux[:, None, k, :]
    return acc

def _mmq(a: torch.Tensor, wq_t: torch.Tensor, sc: torch.Tensor
         ) -> torch.Tensor:
    """JAX's w8a8 product `mmq`: a (B, K) f32 quantized per row with
    amax = max(max_k |a|, 1e-6) and aq = clip(rint(a * (127 / amax))), times
    wq_t (N, K) int8 values held in f32, rescaled as
    float(aq @ wq) * (amax * (1/127)) * sc.  Every partial sum is an integer
    below 2^24 (|aq|, |wq| <= 127, K <= 1024), so the f32 product is exact
    in any summation order."""
    amax = a.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    aq = torch.round(a * (torch.full_like(amax, 127.0) / amax)).clamp(-127,
                                                                       127)
    return aq @ wq_t.T * (amax * (1.0 / 127.0)) * sc


def _check_args(packed, cfg, bufF0, bufA0, x0, h_frames, d_frames, B, maxd,
                n_steps, mode, step_offset, x_forced, quantize):
    if mode not in MODES:
        raise ValueError("mode should be sampling, argmax or forced")
    if quantize not in QUANTIZE:
        raise ValueError(f"unknown quantize {quantize!r}")
    need = "W_in_q_t" if quantize == "w8a8" else "W_in_t"
    if need not in packed:
        raise ValueError(f"quantize={quantize!r} needs weights packed with "
                         f"pack_weights(..., quantize={quantize!r})")
    up = cfg.upsampling_factor
    if n_steps % up:
        raise ValueError("n_steps must cover whole frames")
    if step_offset < 0:
        raise ValueError("step_offset must be >= 0")
    R = cfg.n_resch
    nrF = sum(cfg.dilationsF)
    nrA = maxd * sum(cfg.dilationsA) + len(cfg.dilationsA)
    F = n_steps // up
    expect = {
        "bufF0": (bufF0, (nrF, B, R), torch.bfloat16),
        "bufA0": (bufA0, (nrA, B, R), torch.bfloat16),
        "x0": (x0, (2, B), torch.int32),
        "h_frames": (h_frames, (F, B, AUX_PAD), torch.bfloat16),
        "d_frames": (d_frames, (F, 1, B), torch.float32),
    }
    if mode == "forced":
        if x_forced is None:
            raise ValueError("mode='forced' requires x_forced")
        expect["x_forced"] = (x_forced, (n_steps, 1, B), torch.int32)
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def generate_reference(packed: Dict[str, Any], cfg: ModelConfig,
                       bufF0: torch.Tensor, bufA0: torch.Tensor,
                       x0: torch.Tensor, h_frames: torch.Tensor,
                       d_frames: torch.Tensor, seed: int, B: int, maxd: int,
                       n_steps: int, mode: str = "sampling",
                       step_offset: int = 0, b_offset: int = 0,
                       x_forced=None, quantize: str = "none",
                       f64_sums: bool = False):
    """Plain PyTorch version of `generate` (same signature and results),
    one step at a time on the inputs' device.  Every w8a8 sum is exact
    (`_mmq`), and the post-net products sum in float64 and round once to
    f32 as the kernel's do, so on the card the w8a8 branch agrees with the
    kernel bit for bit where the device's exp, log and tanh do.  The bf16
    W_in and W_out products sum in f32 in a fixed lane order (`_dot`); the
    kernel's tensor cores sum in their own order, so the checks compare
    both with f64_sums=True: every bf16 product (and the aux projections)
    summed in float64 and rounded once to f32, with the same bf16 storage
    points."""
    _check_args(packed, cfg, bufF0, bufA0, x0, h_frames, d_frames, B, maxd,
                n_steps, mode, step_offset, x_forced, quantize)
    bf16, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    dev = bufF0.device
    R, S, Q = cfg.n_resch, cfg.n_skipch, cfg.n_quantize
    def dot64(x, w):
        return (x.to(f64) @ w.to(f64).T).to(f32)

    if f64_sums:
        dot = dot64

        def aux_proj(h_f, W):
            return torch.einsum("bk,lkn->lbn", h_f.to(f64),
                                W.to(f64)).to(f32)
    else:
        dot, aux_proj = _dot, _aux_projections
    up = cfg.upsampling_factor
    dilsF, dilsA = cfg.dilationsF, cfg.dilationsA
    nF = len(dilsF)
    L = nF + len(dilsA)
    sizes = list(dilsF) + [maxd * d + 1 for d in dilsA]
    offs = np.cumsum([0] + sizes[:nF])[:-1].tolist() \
        + np.cumsum([0] + sizes[nF:])[:-1].tolist()
    # bf16 weights as f32 values: each product below is bf16 x bf16 summed
    # in f32; int8 weights as f32 values, summed exactly
    if quantize == "w8a8":
        W_in = packed["W_in_q_t"].to(f32)
        W_out = packed["W_out_q_t"].to(f32)

        def mm_in(x, l):
            return _mmq(x, W_in[l], packed["s_in"][l])

        def mm_out(x, l):
            return _mmq(x, W_out[l], packed["s_out"][l])
    else:
        W_in = packed["W_in_t"].to(f32)
        W_out = packed["W_out_t"].to(f32)

        def mm_in(x, l):
            return dot(x, W_in[l])

        def mm_out(x, l):
            return dot(x, W_out[l])
    W_aux = packed["W_aux"].to(f32)
    E_cat = packed["E_cat"].to(f32)
    W1, W2 = packed["W_post1_t"].to(f32), packed["W_post2_t"].to(f32)
    bufF, bufA = bufF0.clone(), bufA0.clone()
    x = x0.clone()
    rows = torch.arange(B, device=dev)
    if mode == "forced":
        out = torch.empty((n_steps, B, Q), dtype=f32, device=dev)
    else:
        out = torch.empty((n_steps, 1, B), dtype=torch.int32, device=dev)
    e_prev = E_cat[x[0].long(), R:]
    aux = None
    for t in range(n_steps):
        t_abs = t + step_offset
        frame = t // up
        w_t = packed["up_w"][t_abs % up]
        if t % up == 0:
            aux = aux_proj(h_frames[frame].to(f32), W_aux)
        z2 = E_cat[x[1].long()]
        o = (z2[:, :R] + e_prev + packed["b_causal"]).to(bf16)
        e_prev = z2[:, R:]
        skip = packed["b_skip_sum"].expand(B, S)
        for l in range(L):
            size = sizes[l]
            ring = bufF if l < nF else bufA
            wslot = offs[l] + t_abs % size
            if l < nF:
                past = ring[wslot]
            else:
                ring[wslot] = o
                r = torch.round(d_frames[frame, 0] * dilsA[l - nF]).to(
                    torch.int64).clamp(0, size - 1)
                past = ring[offs[l] + (t_abs - r + 2 * size) % size, rows]
            xin = torch.cat([o, past], -1).to(f32)
            z = mm_in(xin, l) + aux[l] * w_t + packed["c_all"][l]
            sig = torch.reciprocal(1.0 + torch.exp(-z[:, :R]))
            g = (sig * torch.tanh(z[:, R:])).to(bf16)
            outp = mm_out(g.to(f32), l)
            skip = skip + outp[:, :S]
            if l < nF:
                ring[wslot] = o
            o = (o.to(f32) + outp[:, S:] + packed["b_res"][l]).to(bf16)
        u = torch.relu(skip).to(bf16).to(f32)
        u = torch.relu(dot64(u, W1) + packed["b_post1"]).to(bf16).to(f32)
        logits = dot64(u, W2) + packed["b_post2"]
        if mode == "forced":
            out[t] = logits
            x_next = x_forced[t, 0]
        else:
            if mode == "sampling":
                logits = logits + gumbel_noise(seed, t_abs, b_offset, B, Q,
                                               dev)
            x_next = torch.argmax(logits, -1).to(torch.int32)
            out[t, 0] = x_next
        x = torch.stack([x[1], x_next])
    return out, bufF, bufA, x


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 29 + [_P] + [_I] * 15 + [_P]


def _lib():
    from qpnet_tpu_torch.ops import _build
    lib = _build.load("gen_kernel")
    lib.qp_generate.argtypes = _ARGTYPES
    lib.qp_generate.restype = ctypes.c_int
    return lib


def host_launches(cfg: ModelConfig, n_steps: int) -> Dict[str, int]:
    """What one `generate` call on the card enqueues from the host: the
    context kernel and one graph replay per frame; and the CUDA kernels each
    step runs inside the graph (embed, gate and out per layer, the two
    post-net products and the sample kernel)."""
    L = len(cfg.dilationsF) + len(cfg.dilationsA)
    return {"host_launches": 1 + n_steps // cfg.upsampling_factor,
            "kernels_per_step": 2 * L + 4}


def build() -> None:
    """Compile and load the CUDA library now (otherwise at first launch)."""
    _lib()


def generate(packed: Dict[str, Any], cfg: ModelConfig,
             bufF0: torch.Tensor, bufA0: torch.Tensor, x0: torch.Tensor,
             h_frames: torch.Tensor, d_frames: torch.Tensor, seed: int,
             B: int, maxd: int, n_steps: int, mode: str = "sampling",
             step_offset: int = 0, b_offset: int = 0, x_forced=None,
             quantize: str = "none"):
    """Run n_steps (whole frames) of generation.

    h_frames (n_steps/up, B, AUX_PAD) bf16 standardized aux, zero-padded;
    d_frames (n_steps/up, 1, B) f32 frame-rate dilation factors; x_forced
    (n_steps, 1, B) int32, required iff mode="forced"; quantize "none" or
    "w8a8", as `packed` was packed.
    Returns (samples (n_steps, 1, B) int32 — or logits (n_steps, B, Q) f32
    in forced mode — bufF, bufA, x): the state after the last step, from
    which a following chunk continues exactly.  Recorded as the span
    k1.generate (on a card: the checks, ring clones, scratch and the
    enqueue; on a CPU device: the twin's whole run).
    """
    args = (packed, cfg, bufF0, bufA0, x0, h_frames, d_frames, seed, B,
            maxd, n_steps, mode, step_offset, b_offset, x_forced, quantize)
    with profiler.span("k1.generate", B=B, n_steps=n_steps,
                       quantize=quantize):
        if bufF0.device.type == "cpu":
            return generate_reference(*args)
        return _launch(*args)


def _launch(packed, cfg, bufF0, bufA0, x0, h_frames, d_frames, seed, B,
            maxd, n_steps, mode, step_offset, b_offset, x_forced, quantize):
    """`generate` on CUDA tensors: one call of `qp_generate`."""
    if bufF0.device.type != "cuda":
        raise ValueError(f"generate runs on CUDA or CPU tensors, got "
                         f"{bufF0.device}")
    _check_args(packed, cfg, bufF0, bufA0, x0, h_frames, d_frames, B, maxd,
                n_steps, mode, step_offset, x_forced, quantize)
    R, S, Q = cfg.n_resch, cfg.n_skipch, cfg.n_quantize
    if R % 32 or S % 32 or Q % 16 or 2 * R > 1024:
        raise ValueError("the CUDA kernel needs n_resch and n_skipch to be "
                         "multiples of 32 (whole 32-deep mma chunks per "
                         "depth slice), n_quantize a multiple of 16 (16-column "
                         "tiles) and n_resch at most 512 (shared-memory "
                         "tiles; exact int32 sums in w8a8)")
    dev = bufF0.device
    tensors = list(packed.values()) + [bufF0, bufA0, x0, h_frames, d_frames]
    if x_forced is not None:
        tensors.append(x_forced)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    L = len(cfg.dilationsF) + len(cfg.dilationsA)
    bufF, bufA, x = bufF0.clone(), bufA0.clone(), x0.clone()
    forced = mode == "forced"
    out = (torch.empty((n_steps, B, Q), dtype=torch.float32, device=dev)
           if forced else
           torch.empty((n_steps, 1, B), dtype=torch.int32, device=dev))
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = [torch.empty((2, B, R), **bf), torch.empty((B, R), **bf),
               torch.empty((B, S), **bf),
               torch.empty((B, R), **f32), torch.empty((B, S), **f32),
               torch.empty((L, B, 2 * R), **f32),
               torch.empty((B, Q), **f32)]
    if quantize == "w8a8":
        products = ["W_in_q_t", "W_out_q_t", "s_in", "s_out"]
    else:
        products = ["W_in_t", "W_out_t", None, None]
    order = products + ["W_aux", "c_all", "b_res", "b_skip_sum", "up_w",
                        "E_cat", "b_causal", "W_post1_t", "W_post2_t",
                        "b_post1", "b_post2"]
    # the kernel reads these until it finishes: keep every tensor referenced
    args = [None if k is None else packed[k].contiguous() for k in order] + [
        bufF, bufA, x, h_frames.contiguous(), d_frames.contiguous(),
        x_forced.contiguous() if forced else None, out] + scratch
    ptrs = [None if a is None else a.data_ptr() for a in args]
    dils = (ctypes.c_int * L)(*(cfg.dilationsF + cfg.dilationsA))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qp_generate(
            *ptrs, ctypes.cast(dils, ctypes.c_void_p),
            len(cfg.dilationsF), len(cfg.dilationsA), B, R, S, Q, AUX_PAD,
            cfg.upsampling_factor, maxd, n_steps, int(step_offset),
            int(b_offset), int(seed), MODES[mode], QUANTIZE[quantize],
            stream)
    if err != 0:
        raise RuntimeError(f"gen_kernel launch failed: CUDA error {err}")
    profiler.count("k1.launch.w8a8" if quantize == "w8a8"
                   else "k1.launch.bf16")
    return out, bufF, bufA, x
