"""Autoregressive generation: ring priming, the two engines, the batch decode
entry point and the streaming generator, ported from
`qpnet_tpu/models/generate.py`.

Both engines prime their rings by one teacher-forced pass over the padded
history (pad value n_quantize // 2, the upsampled aux of the first frame
replicated, dilation factors 1.0), each in its own layout:

* the kernel engine (`engine="pallas"`, bf16 or w8a8) runs the sample loop
  through `ops.gen_kernel.generate` in chunks of whole frames, carrying ring
  and x state, so a chunked run is bit-identical to a one-shot run.  Its
  first step is time 0 and its adaptive rings carry one slot more than
  their deepest look-back;
* the scan engine (`engine="xla"`, the JAX package's `lax.scan`) is plain
  PyTorch, one step per loop iteration on the given device, in f32 (the
  parity mode) or bf16, optionally with int8 weights (`int8_weights`).  It
  reads d at sample rate, so it also takes dilation factors that vary
  within frames.  Its first step is time rf, and its adaptive rings have
  exactly `maxd * dilation` slots.

Finished utterances keep generating into padding; callers slice
`samples[i, :n_samples[i]]`.
"""

from __future__ import annotations

import contextlib
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models.qpnet import (
    Params, _gate, _matmul, adaptive_block, embed, fixed_block, params_to,
    resolve_device, round_look_back, upsample_aux,
)
from qpnet_tpu_torch.ops import gen_kernel
from qpnet_tpu_torch.utils import profiler

MAXD_BUCKETS = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128)

# full chunks of this many frames per kernel call; the remainder runs as a
# last, shorter chunk
DECODE_CHUNK_FRAMES = 400

ENGINES = ("auto", "pallas", "xla")
QUANTIZE = ("none", "w8a8", "int8_weights")


def bucket_maxd(maxd: float) -> int:
    for b in MAXD_BUCKETS:
        if maxd <= b:
            return b
    return int(np.ceil(maxd))


def _prime_activations(params: Params, cfg: ModelConfig, x_ctx: torch.Tensor,
                       h_up_ctx: torch.Tensor, d_ctx: torch.Tensor,
                       dtype=torch.float32):
    """Teacher-forced pass over the history context with products in
    `dtype` and f32 activations (the engines' step math); returns the layer
    inputs (causal output first), each (B, Tc, R)."""
    f32 = torch.float32
    o = embed(params, x_ctx).to(f32)
    acts = [o]
    for p, dil in zip(params["fixed"], cfg.dilationsF):
        o, _ = fixed_block(p, o, h_up_ctx, dil, dtype, f32)
        acts.append(o)
    for p, dil in zip(params["adaptive"], cfg.dilationsA):
        o, _ = adaptive_block(p, o, h_up_ctx, round_look_back(d_ctx, dil),
                              dtype, f32)
        acts.append(o)
    return acts  # len = 1 + nF + nA; acts[i] is the input of layer i


def _prime_ring_buffers(params: Params, cfg: ModelConfig,
                        x_seed: torch.Tensor, h0_up: torch.Tensor, maxd: int,
                        const_seed: bool = False, dtype=torch.float32,
                        t0: int = 0, ring_pad: int = 1):
    """Per-layer rings (B, size, R) f32 for an engine whose first step is
    time `t0`: time tau sits in slot tau mod size.  The kernel counts from
    t0 = 0 and its adaptive rings carry ring_pad = 1 slot more than their
    deepest look-back; the scan counts from t0 = rf with ring_pad = 0.
    Rolling for the wrong origin misplaces the history whenever
    rf % size != 0.  x_seed (B, rf + 1): the padded seed history, its last
    sample the seed.  dtype: the products' type of the priming pass.

    const_seed=True (a single-sample seed, so the whole history is
    mid-scale): with constant inputs and d = 1 the activations are
    time-invariant past the d = 1 receptive field, so a short pass fills
    every slot with its last activation."""
    B = x_seed.shape[0]
    rf = cfg.receptive_field(maxd)
    sizesF = list(cfg.dilationsF)
    sizesA = [maxd * dil + ring_pad for dil in cfg.dilationsA]
    dev = h0_up.device
    if const_seed:
        W = (cfg.receptive_causal + cfg.receptiveF
             + sum(cfg.dilationsA) + 16)
        x_ctx = x_seed[:, :1].expand(B, W)
        h_up_ctx = h0_up[:, None, :].expand(B, W, h0_up.shape[-1])
        d_ctx = torch.ones((B, W), dtype=torch.float32, device=dev)
        acts = _prime_activations(params, cfg, x_ctx, h_up_ctx, d_ctx, dtype)
        return ([acts[i][:, -1:].expand(B, s, -1) for i, s in enumerate(sizesF)],
                [acts[len(sizesF) + i][:, -1:].expand(B, s, -1)
                 for i, s in enumerate(sizesA)])
    h_up_ctx = h0_up[:, None, :].expand(B, rf, h0_up.shape[-1])
    d_ctx = torch.ones((B, rf), dtype=torch.float32, device=dev)
    acts = _prime_activations(params, cfg, x_seed[:, :-1], h_up_ctx, d_ctx,
                              dtype)
    # the tail act[:, rf-size:rf] holds times t0-size..t0-1; time tau goes
    # to slot tau mod size = (j + t0) mod size for tail index j
    return ([torch.roll(acts[i][:, rf - s: rf], t0 % s, 1)
             for i, s in enumerate(sizesF)],
            [torch.roll(acts[len(sizesF) + i][:, rf - s: rf], t0 % s, 1)
             for i, s in enumerate(sizesA)])


# ---------------------------------------------------------------------------
# the kernel engine
# ---------------------------------------------------------------------------

def _kernel_state(params: Params, cfg: ModelConfig, x_seed: torch.Tensor,
                  h0: torch.Tensor, maxd: int, const_seed: bool):
    """Ring priming in the kernel's layout: (bufF0, bufA0, x0).  h0: (B,
    n_aux) f32 standardized aux of the first frame."""
    h0_up = h0 * params["up_w"][0] + params["up_b"]
    bufsF, bufsA = _prime_ring_buffers(params, cfg, x_seed, h0_up, maxd,
                                       const_seed)
    bufF0 = torch.cat([b.transpose(0, 1).to(torch.bfloat16) for b in bufsF])
    bufA0 = torch.cat([b.transpose(0, 1).to(torch.bfloat16) for b in bufsA])
    x0 = torch.stack([x_seed[:, -2], x_seed[:, -1]]).to(torch.int32)
    return bufF0.contiguous(), bufA0.contiguous(), x0.contiguous()


def _roll_rings(buf: torch.Tensor, sizes: Sequence[int],
                shift: int) -> torch.Tensor:
    """Rings in the kernel's layout (sum(sizes), B, C), primed for a first
    step at time 0, moved to a first step at time `shift`: each layer's
    slots rolled by shift mod its size, so that time tau stays in slot tau
    mod size (`_prime_ring_buffers`' t0)."""
    return torch.cat([torch.roll(seg, shift % s, 0)
                      for seg, s in zip(torch.split(buf, list(sizes)), sizes)])


def _prologue(params: Params, cfg: ModelConfig, x_seed: torch.Tensor,
              h_pad0: torch.Tensor, maxd: int, const_seed: bool,
              quantize: str = "none"):
    """Weight packing and ring priming (the spans decode.pack and
    decode.prime): (packed, bufF0, bufA0, x0) in the kernel's layout.
    h_pad0: (B, >= n_aux) first frame of the kernel's aux input."""
    with profiler.span("decode.pack"):
        packed = gen_kernel.pack_weights(params, cfg, quantize)
    with profiler.span("decode.prime"):
        return (packed, *_kernel_state(params, cfg, x_seed,
                                       h_pad0[:, :cfg.n_aux].float(), maxd,
                                       const_seed))


def _pallas_host_prep(cfg: ModelConfig, h: np.ndarray, d: np.ndarray,
                      n_steps: int, device):
    """Frame-major kernel inputs: h (F, B, AUX_PAD) bf16 with the last
    frame repeated, d (F, 1, B) f32 padded with 1.0, and n_steps rounded up
    to whole 10-frame buckets."""
    B, F, A = h.shape
    up = cfg.upsampling_factor
    chunk = 10 * up
    n_pad_steps = -(-n_steps // chunk) * chunk
    F_needed = -(-n_pad_steps // up)
    h_pad = np.zeros((F_needed, B, gen_kernel.AUX_PAD), np.float32)
    h_pad[:min(F, F_needed), :, :A] = np.moveaxis(h, 0, 1)[:F_needed]
    if F < F_needed:
        h_pad[F:] = h_pad[F - 1]
    d_frames = np.ones((F_needed, 1, B), np.float32)
    d_fr = d[:, ::up]
    d_frames[:min(d_fr.shape[1], F_needed), 0] = \
        np.moveaxis(d_fr, 0, 1)[:F_needed]
    return (torch.from_numpy(h_pad).to(device=device, dtype=torch.bfloat16),
            torch.from_numpy(d_frames).to(device), n_pad_steps)


def _pallas_path(params: Params, cfg: ModelConfig, x_seed: np.ndarray,
                 h: np.ndarray, d: np.ndarray, n_steps: int, maxd: int,
                 seed: int, mode: str, const_seed: bool = False,
                 device="cuda", x_forced=None,
                 quantize: str = "none", rows: np.ndarray = None
                 ) -> np.ndarray:
    """Generation through the kernel, in chunks of DECODE_CHUNK_FRAMES
    frames with carried state.  Returns (B, n_steps) int32 samples, or
    (n_steps, B, Q) f32 logits in forced mode (x_forced: (B, n_steps)).

    rows: a shard's global rows of the batch that x_seed, h and d hold
    whole (contiguous, the last row repeated as padding).  The shard primes
    the whole batch, as one call over it does (the priming's products may
    round otherwise at another batch size), takes its rows' rings, and
    keys the sampling hash off its first row's global index.

    Spans: decode.prep up to the first kernel call (decode.pack,
    decode.prime, decode.host_prep with the uploads), a k1.generate a
    chunk, decode.copy_back."""
    with profiler.span("decode.prep"):
        params = params_to(params, device)
        h0 = torch.from_numpy(np.ascontiguousarray(h[:, 0])).to(
            device=device, dtype=torch.bfloat16)   # the kernel's aux: bf16
        packed, bufF, bufA, x0 = _prologue(
            params, cfg, torch.as_tensor(x_seed, dtype=torch.int64,
                                         device=device),
            h0, maxd, const_seed, quantize)
        b_offset = 0
        if rows is not None:
            idx = torch.as_tensor(rows, device=device)
            bufF, bufA, x0 = (t.index_select(1, idx).contiguous()
                              for t in (bufF, bufA, x0))
            h, d, b_offset = h[rows], d[rows], int(rows[0])
        B = h.shape[0]
        with profiler.span("decode.host_prep"):
            h_pad, d_frames, n_pad_steps = _pallas_host_prep(
                cfg, h, d, n_steps, device)
            xf = None
            if mode == "forced":
                xf_np = np.zeros((n_pad_steps, 1, B), np.int32)
                xf_np[:n_steps, 0, :] = np.asarray(x_forced, np.int32).T
                xf = torch.from_numpy(xf_np).to(device)
    up = cfg.upsampling_factor
    chunk_steps = DECODE_CHUNK_FRAMES * up
    pieces = []
    off = 0
    while off < n_pad_steps:
        steps = min(chunk_steps, n_pad_steps - off)
        f0_, f1_ = off // up, (off + steps) // up
        out, bufF, bufA, x0 = gen_kernel.generate(
            packed, cfg, bufF, bufA, x0, h_pad[f0_:f1_], d_frames[f0_:f1_],
            seed, B=B, maxd=maxd, n_steps=steps, mode=mode,
            step_offset=off, b_offset=b_offset, quantize=quantize,
            x_forced=None if xf is None else xf[off:off + steps])
        if mode != "forced" and cfg.n_quantize <= 256:
            out = out.to(torch.uint8)  # quarters the device-to-host copy
        pieces.append(out)
        off += steps
    with profiler.span("decode.copy_back"):
        out = torch.cat(pieces).cpu().numpy()
        if mode == "forced":
            return out[:n_steps]
        return np.moveaxis(out.astype(np.int32)[:, 0, :], 0, 1)[:, :n_steps]


def _frame_constant(d: np.ndarray, up: int) -> bool:
    """True when the sample-rate dilation track is constant within frames
    (the kernel reads d at frame rate)."""
    T = (d.shape[1] // up) * up
    if T == 0:
        return True
    dv = d[:, :T].reshape(d.shape[0], -1, up)
    return bool(np.all(dv == dv[:, :, :1]))


def _seed_and_d(cfg: ModelConfig, x: np.ndarray, d: np.ndarray,
                n_steps: int):
    """(maxd, x_seed, d_gen): the maxd bucket, the seed history padded to
    rf + 1 with mid-scale, and d padded with 1.0 to n_steps."""
    maxd = bucket_maxd(float(np.nanmax(np.ceil(d))) if d.size else 1.0)
    rf = cfg.receptive_field(maxd)
    n_pad = rf + 1 - x.shape[1]
    if n_pad > 0:
        x_seed = np.pad(x, ((0, 0), (n_pad, 0)),
                        constant_values=cfg.n_quantize // 2)
    else:
        x_seed = x[:, -(rf + 1):]
    d_gen = np.pad(d.astype(np.float32),
                   ((0, 0), (0, max(0, n_steps - d.shape[1]))),
                   constant_values=1.0)[:, :n_steps]
    return maxd, np.asarray(x_seed, np.int32), d_gen


# ---------------------------------------------------------------------------
# the scan engine
# ---------------------------------------------------------------------------

def _quantize_int8(w: torch.Tensor):
    """Per-output-column symmetric int8 weight quantization: (q int8, s f32
    (1, N)) with w ~ q * s."""
    s = torch.amax(torch.abs(w), dim=0, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-12)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s.to(torch.float32)


def _fused_weights(params: Params, dtype, quantize: str = "none"):
    """Per-layer weights for the two-product step: W_in = [W_cur; W_prev]
    and W_out = [W_skip | W_res] in `dtype`, or with
    quantize="int8_weights" as int8 with per-column scales (weight-only
    quantization)."""
    def fuse(p):
        W_in = torch.cat([p["W_cur"], p["W_prev"]], 0)
        W_out = torch.cat([p["W_skip"], p["W_res"]], 1)
        d = {"W_aux": p["W_aux"].to(dtype),
             "b_gate": p["b_gate"].float(),
             "b_skip": p["b_skip"].float(),
             "b_res": p["b_res"].float()}
        if quantize == "int8_weights":
            d["W_in_q"], d["s_in"] = _quantize_int8(W_in)
            d["W_out_q"], d["s_out"] = _quantize_int8(W_out)
        else:
            d["W_in"] = W_in.to(dtype)
            d["W_out"] = W_out.to(dtype)
        return d

    return ([fuse(p) for p in params["fixed"]],
            [fuse(p) for p in params["adaptive"]])


def _wmatmul(x: torch.Tensor, p: dict, key: str, dtype) -> torch.Tensor:
    """x @ W for a fused weight entry: an int8 weight is cast to `dtype`
    (exact), multiplied, then scaled per column."""
    if key + "_q" in p:
        y = _matmul(x, p[key + "_q"].to(dtype), dtype)
        return y * p["s_" + key.split("_")[1]]
    return _matmul(x, p[key], dtype)


def _sample(logits: torch.Tensor, generator: torch.Generator,
            rows: torch.Tensor = None, n_rows: int = None) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max trick on
    uniforms from `generator` (on the logits' device).  A shard (its global
    `rows` of a batch of `n_rows`) draws the whole batch's uniforms and
    takes its rows, so sharding leaves the stream unchanged."""
    u = torch.rand((logits.shape[0] if rows is None else n_rows,
                    logits.shape[1]), generator=generator,
                   dtype=torch.float32, device=logits.device)
    if rows is not None:
        u = u[rows]
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + g, dim=-1)


def _scan_layer(p: dict, o: torch.Tensor, past: torch.Tensor,
                h_t: torch.Tensor, R: int, dtype) -> torch.Tensor:
    """One residual block at one step: [skip | res] (B, S + R) f32."""
    z = (_wmatmul(torch.cat([o, past], -1), p, "W_in", dtype)
         + _matmul(h_t, p["W_aux"], dtype) + p["b_gate"])
    return _wmatmul(_gate(z, R), p, "W_out", dtype)


def _generate_scan(params: Params, cfg: ModelConfig, x_seed: torch.Tensor,
                   h: torch.Tensor, d: torch.Tensor, n_steps: int, maxd: int,
                   mode: str = "sampling", compute_dtype=torch.bfloat16,
                   quantize: str = "none", const_seed: bool = False,
                   forced_x: torch.Tensor = None,
                   generator: torch.Generator = None,
                   rows: torch.Tensor = None, n_rows: int = None
                   ) -> torch.Tensor:
    """The scan engine, one step per iteration, on the tensors' device.

    x_seed: (B, rf + 1) int mid-scale-padded seed history, its last element
    the seed (timeline position rf); h: (B, F, A) f32 frame-rate aux,
    upsampled here, sample position rf + i reading h_up[:, i]; d: (B,
    >= n_steps) f32 sample-rate dilation factors (position rf + i uses
    d[:, i]); forced_x: (B, n_steps) int, required iff mode="forced", the
    sample each step feeds back.  Sampling draws from `generator`.
    Returns (B, n_steps) int32 samples, or in forced mode (B, n_steps,
    n_quantize) f32 logits.  rows, n_rows: a shard's global rows and the
    whole batch's row count, for the sampling noise (see `_sample`).
    """
    if mode not in ("sampling", "argmax", "forced"):
        raise ValueError("mode should be sampling, argmax or forced")
    R, S = cfg.n_resch, cfg.n_skipch
    f32 = torch.float32
    dev = x_seed.device
    rf = cfg.receptive_field(maxd)
    B = x_seed.shape[0]
    if x_seed.shape[1] != rf + 1:
        raise ValueError(f"x_seed must hold rf + 1 = {rf + 1} samples")
    h_up = upsample_aux(params, h, cfg.upsampling_factor)    # (B, F*up, A)
    if h_up.shape[1] < n_steps:
        raise ValueError(f"h covers {h_up.shape[1]} samples, fewer than "
                         f"n_steps={n_steps}")
    fixedW, adaptW = _fused_weights(params, compute_dtype, quantize)
    embed_cur = params["embed_cur"].to(f32)
    embed_prev = params["embed_prev"].to(f32)
    b_causal = params["b_causal"].to(f32)
    W_post1 = params["W_post1"].to(compute_dtype)
    W_post2 = params["W_post2"].to(compute_dtype)
    b_post1, b_post2 = params["b_post1"], params["b_post2"]

    # rings over positions [0, rf-1] (the seed excluded), for a first step
    # at time rf; cloned so the steps can write them in place
    bufsF, bufsA = _prime_ring_buffers(
        params, cfg, x_seed, h_up[:, 0], maxd, const_seed, compute_dtype,
        t0=rf, ring_pad=0)
    bufsF = [b.contiguous().clone() for b in bufsF]
    bufsA = [b.contiguous().clone() for b in bufsA]
    sizesF = list(cfg.dilationsF)
    sizesA = [maxd * dil for dil in cfg.dilationsA]

    # per-step inputs: aux, and each adaptive layer's read slot with its
    # look-back clipped to [0, size]; r == 0 reads the current o, which the
    # ring (past values only) does not hold
    h_steps = h_up[:, :n_steps].transpose(0, 1).contiguous()   # (T, B, A)
    t = rf + torch.arange(n_steps, device=dev)
    b_idx = torch.arange(B, device=dev)
    reads, current = [], []
    for dil, size in zip(cfg.dilationsA, sizesA):
        r = torch.clamp(round_look_back(d[:, :n_steps], dil), 0, size).T
        reads.append(((t[:, None] - r + size) % size).long())   # (T, B)
        current.append((r == 0)[..., None])                      # (T, B, 1)
    if mode == "forced":
        fx = forced_x.to(device=dev, dtype=torch.long).T.contiguous()
        out = torch.empty((n_steps, B, cfg.n_quantize), dtype=f32, device=dev)
    else:
        out = torch.empty((n_steps, B), dtype=torch.int32, device=dev)

    x_prev, x_cur = x_seed[:, -2].long(), x_seed[:, -1].long()
    for i in range(n_steps):
        ti = rf + i
        h_t = h_steps[i]
        o = embed_cur[x_cur] + embed_prev[x_prev] + b_causal
        skip_sum = torch.zeros((B, S), dtype=f32, device=dev)
        for p, buf, size in zip(fixedW, bufsF, sizesF):
            y = _scan_layer(p, o, buf[:, ti % size], h_t, R, compute_dtype)
            skip_sum = skip_sum + y[:, :S] + p["b_skip"]
            buf[:, ti % size] = o
            o = o + y[:, S:] + p["b_res"]
        for li, (p, buf, size) in enumerate(zip(adaptW, bufsA, sizesA)):
            past = torch.where(current[li][i], o, buf[b_idx, reads[li][i]])
            y = _scan_layer(p, o, past, h_t, R, compute_dtype)
            skip_sum = skip_sum + y[:, :S] + p["b_skip"]
            buf[:, ti % size] = o
            o = o + y[:, S:] + p["b_res"]
        u = F.relu(skip_sum)
        u = F.relu(_matmul(u, W_post1, compute_dtype) + b_post1)
        logits = _matmul(u, W_post2, compute_dtype) + b_post2
        if mode == "forced":
            out[i] = logits
            x_next = fx[i]
        else:
            x_next = (_sample(logits, generator, rows, n_rows)
                      if mode == "sampling"
                      else torch.argmax(logits, dim=-1))
            out[i] = x_next
        x_prev, x_cur = x_cur, x_next
    return out.transpose(0, 1)


def _scan_path(params: Params, cfg: ModelConfig, x_seed: np.ndarray,
               h: np.ndarray, d: np.ndarray, n_steps: int, maxd: int,
               seed: int, mode: str, compute_dtype, quantize: str,
               const_seed: bool, device, x_forced=None,
               rows: np.ndarray = None) -> np.ndarray:
    """The scan engine on `device`: (B, n_steps) int32 samples, or in
    forced mode (B, n_steps, Q) f32 logits.  Sampling seeds a
    torch.Generator on the device with `seed`: deterministic given the
    seed, and equal to the JAX scan's `jax.random.categorical` draws only
    in distribution.  rows: a shard's global rows of the batch that
    x_seed, h and d hold whole; it draws the whole batch's noise.  (On the
    card its cuBLAS products may round otherwise than at the whole batch's
    size, so there a shard agrees with one device only to rounding.)"""
    n_rows = None
    if rows is not None:
        n_rows = h.shape[0]
        x_seed, h, d = x_seed[rows], h[rows], d[rows]
        rows = torch.as_tensor(rows, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        out = _generate_scan(
            params_to(params, device), cfg,
            torch.as_tensor(np.asarray(x_seed), dtype=torch.long,
                            device=device),
            torch.as_tensor(np.asarray(h, np.float32), device=device),
            torch.as_tensor(np.asarray(d, np.float32), device=device),
            n_steps, maxd, mode, compute_dtype, quantize, const_seed,
            forced_x=(None if x_forced is None
                      else torch.as_tensor(np.asarray(x_forced),
                                           device=device)),
            generator=gen, rows=rows, n_rows=n_rows)
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# engine routing and the entry points
# ---------------------------------------------------------------------------

def check_engine(engine: str, quantize: str) -> None:
    """Raise ValueError for an unknown engine or scheme, or a pair that does
    not go together: w8a8 is the kernel's scheme, int8_weights the scan's."""
    if quantize == "int8":
        raise ValueError(
            "quantize='int8' is ambiguous: use 'w8a8' (kernel engine: "
            "dynamic activation + weight int8) or 'int8_weights' (scan "
            "engine: weight-only dequantized products)")
    if engine not in ENGINES:
        raise ValueError("engine should be 'auto', 'pallas' or 'xla'")
    if quantize not in QUANTIZE:
        raise ValueError(f"unknown quantize {quantize!r}")
    if quantize == "w8a8" and engine == "xla":
        raise ValueError("quantize='w8a8' is a kernel-engine (pallas) scheme")
    if quantize == "int8_weights" and engine == "pallas":
        raise ValueError("quantize='int8_weights' is a scan-engine (xla) "
                         "scheme")


def _use_scan(engine: str, quantize: str, d_gen: np.ndarray,
              up: int) -> bool:
    """The JAX package's routing: "xla" runs the scan, "pallas" the kernel
    (CUDA on the card, its twin on a CPU device), and "auto" the kernel
    unless d varies within frames or quantize="int8_weights", which only
    the scan takes."""
    check_engine(engine, quantize)
    frame_const = _frame_constant(d_gen, up)
    if engine == "pallas" and not frame_const:
        raise ValueError(
            "engine='pallas' streams dilation factors at frame rate; this "
            "input varies d within frames, which would silently change the "
            "adaptive look-backs: use engine='auto' or 'xla'")
    if engine != "auto":
        return engine == "xla"
    reasons = []
    if not frame_const:
        reasons.append("dilation factors vary within frames")
    if quantize == "int8_weights":
        reasons.append("quantize='int8_weights' is the scan's scheme")
    if not reasons:
        return False
    if quantize == "w8a8":
        raise ValueError(
            "quantize='w8a8' requires the kernel engine, which reads d at "
            "frame rate, and this input varies d within frames")
    logging.info("batch_fast_generate: using the scan engine because %s",
                 "; ".join(reasons))
    return True


def _mesh_path(mesh, run, B: int) -> np.ndarray:
    """Sharded decode: the batch, padded to a multiple of the mesh size by
    repeating its last utterance, splits into equal blocks of rows, and
    `run(device, rows)` generates each block on its shard's device in a
    thread of its own; the rows are gathered and the padding dropped.  Each
    shard works from the whole batch (the kernel's priming, the scan's
    noise) and keys the kernel's hash off its global rows, so the kernel's
    output equals one call over the whole batch (the scan's, on a card,
    to rounding)."""
    if mesh.rank is not None:
        raise ValueError(f"decode shards over a mesh that one process "
                         f"drives whole, got {mesh}")
    for dev in mesh.devices:
        resolve_device(dev)
    per = -(-B // mesh.size)

    def shard(i):
        dev = mesh.devices[i]
        rows = np.minimum(np.arange(i * per, (i + 1) * per), B - 1)
        # K1 captures and replays on the current device (cudaGetDevice)
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            return run(dev, rows)

    with ThreadPoolExecutor(mesh.size) as ex:
        outs = list(ex.map(shard, range(mesh.size)))
    return np.concatenate(outs)[:B]


def batch_fast_generate(params: Params, cfg: ModelConfig,
                        x: np.ndarray, h: np.ndarray,
                        n_samples_list: Sequence[int], d: np.ndarray,
                        seed: int = 100, mode: str = "sampling",
                        compute_dtype=torch.bfloat16,
                        quantize: str = "none", engine: str = "auto",
                        device="cuda", mesh=None) -> List[np.ndarray]:
    """Batch AR synthesis.

    x: (B, T_seed) int seed samples (typically one mu-law zero);
    h: (B, F, A) standardized frame-rate aux, zero-padded to the longest
    utterance; n_samples_list: samples per utterance (F_i * up - 1);
    d: (B, F * up) f32 sample-rate dilation factors.
    Returns a list of (n_samples_i,) int32 mu-law sample arrays.

    engine "pallas" runs the generation kernel (on a CPU device, its plain
    twin) in bf16 or, with quantize="w8a8", int8 weights and activations;
    it needs d constant within frames.  "xla" runs the scan engine in
    `compute_dtype` (float32 is the parity mode), optionally with
    quantize="int8_weights".  "auto" runs the kernel, and the scan only
    where d varies within frames or quantize="int8_weights".  The kernel
    is bf16 by construction and ignores `compute_dtype`.  The scan samples
    from a torch.Generator seeded with `seed`, and the kernel from its
    counter hash: each is deterministic given the seed.

    mesh (`parallel.Mesh`): the batch shards over its devices (`device` is
    then not used), one thread per shard (`_mesh_path`).  Through the
    kernel the output equals one device's bit for bit; through the scan on
    a card, only to rounding (`_scan_path`).

    Recorded as the span decode.call; the kernel engine on one device
    records its parts inside it (`_pallas_path`).
    """
    n_steps = int(max(n_samples_list))
    with profiler.span("decode.call", B=len(n_samples_list), n_steps=n_steps,
                       engine=engine, quantize=quantize) as call:
        device = resolve_device(device) if mesh is None else None
        maxd, x_seed, d_gen = _seed_and_d(cfg, x, d, n_steps)
        scan = _use_scan(engine, quantize, d_gen, cfg.upsampling_factor)
        call.attrs["engine"] = "xla" if scan else "pallas"
        const_seed = x.shape[1] <= 1
        if not const_seed:
            logging.warning(
                "batch_fast_generate: %d-sample seed history primes with "
                "replicated first-frame aux and d=1 (not the true history "
                "track); outputs near the seed boundary deviate from the "
                "reference's continuation semantics", x.shape[1])
        h = np.asarray(h, np.float32)

        def run(dev, rows=None):
            if scan:
                return _scan_path(params, cfg, x_seed, h, d_gen, n_steps,
                                  maxd, seed, mode, compute_dtype, quantize,
                                  const_seed, dev, rows=rows)
            return _pallas_path(params, cfg, x_seed, h, d_gen, n_steps,
                                maxd, seed, mode, const_seed=const_seed,
                                device=dev, quantize=quantize, rows=rows)

        if mesh is None:
            samples = run(device)
        else:
            logging.info("batch_fast_generate: %d rows over a %d-shard mesh",
                         h.shape[0], mesh.size)
            samples = _mesh_path(mesh, run, h.shape[0])
        return [samples[i, :n] for i, n in enumerate(n_samples_list)]


def teacher_forced_logits(params: Params, cfg: ModelConfig,
                          x: np.ndarray, h: np.ndarray,
                          forced: np.ndarray, d: np.ndarray,
                          engine: str = "xla", compute_dtype=torch.bfloat16,
                          quantize: str = "none",
                          device="cuda") -> np.ndarray:
    """Per-step logits of a generation engine under teacher forcing: the
    same machinery as `batch_fast_generate` (priming, rings, the scan or
    the kernel), fed the given `forced` (B, n_steps) stream instead of its
    own samples.  engine: "xla" (the scan, in `compute_dtype`) or "pallas"
    (the kernel, bf16).  Returns (B, n_steps, n_quantize) f32;
    logits[:, i] is the distribution step i would have sampled
    forced[:, i] from."""
    device = resolve_device(device)
    if engine not in ("xla", "pallas"):
        raise ValueError("engine should be 'xla' or 'pallas'")
    n_steps = int(forced.shape[1])
    maxd, x_seed, d_gen = _seed_and_d(cfg, x, d, n_steps)
    const_seed = x.shape[1] <= 1
    if _use_scan(engine, quantize, d_gen, cfg.upsampling_factor):
        return _scan_path(params, cfg, x_seed, h, d_gen, n_steps, maxd, 0,
                          "forced", compute_dtype, quantize, const_seed,
                          device, x_forced=forced)
    out = _pallas_path(params, cfg, x_seed, np.asarray(h, np.float32), d_gen,
                       n_steps, maxd, seed=0, mode="forced",
                       const_seed=const_seed, device=device,
                       x_forced=forced, quantize=quantize)
    return np.moveaxis(out, 0, 1)


def check_streaming_quantize(quantize: str) -> None:
    """Streaming runs the generation kernel: "none", "w8a8", or
    "int8_weights", which the kernel has no scheme for and streams as
    "none" (bf16 weights), as the JAX package's pack_weights does for
    anything but w8a8; refuse anything else."""
    if quantize not in QUANTIZE:
        raise ValueError(f"unknown quantize {quantize!r}")


class StreamingGenerator:
    """Chunked low-latency generation with carried ring state, ported from
    the JAX package's `StreamingGenerator`.

    Each `feed()` generates a whole-frame chunk of samples for B streams
    and returns it, carrying the rings and the last two samples across
    calls; ring slots, the upsampler phase and the sampling hash key off
    the absolute sample index, so feeds of any whole-frame lengths continue
    exactly.  The rings are primed from a mid-scale seed history and the
    group's first frame, at the first feed after construction or `reset`;
    `prime_rows` starts streams in rows of a running session at its step,
    and `move_rows` hands rows to a session of another B.
    The session runs at its own batch B on `device` (CUDA by default; a
    CPU device runs the kernel's plain twin).  The nominal chunk is
    `min_chunk_samples` rounded up to whole frames.  quantize "w8a8" runs
    the kernel's w8a8 branch; "int8_weights", a scheme of the scan engine
    only, packs the weights as bf16 and streams through the bf16 branch,
    as the JAX package's session does (so its audio is the "none"
    session's).
    """

    def __init__(self, params: Params, cfg: ModelConfig, B: int,
                 maxd: int = 32, seed: int = 100, mode: str = "sampling",
                 min_chunk_samples: int = 5500, quantize: str = "none",
                 device="cuda"):
        check_streaming_quantize(quantize)
        # the kernel's scheme: int8_weights packs bf16, as the JAX
        # package's pack_weights does for anything but w8a8
        self._kq = "w8a8" if quantize == "w8a8" else "none"
        if mode not in ("sampling", "argmax"):
            raise ValueError("mode should be sampling or argmax")
        self.device = resolve_device(device)
        self.cfg, self.B, self.maxd = cfg, B, maxd
        self.seed, self.mode, self.quantize = seed, mode, quantize
        up = cfg.upsampling_factor
        self.chunk = -(-min_chunk_samples // up) * up
        self.chunk_frames = self.chunk // up
        self._params = params_to(params, self.device)
        self._packed = gen_kernel.pack_weights(self._params, cfg, self._kq)
        self._state = None
        self._offset = 0

    def reset(self, seed: int = None) -> None:
        """Start a new group of utterances: drop the carried ring state and
        restart the absolute step counter, keeping the packed weights."""
        if seed is not None:
            self.seed = seed
        self._state = None
        self._offset = 0

    def _primed(self, h_first_frame: np.ndarray):
        """The kernel state (bufF0, bufA0, x0) for a first step at time 0:
        rings for a constant mid-scale seed history (the recipe's decode
        seed) and each row's first frame of aux, f32 (B, n_aux)."""
        rf = self.cfg.receptive_field(self.maxd) + 1
        x_seed = torch.full((self.B, rf), self.cfg.n_quantize // 2,
                            dtype=torch.int64, device=self.device)
        h0 = torch.as_tensor(h_first_frame, dtype=torch.float32,
                             device=self.device)
        return _kernel_state(self._params, self.cfg, x_seed, h0, self.maxd,
                             const_seed=True)

    def prime_rows(self, rows: Sequence[int],
                   h_first_frames: np.ndarray) -> None:
        """Start new streams in `rows` of a running session at its current
        step: each row gets the state that a fresh session's first feed
        gives it (`_primed`, run at this session's B, so that its products
        round as a fresh session's do), with each layer's ring rolled to the
        current step.  h_first_frames: (len(rows), n_aux), each stream's
        first frame of aux.  The step is a whole frame, so the upsampler's
        phase needs nothing.  Span: gen.prime."""
        if self._state is None:
            raise RuntimeError("prime_rows starts rows of a running session; "
                               "a fresh session primes at its first feed")
        cfg = self.cfg
        h0 = np.zeros((self.B, cfg.n_aux), np.float32)
        h0[list(rows)] = h_first_frames
        idx = torch.as_tensor(list(rows), dtype=torch.long,
                              device=self.device)
        sizesA = [self.maxd * d + 1 for d in cfg.dilationsA]
        with profiler.span("gen.prime"):
            bufF, bufA, x0 = (t.index_select(1, idx)
                              for t in self._primed(h0))
            new = (_roll_rings(bufF, cfg.dilationsF, self._offset),
                   _roll_rings(bufA, sizesA, self._offset), x0)
            for dst, src in zip(self._state, new):
                dst[:, idx] = src

    def move_rows(self, target: "StreamingGenerator",
                  rows: Sequence[int]) -> None:
        """Hand the streams in `rows` of this running session to `target`, a
        session of the same model, maxd and mode at another B, as its rows
        0..len(rows)-1 in order: their rings and last two samples are
        copied, and target takes this session's step and seed, so that
        each stream goes on at the same steps (its sampling keyed off its
        new row).  The target's other rows start from zero state, as
        padding; this session is reset."""
        if self._state is None:
            raise RuntimeError("move_rows needs a running session")
        if len(rows) > target.B:
            raise ValueError(f"{len(rows)} rows do not fit a session of "
                             f"B={target.B}")
        idx = torch.as_tensor(list(rows), dtype=torch.long,
                              device=self.device)
        state = []
        for t in self._state:
            moved = t.new_zeros((t.shape[0], target.B) + tuple(t.shape[2:]))
            moved[:, :len(rows)] = t.index_select(1, idx)
            state.append(moved)
        target._state = tuple(state)
        target._offset, target.seed = self._offset, self.seed
        self.reset()

    def feed(self, h_frames: np.ndarray, d_frames: np.ndarray) -> np.ndarray:
        """h_frames: (B, F, n_aux) standardized aux; d_frames: (B, F)
        dilation factors, F >= 1.  Returns (B, F*up) int32 mu-law samples,
        copied to the host (which waits for the card).  Spans: gen.prime
        (the first feed of a group), gen.upload, k1.generate and
        gen.copy_back."""
        cfg, B = self.cfg, self.B
        h_frames = np.asarray(h_frames, np.float32)
        d_frames = np.asarray(d_frames, np.float32)
        F = h_frames.shape[1] if h_frames.ndim == 3 else 0
        if F < 1 or h_frames.shape != (B, F, cfg.n_aux):
            raise ValueError(f"h_frames must be ({B}, F >= 1, {cfg.n_aux}), "
                             f"got {h_frames.shape}")
        if d_frames.shape != (B, F):
            raise ValueError(f"d_frames must be ({B}, {F}), got "
                             f"{d_frames.shape}")
        if float(np.max(d_frames)) > self.maxd:
            raise ValueError(
                f"dilation factor {float(np.max(d_frames)):.1f} exceeds the "
                f"session's maxd={self.maxd}; recreate the session with a "
                f"larger maxd (ring look-backs would silently saturate)")
        h_pad = np.zeros((F, B, gen_kernel.AUX_PAD), np.float32)
        h_pad[:, :, :cfg.n_aux] = np.moveaxis(h_frames, 0, 1)
        d_pad = np.moveaxis(d_frames, 0, 1)[:, None, :].copy()
        if self._state is None:
            with profiler.span("gen.prime"):
                self._state = self._primed(h_frames[:, 0])
        with profiler.span("gen.upload"):
            h_dev = torch.from_numpy(h_pad).to(self.device, torch.bfloat16)
            d_dev = torch.from_numpy(d_pad).to(self.device)
        n_steps = F * cfg.upsampling_factor
        samples, *state = gen_kernel.generate(
            self._packed, cfg, *self._state, h_dev, d_dev, self.seed, B=B,
            maxd=self.maxd, n_steps=n_steps, mode=self.mode,
            step_offset=self._offset, quantize=self._kq)
        self._state = tuple(state)
        self._offset += n_steps
        with profiler.span("gen.copy_back"):
            return samples[:, 0, :].T.cpu().numpy()
