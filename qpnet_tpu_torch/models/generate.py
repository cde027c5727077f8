"""Autoregressive generation: ring priming, the kernel's input layout, the
chunked kernel loop, the batch decode entry point and the streaming
generator, ported from `qpnet_tpu/models/generate.py` (its kernel engine,
bf16 and w8a8).

The rings are primed by one teacher-forced f32 pass over the padded
history (pad value n_quantize // 2, the upsampled aux of the first frame
replicated, dilation factors 1.0), laid out for the kernel's time origin
t0 = 0.  Generation then runs in chunks of whole frames through
`ops.gen_kernel.generate`, carrying ring and x state, so a chunked run is
bit-identical to a one-shot run.  Finished utterances keep generating into
padding; callers slice `samples[i, :n_samples[i]]`.
"""

from __future__ import annotations

import logging
from typing import List, Sequence

import numpy as np
import torch

from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models.qpnet import (
    Params, adaptive_block, embed, fixed_block, params_to, resolve_device,
    round_look_back,
)
from qpnet_tpu_torch.ops import gen_kernel

MAXD_BUCKETS = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128)

# full chunks of this many frames per kernel call; the remainder runs as a
# last, shorter chunk
DECODE_CHUNK_FRAMES = 400

_ROADMAP_SCAN = ("the XLA-scan engine is not ported yet: ROADMAP.md, "
                 "Queue 1 item 4 (left out of the first slice)")


def bucket_maxd(maxd: float) -> int:
    for b in MAXD_BUCKETS:
        if maxd <= b:
            return b
    return int(np.ceil(maxd))


def _prime_activations(params: Params, cfg: ModelConfig, x_ctx: torch.Tensor,
                       h_up_ctx: torch.Tensor, d_ctx: torch.Tensor):
    """Teacher-forced f32 pass over the history context; returns the layer
    inputs (causal output first), each (B, Tc, R)."""
    R = cfg.n_resch
    f32 = torch.float32
    o = embed(params, x_ctx).to(f32)
    acts = [o]
    for p, dil in zip(params["fixed"], cfg.dilationsF):
        o, _ = fixed_block(p, o, h_up_ctx, dil, R, f32, act_dtype=f32)
        acts.append(o)
    for p, dil in zip(params["adaptive"], cfg.dilationsA):
        o, _ = adaptive_block(p, o, h_up_ctx, round_look_back(d_ctx, dil), R,
                              f32, act_dtype=f32)
        acts.append(o)
    return acts  # len = 1 + nF + nA; acts[i] is the input of layer i


def _prime_ring_buffers(params: Params, cfg: ModelConfig,
                        x_seed: torch.Tensor, h0_up: torch.Tensor, maxd: int,
                        const_seed: bool = False):
    """Per-layer rings (B, size, R) f32 laid out for the kernel, whose first
    step is time 0: slot s of a ring of `size` holds time s - size.
    x_seed (B, rf + 1): the padded seed history, its last sample the seed.
    The adaptive rings carry one slot more than their deepest look-back.

    const_seed=True (a single-sample seed, so the whole history is
    mid-scale): with constant inputs and d = 1 the activations are
    time-invariant past the d = 1 receptive field, so a short pass fills
    every slot with its last activation."""
    B = x_seed.shape[0]
    rf = cfg.receptive_field(maxd)
    sizesF = list(cfg.dilationsF)
    sizesA = [maxd * dil + 1 for dil in cfg.dilationsA]
    dev = h0_up.device
    if const_seed:
        W = (cfg.receptive_causal + cfg.receptiveF
             + sum(cfg.dilationsA) + 16)
        x_ctx = x_seed[:, :1].expand(B, W)
        h_up_ctx = h0_up[:, None, :].expand(B, W, h0_up.shape[-1])
        d_ctx = torch.ones((B, W), dtype=torch.float32, device=dev)
        acts = _prime_activations(params, cfg, x_ctx, h_up_ctx, d_ctx)
        return ([acts[i][:, -1:].expand(B, s, -1) for i, s in enumerate(sizesF)],
                [acts[len(sizesF) + i][:, -1:].expand(B, s, -1)
                 for i, s in enumerate(sizesA)])
    h_up_ctx = h0_up[:, None, :].expand(B, rf, h0_up.shape[-1])
    d_ctx = torch.ones((B, rf), dtype=torch.float32, device=dev)
    acts = _prime_activations(params, cfg, x_seed[:, :-1], h_up_ctx, d_ctx)
    # the tail act[:, rf-size:rf] holds times -size..-1, already in slot
    # order (time tau sits in slot tau mod size)
    return ([acts[i][:, rf - s: rf] for i, s in enumerate(sizesF)],
            [acts[len(sizesF) + i][:, rf - s: rf]
             for i, s in enumerate(sizesA)])


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


def _prologue(params: Params, cfg: ModelConfig, x_seed: torch.Tensor,
              h_pad0: torch.Tensor, maxd: int, const_seed: bool,
              quantize: str = "none"):
    """Weight packing and ring priming: (packed, bufF0, bufA0, x0) in the
    kernel's layout.  h_pad0: (B, AUX_PAD) first frame of the kernel's
    aux input."""
    packed = gen_kernel.pack_weights(params, cfg, quantize)
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
                 quantize: str = "none") -> np.ndarray:
    """Generation through the kernel, in chunks of DECODE_CHUNK_FRAMES
    frames with carried state.  Returns (B, n_steps) int32 samples, or
    (n_steps, B, Q) f32 logits in forced mode (x_forced: (B, n_steps))."""
    B = h.shape[0]
    params = params_to(params, device)
    h_pad, d_frames, n_pad_steps = _pallas_host_prep(cfg, h, d, n_steps,
                                                     device)
    packed, bufF, bufA, x0 = _prologue(
        params, cfg, torch.as_tensor(x_seed, dtype=torch.int64,
                                     device=device),
        h_pad[0], maxd, const_seed, quantize)
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
            step_offset=off, quantize=quantize,
            x_forced=None if xf is None else xf[off:off + steps])
        if mode != "forced" and cfg.n_quantize <= 256:
            out = out.to(torch.uint8)  # quarters the device-to-host copy
        pieces.append(out)
        off += steps
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


def check_engine(engine: str, quantize: str) -> None:
    """Raise for an engine or quantization scheme the port does not run."""
    if engine == "xla":
        raise NotImplementedError(_ROADMAP_SCAN)
    if engine not in ("auto", "pallas"):
        raise ValueError("engine should be 'auto', 'pallas' or 'xla'")
    if quantize == "int8_weights":
        raise NotImplementedError(
            "quantize='int8_weights' is the scan engine's scheme, not ported "
            "yet: ROADMAP.md, Queue 1 item 4")
    if quantize not in gen_kernel.QUANTIZE:
        raise ValueError(f"unknown quantize {quantize!r}")


def batch_fast_generate(params: Params, cfg: ModelConfig,
                        x: np.ndarray, h: np.ndarray,
                        n_samples_list: Sequence[int], d: np.ndarray,
                        seed: int = 100, mode: str = "sampling",
                        quantize: str = "none", engine: str = "auto",
                        device="cuda") -> List[np.ndarray]:
    """Batch AR synthesis through the generation kernel.

    x: (B, T_seed) int seed samples (typically one mu-law zero);
    h: (B, F, A) standardized frame-rate aux, zero-padded to the longest
    utterance; n_samples_list: samples per utterance (F_i * up - 1);
    d: (B, F * up) f32 sample-rate dilation factors, constant within frames.
    Returns a list of (n_samples_i,) int32 mu-law sample arrays.

    engine "auto" and "pallas" both run the CUDA kernel (on a CPU device,
    its plain twin), in bf16 or, with quantize="w8a8", int8 weights and
    activations; "xla" and "int8_weights" are not ported yet.  The batch
    runs as one kernel call per chunk, whatever its size.
    """
    device = resolve_device(device)
    check_engine(engine, quantize)
    n_steps = int(max(n_samples_list))
    maxd, x_seed, d_gen = _seed_and_d(cfg, x, d, n_steps)
    if not _frame_constant(d_gen, cfg.upsampling_factor):
        if engine == "pallas":
            raise ValueError(
                "engine='pallas' streams dilation factors at frame rate; "
                "this input varies d within frames, which would silently "
                "change the adaptive look-backs")
        raise NotImplementedError(
            "dilation factors that vary within frames need the scan "
            "engine; " + _ROADMAP_SCAN)
    const_seed = x.shape[1] <= 1
    if not const_seed:
        logging.warning(
            "batch_fast_generate: %d-sample seed history primes with "
            "replicated first-frame aux and d=1 (not the true history "
            "track); outputs near the seed boundary deviate from the "
            "reference's continuation semantics", x.shape[1])
    samples = _pallas_path(params, cfg, x_seed, np.asarray(h, np.float32),
                           d_gen, n_steps, maxd, seed, mode,
                           const_seed=const_seed, device=device,
                           quantize=quantize)
    return [samples[i, :n] for i, n in enumerate(n_samples_list)]


def teacher_forced_logits(params: Params, cfg: ModelConfig,
                          x: np.ndarray, h: np.ndarray,
                          forced: np.ndarray, d: np.ndarray,
                          engine: str = "pallas", quantize: str = "none",
                          device="cuda") -> np.ndarray:
    """Per-step logits of the generation kernel under teacher forcing: the
    same machinery as `batch_fast_generate`, fed the given `forced`
    (B, n_steps) stream instead of its own samples.  Returns
    (B, n_steps, n_quantize) f32; logits[:, i] is the distribution step i
    would have sampled forced[:, i] from."""
    device = resolve_device(device)
    check_engine(engine, quantize)
    n_steps = int(forced.shape[1])
    maxd, x_seed, d_gen = _seed_and_d(cfg, x, d, n_steps)
    out = _pallas_path(params, cfg, x_seed, np.asarray(h, np.float32), d_gen,
                       n_steps, maxd, seed=0, mode="forced",
                       const_seed=x.shape[1] <= 1, device=device,
                       x_forced=forced, quantize=quantize)
    return np.moveaxis(out, 0, 1)


class StreamingGenerator:
    """Chunked low-latency generation with carried ring state, ported from
    the JAX package's `StreamingGenerator`.

    Each `feed()` generates a whole-frame chunk of samples for B streams
    and returns it, carrying the rings and the last two samples across
    calls; ring slots, the upsampler phase and the sampling hash key off
    the absolute sample index, so feeds of any whole-frame lengths continue
    exactly.  The rings are primed from a mid-scale seed history and the
    group's first frame, at the first feed after construction or `reset`.
    The session runs at its own batch B on `device` (CUDA by default; a
    CPU device runs the kernel's plain twin).  The nominal chunk is
    `min_chunk_samples` rounded up to whole frames.
    """

    def __init__(self, params: Params, cfg: ModelConfig, B: int,
                 maxd: int = 32, seed: int = 100, mode: str = "sampling",
                 min_chunk_samples: int = 5500, quantize: str = "none",
                 device="cuda"):
        check_engine("pallas", quantize)
        if mode not in ("sampling", "argmax"):
            raise ValueError("mode should be sampling or argmax")
        self.device = resolve_device(device)
        self.cfg, self.B, self.maxd = cfg, B, maxd
        self.seed, self.mode, self.quantize = seed, mode, quantize
        up = cfg.upsampling_factor
        self.chunk = -(-min_chunk_samples // up) * up
        self.chunk_frames = self.chunk // up
        self._params = params_to(params, self.device)
        self._packed = gen_kernel.pack_weights(self._params, cfg, quantize)
        self._state = None
        self._offset = 0

    def reset(self, seed: int = None) -> None:
        """Start a new group of utterances: drop the carried ring state and
        restart the absolute step counter, keeping the packed weights."""
        if seed is not None:
            self.seed = seed
        self._state = None
        self._offset = 0

    def _prime(self, h_first_frame: np.ndarray) -> None:
        """Rings for a constant mid-scale seed history (the recipe's decode
        seed) and the group's first frame of aux, f32 (B, n_aux)."""
        rf = self.cfg.receptive_field(self.maxd) + 1
        x_seed = torch.full((self.B, rf), self.cfg.n_quantize // 2,
                            dtype=torch.int64, device=self.device)
        h0 = torch.as_tensor(h_first_frame, dtype=torch.float32,
                             device=self.device)
        self._state = _kernel_state(self._params, self.cfg, x_seed, h0,
                                    self.maxd, const_seed=True)

    def feed(self, h_frames: np.ndarray, d_frames: np.ndarray) -> np.ndarray:
        """h_frames: (B, F, n_aux) standardized aux; d_frames: (B, F)
        dilation factors, F >= 1.  Returns (B, F*up) int32 mu-law samples,
        copied to the host (which waits for the card)."""
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
            self._prime(h_frames[:, 0])
        n_steps = F * cfg.upsampling_factor
        samples, *state = gen_kernel.generate(
            self._packed, cfg, *self._state,
            torch.from_numpy(h_pad).to(self.device, torch.bfloat16),
            torch.from_numpy(d_pad).to(self.device), self.seed, B=B,
            maxd=self.maxd, n_steps=n_steps, mode=self.mode,
            step_offset=self._offset, quantize=self.quantize)
        self._state = tuple(state)
        self._offset += n_steps
        return samples[:, 0, :].T.cpu().numpy()
