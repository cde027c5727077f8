#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qpnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each reported on its own line; any failure exits non-zero:
  1. card: nvidia-smi name and power limit, torch's device name;
  2. build: every CUDA source of the port, with nvcc, in parallel;
  3. the generation kernel (K1) against its plain PyTorch twin on the card,
     at the default network's full width (random weights from a seed),
     B=8: forced logits over 4 frames, argmax and sampling agreement,
     sampling determinism, and 2+2-frame chunks against one 4-frame call;
  4. the main path: `batch_fast_generate` at B=20 (the reference decode
     batch) on utterances of 0.5-1.0 s with varying F0, sampling with seed
     100, to int16 wavs; K1 must have been launched;
  5. one K1 call at B=20, maxd 48, 4 frames: equal to its twin, timed
     against the twin and its bound, and profiled by CUDA kernel.
Then one JSON line describing each kernel, and as the last line
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device, and
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12     # dense bf16 tensor-core peak
FS = 22050
FORCED_TOL = 2e-2            # |logit| difference, bf16 storage points
AGREE_MIN = 0.85             # argmax/sampling agreement over 40 samples


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def f0_track(rng, n_frames: int, lo=80.0, hi=300.0, unvoiced=0.1):
    """A smooth random F0 contour in [lo, hi] Hz with unvoiced (0) runs."""
    knots = rng.uniform(lo, hi, size=max(2, n_frames // 40 + 2))
    f0 = np.interp(np.linspace(0, len(knots) - 1, n_frames),
                   np.arange(len(knots)), knots)
    uv = rng.random(n_frames) < unvoiced
    f0[uv] = 0.0
    return f0


def make_inputs(rng, cfg, frames):
    """(x, h, n_samples, d) as the decode CLI builds them: one mu-law zero
    seed, standardized aux, frame-constant d from an F0 track."""
    from qpnet_tpu_torch.ops import dilated_factor
    B, F = len(frames), max(frames)
    up = cfg.upsampling_factor
    h = np.zeros((B, F, cfg.n_aux), np.float32)
    d = np.ones((B, F * up), np.float32)
    for i, f in enumerate(frames):
        h[i, :f] = rng.normal(size=(f, cfg.n_aux))
        d[i, :f * up] = np.repeat(
            dilated_factor(f0_track(rng, f), FS, cfg.dense_factor), up)
    x = np.full((B, 1), cfg.n_quantize // 2, np.int32)
    return x, h, [f * up - 1 for f in frames], d


def cuda_ms(fn, reps: int):
    """(ms per call of fn after a warm-up call, fn's last result)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from qpnet_tpu_torch.bench import card as card_line
        from qpnet_tpu_torch.config import ModelConfig
        from qpnet_tpu_torch.ops import _build
        from qpnet_tpu_torch.ops import gen_kernel as K
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 products must not run in TF32")

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("card", f"{card} | torch {torch.__version__} cuda "
                  f"{torch.version.cuda} | {kind}")
    dev = torch.device("cuda")

    # 2. build every source in parallel (one nvcc each)
    t0 = time.perf_counter()
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as ex:
        libs = list(ex.map(lambda n: _build.build(n, verbose=True), names))
    K.build()
    phase("build", f"{len(libs)} source(s) {names} built in "
                   f"{time.perf_counter() - t0:.2f} s")

    kernels = smoke(ModelConfig(), dev, card)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def smoke(cfg, dev, card, seconds=(0.5, 1.0)):
    """Phases 3-5 on `dev`; returns the kernels' records."""
    import torch
    from scipy.io import wavfile

    from qpnet_tpu_torch import bench
    from qpnet_tpu_torch.models import generate as G
    from qpnet_tpu_torch.models.qpnet import init_params
    from qpnet_tpu_torch.ops import decode_mu_law
    from qpnet_tpu_torch.ops import gen_kernel as K
    up = cfg.upsampling_factor
    params = init_params(0, cfg, device=dev)

    # 3. K1 against its plain twin at full width, B=8, 4 frames
    rng = np.random.default_rng(1)
    B3, F3 = 8, 4
    x, h, _, d = make_inputs(rng, cfg, [F3] * B3)
    maxd, x_seed, d_gen = G._seed_and_d(cfg, x, d, F3 * up)
    h_pad, d_fr, _ = G._pallas_host_prep(cfg, h, d_gen, F3 * up, dev)
    h_pad, d_fr = h_pad[:F3], d_fr[:F3]   # exactly 4 frames
    packed, bufF0, bufA0, x0 = G._prologue(
        params, cfg, torch.as_tensor(x_seed, device=dev), h_pad[0], maxd,
        const_seed=True)
    phase("k1", f"B={B3} maxd bucket {maxd} d in [{d_gen.min():.3f}, "
                f"{d_gen.max():.3f}] rings F{tuple(bufF0.shape)} "
                f"A{tuple(bufA0.shape)}")
    n3 = F3 * up
    xf = torch.as_tensor(rng.integers(0, cfg.n_quantize, (n3, 1, B3)),
                         dtype=torch.int32, device=dev)
    common = (packed, cfg, bufF0, bufA0, x0, h_pad, d_fr, 7)
    kw = dict(B=B3, maxd=maxd, n_steps=n3)
    k_out = K.generate(*common, **kw, mode="forced", x_forced=xf)
    r_out = K.generate_reference(*common, **kw, mode="forced", x_forced=xf)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k_out[0]).all()), "forced logits finite")
    max_err = float((k_out[0] - r_out[0]).abs().max())
    ring_err = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(k_out[1:3], r_out[1:3]))
    phase("k1", f"forced {n3} steps: max |dlogit| {max_err:.3e} "
                f"(tol {FORCED_TOL}), logit scale "
                f"{float(r_out[0].abs().max()):.3f}, ring max |d| "
                f"{ring_err:.3e}, x equal "
                f"{bool(torch.equal(k_out[3], r_out[3]))}")
    check(max_err <= FORCED_TOL, f"forced logits {max_err} > {FORCED_TOL}")
    check(torch.equal(k_out[3], r_out[3]), "forced x state")
    for mode in ("argmax", "sampling"):
        ks = K.generate(*common, **kw, mode=mode)[0][:, 0].T.cpu().numpy()
        rs = K.generate_reference(*common, **kw,
                                  mode=mode)[0][:, 0].T.cpu().numpy()
        agree = float((ks[:, :40] == rs[:, :40]).mean())
        phase("k1", f"{mode}: first sample equal "
                    f"{bool((ks[:, 0] == rs[:, 0]).all())}, 40-sample "
                    f"agreement {agree:.3f}, all-step agreement "
                    f"{float((ks == rs).mean()):.3f}")
        check(bool((ks[:, 0] == rs[:, 0]).all()), f"{mode} first sample")
        check(agree >= AGREE_MIN, f"{mode} agreement {agree}")
    one = K.generate(*common, **kw, mode="sampling")
    again = K.generate(*common, **kw, mode="sampling")
    check(all(torch.equal(a, b) for a, b in zip(one, again)),
          "sampling twice must be bit-identical")
    half = dict(B=B3, maxd=maxd, n_steps=n3 // 2)
    c1 = K.generate(packed, cfg, bufF0, bufA0, x0, h_pad[:2], d_fr[:2], 7,
                    **half, mode="sampling")
    c2 = K.generate(packed, cfg, c1[1], c1[2], c1[3], h_pad[2:], d_fr[2:],
                    7, **half, mode="sampling", step_offset=n3 // 2)
    chunked = torch.cat([c1[0], c2[0]])
    check(torch.equal(chunked, one[0]) and torch.equal(c2[1], one[1])
          and torch.equal(c2[2], one[2]) and torch.equal(c2[3], one[3]),
          "2+2-frame chunks must equal one 4-frame call")
    phase("k1", "sampling deterministic; 2+2-frame chunks bit-identical "
                "to one 4-frame call (samples, bufF, bufA, x)")

    # 4. the main path: batch_fast_generate, B=20, 0.5-1.0 s utterances
    rng = np.random.default_rng(100)
    B = 20
    frames = sorted(int(f) for f in rng.integers(
        int(seconds[0] * FS) // up + 1, int(seconds[1] * FS) // up + 1,
        size=B))
    x, h, n_samples, d = make_inputs(rng, cfg, frames)
    K.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = G.batch_fast_generate(params, cfg, x, h, n_samples, d, seed=100,
                                mode="sampling", device=dev)
    wall = time.perf_counter() - t0
    launches = K.launch_count
    check(launches > 0, "the main path must launch K1")
    with tempfile.TemporaryDirectory() as tmp:
        for i, s in enumerate(out):
            wav = np.clip(decode_mu_law(s, cfg.n_quantize) * 32768,
                          -32768, 32767).astype(np.int16)
            path = os.path.join(tmp, f"utt{i}.wav")
            wavfile.write(path, FS, wav)
            _, back = wavfile.read(path)
            check(len(back) == frames[i] * up - 1,
                  f"utt{i} length {len(back)} != {frames[i] * up - 1}")
            check(back.dtype == np.int16 and int(back.max()) > int(back.min()),
                  f"utt{i} must be non-constant int16")
    total = int(sum(n_samples))
    n_pad_steps = -(-max(n_samples) // (10 * up)) * 10 * up
    phase("main", f"batch_fast_generate B={B} frames {frames[0]}-"
                  f"{frames[-1]} maxd {G.bucket_maxd(float(d.max()))}: "
                  f"{wall:.3f} s wall, {total} samples, "
                  f"{total / wall:.1f} samples/s ({B * n_pad_steps} padded "
                  f"steps x rows, {n_pad_steps} steps), K1 launches "
                  f"{launches} | {card}")

    # 5. one K1 call at the main path's batch and maxd bucket, 4 frames:
    # timed, and held against the twin
    args, maxd = bench.kernel_inputs(params, cfg, B, F3, seed=5)
    packed, _, bufF0, bufA0, x0, h_pad, d_fr, _ = args
    kw = dict(B=B, maxd=maxd, n_steps=n3, mode="sampling")
    ms, k_out = cuda_ms(lambda: K.generate(*args, **kw), reps=3)
    plain_ms, r_out = cuda_ms(lambda: K.generate_reference(*args, **kw),
                              reps=1)
    same = all(torch.equal(a, b) for a, b in zip(k_out, r_out))
    phase("k1", f"B={B} maxd {maxd} sampling {n3} steps: samples, rings "
                f"and x equal to the twin: {same}")
    check(same, f"K1 at B={B} must equal its twin")
    L = len(cfg.dilationsF) + len(cfg.dilationsA)
    R, S, Q = cfg.n_resch, cfg.n_skipch, cfg.n_quantize
    nbytes = sum(t.numel() * t.element_size() for t in packed.values())
    nbytes += 2 * sum(t.numel() * t.element_size()
                      for t in (bufF0, bufA0, x0))
    nbytes += sum(t.numel() * t.element_size() for t in (h_pad, d_fr))
    nbytes += n3 * B * 4
    flops = n3 * 2 * B * (L * (2 * R * 2 * R + R * (S + R)) + S * S + S * Q)
    flops += F3 * 2 * B * L * K.AUX_PAD * 2 * R
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    weights = sum(t.numel() * t.element_size() for t in packed.values())
    phase("time", f"K1 B={B} {n3} steps sampling: {ms:.3f} ms/call, "
                  f"{ms / n3 * 1e3:.2f} us/step, {2 * L + 2} launches/step; "
                  f"plain twin {plain_ms:.3f} ms; bound {bound_ms:.4f} ms by "
                  f"{bound_by} ({nbytes / 1e6:.2f} MB once: {bytes_ms:.4f} "
                  f"ms, {flops / 1e9:.1f} GFLOP: {ops_ms:.4f} ms); weights "
                  f"re-read per step from HBM would take "
                  f"{weights / HBM_BYTES_PER_S * 1e6:.2f} us/step | {card}")
    per_kernel = bench.kernel_us_per_step(args, kw, n3)
    phase("prof", "device time per step by kernel: " + (
        "not measured (the profiler saw no device time)" if per_kernel is None
        else ", ".join(f"{k} {v:.2f} us" for k, v in sorted(
            per_kernel.items(), key=lambda kv: -kv[1]))
        + f", busy {sum(per_kernel.values()):.2f} us") + f" | {card}")
    return [{
        "name": "gen_kernel", "route": "cuda",
        "source": "qpnet_tpu_torch/csrc/gen_kernel.cu",
        "replaces": "qpnet_tpu/ops/gen_kernel.py:649",
        "tpu_kernel": "qpnet_tpu/ops/gen_kernel.py::pallas_generate",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "ms_per_step": ms / n3, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]


if __name__ == "__main__":
    sys.exit(main())
