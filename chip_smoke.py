#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qpnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each reported on its own line; any failure exits non-zero:
  1. card: nvidia-smi name and power limit, torch's device name;
  2. build: every CUDA source of the port, with nvcc, in parallel;
  3. the generation kernel (K1) against its plain PyTorch twin on the card,
     at the default network's full width (random weights from a seed),
     B=8, 4 frames: forced logits of the kernel and of the f32 twin each
     against the twin summed in float64 (the kernel's max |dlogit| at most
     max(2e-2, twice the f32 twin's); argmax agreement with the f32 twin
     >= 0.98), argmax and sampling (first sample equal, 40-sample agreement
     >= 0.85), sampling determinism, and 2+2-frame chunks bit-identical to
     one 4-frame call;
  4. the main path: `batch_fast_generate` at B=20 (the reference decode
     batch) on utterances of 0.5-1.0 s with varying F0, sampling with seed
     100, to int16 wavs; K1 must have been launched;
  5. one K1 call at B=20, maxd 48, 4 frames: forced logits on phase 3's
     f64 gate, then timed against the twin and its bound, with the host
     launches per step and the device time by CUDA kernel and idle share;
  6. the training kernels (K2 forward and backward) against their twins at
     the default network's full width, B=1, T=30030, with an F0 track in
     80-300 Hz: f32 and bf16, fixed layers only and with the adaptive
     layers fused; every output within 1e-4 (f32) or 2e-2 (bf16) of the
     twin's as max |d| / max |ref|, and the fixed-only backward
     bit-identical when repeated;
  7. the training main path: `train_loop` with the kernel engine, f32,
     B=1, windows of the batcher over an in-memory corpus at 22,050 Hz,
     4 steps; both K2 kernels launched, finite losses, checkpoint and loss
     record written and read back; then one step's loss and gradients with
     each engine from the same parameters and batch: losses within 1e-4,
     and each gradient leaf of the kernel engine no farther from the
     plain engine's f64 gradient than max(1e-3, twice the plain f32
     engine's worst leaf), as max |d| / max |ref|;
  8. times: K2 forward and backward per call (f32, bf16) beside their
     twins and bounds, and the training step with each engine;
  9. K1's w8a8 branch and K1-bf16 against their twins at the full width of
     the deep Rd10Rr3Ed4Er1 network (34 layers, random weights from seed
     0), B=7 (its reference decode batch), maxd 48, 2 frames: K1-w8a8's
     forced logits, sampled samples, rings and x equal to its twin's bit
     for bit; K1-bf16 on phase 3's f64 gate and sampling agreement; w8a8
     against bf16 forced logits: relative RMSE < 0.10, argmax agreement >
     0.90; K1-w8a8 bit for bit against its twin at the sessions' B=8;
 10. the serving main path: `StreamingService` on the deep net at w8a8
     (maxd 48, 7 streams, session B=8, 5500-sample chunks after a
     1100-sample first chunk) behind `serve_tcp` on 127.0.0.1, 7
     concurrent `request_stream` clients with 0.5-1.0 s utterances (F0
     80-300 Hz, 10% unvoiced): in argmax mode gathered into one group, each
     stream's PCM equal to one direct `StreamingGenerator`'s; then in
     sampling mode, each stream's time to first audio and realtime factor;
     K1-w8a8 must have been launched;
 11. times: K1 ms/step on the deep net, bf16 and w8a8, at B=7 and B=64,
     beside the bound, the twin, the host launches per step and the device
     time by CUDA kernel and idle share.
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

FS = 22050
# bf16: the kernel's tensor cores sum W_in and W_out in their own order,
# so its forced logits are held to the plain twin summed in float64: their
# max |dlogit| may be at most max(F64_TOL, 2 x the f32 twin's own), and
# their argmax must agree with the f32 twin's on ARGMAX_AGREE_MIN of the
# (step, row) pairs.  w8a8 (exact int32 sums, f64 post-net) equals its
# twin bit for bit.
F64_TOL = 2e-2
ARGMAX_AGREE_MIN = 0.98
AGREE_MIN = 0.85             # argmax/sampling agreement over 40 samples


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def make_inputs(rng, cfg, frames):
    """(x, h, n_samples, d) as the decode CLI builds them: one mu-law zero
    seed, standardized aux, frame-constant d from an F0 track."""
    from qpnet_tpu_torch.bench import f0_track
    from qpnet_tpu_torch.ops import dilated_factor
    B, F = len(frames), max(frames)
    up = cfg.upsampling_factor
    h = np.zeros((B, F, cfg.n_aux), np.float32)
    d = np.ones((B, F * up), np.float32)
    for i, f in enumerate(frames):
        h[i, :f] = rng.normal(size=(f, cfg.n_aux))
        d[i, :f * up] = np.repeat(
            dilated_factor(f0_track(rng, f, unvoiced=0.1), FS,
                           cfg.dense_factor), up)
    x = np.full((B, 1), cfg.n_quantize // 2, np.int32)
    return x, h, [f * up - 1 for f in frames], d


def forced_check(K, common, kw, xf, tag):
    """Forced logits of K1 against its twins on the same inputs; returns
    (max |dlogit| to the yardstick, plain twin ms).  bf16: the kernel and
    the f32 twin each against the twin summed in f64 (the gate above);
    w8a8: logits, rings and x equal to the twin's bit for bit."""
    import torch
    k_out = K.generate(*common, **kw, mode="forced", x_forced=xf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_out = K.generate_reference(*common, **kw, mode="forced", x_forced=xf)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(k_out[0]).all()), f"{tag} forced logits finite")
    check(torch.equal(k_out[3], r_out[3]), f"{tag} forced x state")
    scale = float(r_out[0].abs().max())
    if kw.get("quantize", "none") == "w8a8":
        err = float((k_out[0] - r_out[0]).abs().max())
        same = all(torch.equal(a, b) for a, b in zip(k_out, r_out))
        phase(tag, f"forced {kw['n_steps']} steps: max |dlogit| to the twin "
                   f"{err:.3e} at logit scale {scale:.3f}; logits, rings and "
                   f"x equal bit for bit: {same}")
        check(same, f"{tag} forced run must equal its twin bit for bit")
        return err, twin_ms, k_out[0]
    r64 = K.generate_reference(*common, **kw, mode="forced", x_forced=xf,
                               f64_sums=True)[0]
    err = float((k_out[0] - r64).abs().max())
    twin_err = float((r_out[0] - r64).abs().max())
    agree = float((k_out[0].argmax(-1) == r_out[0].argmax(-1)).float().mean())
    ring_err = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(k_out[1:3], r_out[1:3]))
    tol = max(F64_TOL, 2 * twin_err)
    phase(tag, f"forced {kw['n_steps']} steps: max |dlogit| to the f64 twin "
               f"{err:.3e} (tol {tol:.3e}; the f32 twin's {twin_err:.3e}), "
               f"logit scale {scale:.3f}, argmax agreement with the f32 twin "
               f"{agree:.4f} (min {ARGMAX_AGREE_MIN}), ring max |d| "
               f"{ring_err:.3e}, x equal")
    check(err <= tol, f"{tag} forced logits {err} > {tol} from the f64 twin")
    check(agree >= ARGMAX_AGREE_MIN, f"{tag} argmax agreement {agree}")
    return err, twin_ms, k_out[0]


def sample_check(K, common, kw, tag):
    """Argmax and sampling against the twin: bit for bit in w8a8; in bf16
    the first sample equal and the 40-sample agreement >= AGREE_MIN."""
    import torch
    for mode in ("argmax", "sampling"):
        k_out = K.generate(*common, **kw, mode=mode)
        r_out = K.generate_reference(*common, **kw, mode=mode)
        ks, rs = (o[0][:, 0].T.cpu().numpy() for o in (k_out, r_out))
        agree = float((ks[:, :40] == rs[:, :40]).mean())
        same = all(torch.equal(a, b) for a, b in zip(k_out, r_out))
        phase(tag, f"{mode}: first sample equal "
                   f"{bool((ks[:, 0] == rs[:, 0]).all())}, 40-sample "
                   f"agreement {agree:.3f}, all-step agreement "
                   f"{float((ks == rs).mean()):.3f}, samples, rings and x "
                   f"equal {same}")
        if kw.get("quantize", "none") == "w8a8":
            check(same, f"{tag} {mode} must equal its twin bit for bit")
        check(bool((ks[:, 0] == rs[:, 0]).all()), f"{tag} {mode} first sample")
        check(agree >= AGREE_MIN, f"{tag} {mode} agreement {agree}")


def launch_line(K, cfg, n_steps):
    """The host launches and device kernels per step of one K1 call."""
    h = K.host_launches(cfg, n_steps)
    return (f"host launches {h['host_launches']} per call = "
            f"{h['host_launches'] / n_steps:.4f} per step (1 context kernel "
            f"and 1 graph replay per frame), {h['kernels_per_step']} CUDA "
            f"kernels per step in the graph")


def prof_line(prof):
    """Device time per step by kernel and the device idle share."""
    per_kernel, idle = prof
    if per_kernel is None:
        return "device time by kernel: not measured (the profiler saw none)"
    return ("device us/step by kernel (kernels overlap under programmatic "
            "dependent launch): " + ", ".join(
                f"{k} {v:.2f}" for k, v in sorted(per_kernel.items(),
                                                   key=lambda kv: -kv[1]))
            + f"; device idle share {idle:.4f}")


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
        from qpnet_tpu_torch.ops import train_kernel as TK
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
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
    TK.build()
    phase("build", f"{len(libs)} source(s) {names} built in "
                   f"{time.perf_counter() - t0:.2f} s")

    kernels = smoke(ModelConfig(), dev, card)
    kernels += train_smoke(ModelConfig(), dev, card)
    kernels.insert(1, deep_main(dev, card))
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
    max_err, _, _ = forced_check(K, common, kw, xf, "k1")
    sample_check(K, common, kw, "k1")
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
    # held against the twins in forced mode, then timed and profiled
    args, maxd = bench.kernel_inputs(params, cfg, B, F3, seed=5)
    kw = dict(B=B, maxd=maxd, n_steps=n3)
    xf = torch.as_tensor(rng.integers(0, cfg.n_quantize, (n3, 1, B)),
                         dtype=torch.int32, device=dev)
    max_err, plain_ms, _ = forced_check(K, args, kw, xf, "k1")
    kw["mode"] = "sampling"
    ms, _ = bench.cuda_ms(lambda: K.generate(*args, **kw), reps=3)
    bound_ms, bound_by, mb, gflop, w_us = bench.k1_bound(args, B, n3)
    phase("time", f"K1 B={B} {n3} steps sampling: {ms:.3f} ms/call, "
                  f"{ms / n3 * 1e3:.2f} us/step; {launch_line(K, cfg, n3)}; "
                  f"plain twin (forced) {plain_ms:.3f} ms; bound "
                  f"{bound_ms:.4f} ms by {bound_by} ({mb:.2f} MB once, "
                  f"{gflop:.1f} GFLOP); weights re-read per step from HBM "
                  f"would take {w_us:.2f} us/step | {card}")
    phase("prof", prof_line(bench.kernel_us_per_step(args, kw, n3)) +
          f" | {card}")
    return [{
        "name": "gen_kernel", "route": "cuda",
        "source": "qpnet_tpu_torch/csrc/gen_kernel.cu",
        "replaces": "qpnet_tpu/ops/gen_kernel.py:649",
        "tpu_kernel": "qpnet_tpu/ops/gen_kernel.py::pallas_generate",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "ms_per_step": ms / n3, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]


W8A8_RMSE_MAX, W8A8_AGREE_MIN = 0.10, 0.90     # w8a8 against bf16 logits
DEEP = "Rd10Rr3Ed4Er1"


def deep_smoke(cfg, params, dev, card, B=7, F=2, maxd=48):
    """Phase 9: K1-w8a8 and K1-bf16 against their twins at the deep
    network's full width; returns {quantize: (max |dlogit|, twin ms, args,
    kw)} for the records of phase 11."""
    import torch

    from qpnet_tpu_torch import bench
    from qpnet_tpu_torch.models import generate as G
    from qpnet_tpu_torch.ops import gen_kernel as K
    up, Q = cfg.upsampling_factor, cfg.n_quantize
    rng = np.random.default_rng(9)
    x, h, _, d = make_inputs(rng, cfg, [F] * B)
    n = F * up
    x_seed = np.full((B, cfg.receptive_field(maxd) + 1), Q // 2, np.int32)
    h_pad, d_fr, _ = G._pallas_host_prep(cfg, h, d[:, :n], n, dev)
    xf = torch.as_tensor(rng.integers(0, Q, (n, 1, B)), dtype=torch.int32,
                         device=dev)
    logits, out = {}, {}
    for q in ("w8a8", "none"):
        packed, bufF0, bufA0, x0 = G._prologue(
            params, cfg, torch.as_tensor(x_seed, device=dev), h_pad[0], maxd,
            const_seed=True, quantize=q)
        args = (packed, cfg, bufF0, bufA0, x0, h_pad[:F], d_fr[:F], 7)
        kw = dict(B=B, maxd=maxd, n_steps=n, quantize=q)
        name = "K1-w8a8" if q == "w8a8" else "K1-bf16"
        if q == "w8a8":
            phase("k1deep", f"{DEEP}: {len(cfg.dilationsF)} fixed + "
                            f"{len(cfg.dilationsA)} adaptive layers, B={B} "
                            f"maxd {maxd}, d in [{d[:, :n].min():.3f}, "
                            f"{d[:, :n].max():.3f}], rings "
                            f"F{tuple(bufF0.shape)} A{tuple(bufA0.shape)}")
        err, _, k_logits = forced_check(K, args, kw, xf, f"k1deep {name}")
        logits[q] = k_logits.float()
        k_s = K.generate(*args, **kw, mode="sampling")
        # the twin takes seconds: one call, on the host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_s = K.generate_reference(*args, **kw, mode="sampling")
        torch.cuda.synchronize()
        twin_ms = (time.perf_counter() - t0) * 1e3
        same = all(torch.equal(a, b) for a, b in zip(k_s, r_s))
        ks, rs = (o[0][:, 0].T.cpu().numpy() for o in (k_s, r_s))
        agree = float((ks[:, :40] == rs[:, :40]).mean())
        phase("k1deep", f"{name} sampling {n} steps: samples, rings and x "
                        f"equal to the twin {same}; first sample equal "
                        f"{bool((ks[:, 0] == rs[:, 0]).all())}, 40-sample "
                        f"agreement {agree:.3f} (twin {twin_ms:.1f} ms)")
        if q == "w8a8":
            check(same, f"{name} sampling must equal its twin bit for bit")
        check(bool((ks[:, 0] == rs[:, 0]).all()) and agree >= AGREE_MIN,
              f"{name} sampling: first sample and agreement {agree}")
        out[q] = (err, twin_ms, args, dict(kw, mode="sampling"))
        del k_s, r_s
    ref, qz = logits["none"], logits["w8a8"]
    rel = float((qz - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
    agree = float((qz.argmax(-1) == ref.argmax(-1)).float().mean())
    phase("k1deep", f"w8a8 against bf16 forced logits on the card: relative "
                    f"RMSE {rel:.4f} (max {W8A8_RMSE_MAX}), argmax agreement "
                    f"{agree:.4f} (min {W8A8_AGREE_MIN})")
    check(rel < W8A8_RMSE_MAX, f"w8a8 relative RMSE {rel}")
    check(agree > W8A8_AGREE_MIN, f"w8a8 argmax agreement {agree}")
    # the serving sessions' own batch (7 streams padded to 8), 2 frames
    args8, maxd8 = bench.kernel_inputs(params, cfg, 8, 2, seed=10,
                                       quantize="w8a8")
    kw8 = dict(B=8, maxd=maxd8, n_steps=2 * up, mode="sampling",
               quantize="w8a8")
    same = all(torch.equal(a, b) for a, b in zip(
        K.generate(*args8, **kw8), K.generate_reference(*args8, **kw8)))
    phase("k1deep", f"K1-w8a8 at the sessions' B=8, maxd {maxd8}, "
                    f"{2 * up} steps: equal to the twin {same}")
    check(same, "K1-w8a8 at B=8 must equal its twin")
    return out


def deep_main(dev, card):
    """Phases 9-11 on the deep network; returns K1-w8a8's record."""
    import torch

    from qpnet_tpu_torch.config import ModelConfig
    from qpnet_tpu_torch.models.qpnet import count_params, init_params
    cfg = ModelConfig.from_network_name(DEEP)
    params = init_params(0, cfg, device=dev)
    phase("k1deep", f"{DEEP}: {count_params(params):,} parameters, random "
                    f"from seed 0")
    deep = deep_smoke(cfg, params, dev, card)
    launches = serve_smoke(cfg, params, dev, card)
    call_ms = deep_times(cfg, params, card, deep)
    err, twin_ms, _, kw = deep["w8a8"]
    ms, bound_ms, bound_by = call_ms["w8a8"]
    del deep, params
    torch.cuda.empty_cache()
    return {
        "name": "gen_kernel_w8a8", "route": "cuda",
        "source": "qpnet_tpu_torch/csrc/gen_kernel.cu",
        "replaces": "qpnet_tpu/ops/gen_kernel.py:304",
        "tpu_kernel": "qpnet_tpu/ops/gen_kernel.py::pallas_generate "
                      "(quantize='w8a8', mmq)",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "ms_per_step": ms / kw["n_steps"], "plain_ms": twin_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "network": DEEP, "B": kw["B"], "bf16_ms": call_ms["none"][0]}


def serve_smoke(cfg, params, dev, card, n_streams=7, maxd=48,
                seconds=(0.5, 1.0)):
    """Phase 10, the serving main path: `StreamingService` on the deep net
    at w8a8 behind `serve_tcp`, `n_streams` concurrent `request_stream`
    clients; returns the K1-w8a8 launches of the service runs."""
    import threading

    import torch

    from qpnet_tpu_torch import serve as S
    from qpnet_tpu_torch.bench import f0_track
    from qpnet_tpu_torch.models.generate import StreamingGenerator
    from qpnet_tpu_torch.ops import decode_mu_law, dilated_factor
    from qpnet_tpu_torch.ops import gen_kernel as K
    up = cfg.upsampling_factor
    rng = np.random.default_rng(10)
    frames = [int(f) for f in rng.integers(int(seconds[0] * FS) // up + 1,
                                           int(seconds[1] * FS) // up + 1,
                                           size=n_streams)]
    utts = [(rng.normal(size=(f, cfg.n_aux)).astype(np.float32),
             dilated_factor(f0_track(rng, f, unvoiced=0.1), FS,
                            cfg.dense_factor).astype(np.float32))
            for f in frames]
    kw = dict(max_streams=n_streams, maxd=maxd, min_chunk_samples=5500,
              first_chunk_samples=1100, quantize="w8a8", devices=[dev])

    def serve(mode, **gather):
        """(per-stream (pcm, seconds to first audio, wall seconds), service
        stats, K1-w8a8 launches) of one burst of TCP clients."""
        K.reset_launch_count()
        svc = S.StreamingService(params, cfg, mode=mode, **gather, **kw)
        svc.prewarm([n_streams])
        srv = S.serve_tcp(svc, port=0)
        results = [None] * n_streams
        errors = []

        def client(i):
            try:
                t0 = time.perf_counter()
                first, chunks = None, []
                for c in S.request_stream(srv.server_address, *utts[i]):
                    if first is None:
                        first = time.perf_counter() - t0
                    chunks.append(c)
                results[i] = (np.concatenate(chunks), first,
                              time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"stream {i}: {e!r}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_streams)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        finally:
            srv.shutdown()
            srv.server_close()
            svc.close()
        check(not errors and all(not t.is_alive() for t in threads),
              f"{mode} streams: {errors}")
        return results, dict(svc.stats), K.w8a8_launch_count

    # argmax, gathered into one group: each stream equals one direct session
    # fed the group's padded conditioning (rows are independent in argmax)
    res, stats, launches = serve("argmax", gather_window_s=60.0,
                                 gather_quiet_s=30.0)
    check(stats["groups"] == 1, f"the {n_streams} streams must form one "
                                f"group, got {stats}")
    F_max = max(frames)
    B = 1 << (n_streams - 1).bit_length()
    h = np.zeros((B, F_max, cfg.n_aux), np.float32)
    d = np.ones((B, F_max), np.float32)
    for i, (hi, di) in enumerate(utts):
        h[i], d[i] = hi[-1], di[-1]
        h[i, :len(hi)], d[i, :len(di)] = hi, di
    direct = StreamingGenerator(params, cfg, B, maxd=maxd, mode="argmax",
                                quantize="w8a8", device=dev).feed(h, d)
    equal = []
    for i, (f, (got, _, _)) in enumerate(zip(frames, res)):
        want = np.clip(decode_mu_law(direct[i, :f * up], cfg.n_quantize)
                       * 32768, -32768, 32767).astype(np.int16)
        equal.append(got.dtype == np.int16 and np.array_equal(got, want))
    phase("serve", f"{DEEP} w8a8 argmax, {n_streams} TCP streams of "
                   f"{min(frames)}-{max(frames)} frames in one group "
                   f"(session B={B}, maxd {maxd}, {stats['feeds']} feeds): "
                   f"PCM equal to one direct StreamingGenerator: "
                   f"{sum(equal)}/{n_streams}, K1-w8a8 launches {launches}")
    check(all(equal), "served argmax PCM must equal the direct generator's")
    check(launches > 0, "the serving path must launch K1-w8a8")
    total = launches

    # sampling: what a client sees
    res, stats, launches = serve("sampling", gather_window_s=0.25)
    total += launches
    check(launches > 0, "the serving path must launch K1-w8a8")
    ttfa = [r[1] for r in res]
    rtf = [f * up / FS / r[2] for f, r in zip(frames, res)]
    for f, (pcm, _, _) in zip(frames, res):
        check(pcm.shape == (f * up,) and int(pcm.max()) > int(pcm.min()),
              "sampled streams must be non-constant PCM of their length")
    phase("serve", f"{DEEP} w8a8 sampling, {n_streams} TCP streams, "
                   f"{stats['groups']} group(s), {stats['feeds']} feeds: "
                   f"time to first audio s "
                   f"{[round(t, 4) for t in ttfa]} (median "
                   f"{float(np.median(ttfa)):.4f}), realtime factor per "
                   f"stream {[round(r, 4) for r in rtf]} (median "
                   f"{float(np.median(rtf)):.4f}), K1-w8a8 launches "
                   f"{launches} | {card}")
    torch.cuda.empty_cache()
    return total


def deep_times(cfg, params, card, deep):
    """Phase 11: K1 ms/step on the deep net, bf16 and w8a8, at B=7 and
    B=64, beside the bound, the twin (B=7, from phase 9) and the device
    time by CUDA kernel; returns {quantize: ms per phase 9 call}."""
    from qpnet_tpu_torch import bench
    from qpnet_tpu_torch.ops import gen_kernel as K
    up = cfg.upsampling_factor
    call_ms = {}
    for q in ("none", "w8a8"):
        for B in (deep[q][3]["B"], 64):
            if B != 64:
                args, kw = deep[q][2], deep[q][3]
            else:
                args, maxd = bench.kernel_inputs(params, cfg, B, 4, seed=11,
                                                 quantize=q)
                kw = dict(B=B, maxd=maxd, n_steps=4 * up, mode="sampling",
                          quantize=q)
            n = kw["n_steps"]
            ms, _ = bench.cuda_ms(lambda: K.generate(*args, **kw))
            bound_ms, bound_by, mb, gflop, w_us = bench.k1_bound(args, B, n, q)
            twin = (f"plain twin {deep[q][1] / n:.3f} ms/step"
                    if B != 64 else "plain twin not timed at this batch")
            phase("time", f"K1-{'w8a8' if q == 'w8a8' else 'bf16'} {DEEP} "
                          f"B={B} maxd {kw['maxd']} {n} steps: "
                          f"{ms / n * 1e3:.2f} us/step ({ms:.3f} ms/call); "
                          f"{twin}; bound {bound_ms / n * 1e3:.4f} us/step by "
                          f"{bound_by} ({mb:.2f} MB once, {gflop:.1f} GFLOP "
                          f"per call); weights once per step {w_us:.2f} us; "
                          f"{launch_line(K, cfg, n)}; "
                          f"{prof_line(bench.kernel_us_per_step(args, kw, n))}"
                          f" | {card}")
            if B != 64:
                call_ms[q] = (ms, bound_ms, bound_by)
            del args
    return call_ms


K2_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # max |d| / max |ref|
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-4, 1e-3       # engine against engine


def tree_names(tree, prefix=""):
    """The tree with each leaf replaced by its path, e.g. /fixed/0/W_skip."""
    if isinstance(tree, dict):
        return {k: tree_names(v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_names(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return prefix


def rel_err(a, b):
    """(max |a - b| / max |b|, max |a - b|)."""
    d = float((a.float() - b.float()).abs().max())
    return d / max(float(b.float().abs().max()), 1e-30), d


def memory_corpus(cfg, seed, n_utts=3, seconds=(2.0, 3.0)):
    """In-memory utterances (fs, x, h) at 22,050 Hz: a pitched tone whose
    F0 (continuous, 80-300 Hz) is the aux's F0 column, random spectral
    dims, and the scaler of their frames (uv dim pinned to 0/1)."""
    from qpnet_tpu_torch.bench import f0_track
    from qpnet_tpu_torch.data.stats import Scaler
    rng = np.random.default_rng(seed)
    up = cfg.upsampling_factor
    utts = []
    for _ in range(n_utts):
        F = int(rng.uniform(*seconds) * FS) // up
        f0 = f0_track(rng, F)
        phase_ = np.cumsum(2 * np.pi * np.repeat(f0, up) / FS)
        x = 0.4 * np.sin(phase_) + 0.02 * rng.normal(size=F * up)
        h = rng.normal(size=(F, cfg.n_aux))
        h[:, 0], h[:, 1] = 1.0, f0
        utts.append((FS, x.astype(np.float32), h))
    frames = np.concatenate([u[2] for u in utts])
    mean, scale = frames.mean(0), frames.std(0)
    mean[0], scale[0] = 0.0, 1.0
    return utts, Scaler(mean, scale)


def train_smoke(cfg, dev, card, T=30030, steps=4, max_length=30000,
                batch_length=20000):
    """Phases 6-8 on `dev`; returns the K2 kernels' records."""
    import torch

    from qpnet_tpu_torch import bench
    from qpnet_tpu_torch.config import TrainConfig
    from qpnet_tpu_torch.data import batcher as DB
    from qpnet_tpu_torch.models.qpnet import init_params, tree_map
    from qpnet_tpu_torch.ops import train_kernel as TK
    from qpnet_tpu_torch.train import step as TS
    from qpnet_tpu_torch.train import trainer as TT
    from qpnet_tpu_torch.train.checkpoint import load_checkpoint
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    params = init_params(0, cfg, device=dev)

    # 6. K2 against its twins at full width
    batch = bench.train_batch(cfg, 1, T, seed=6, valid_len=batch_length)
    errs, twin_ms = {}, {}
    for dtype in (f32, bf16):
        dname = "float32" if dtype == f32 else "bfloat16"
        for fused in (False, True):
            static, W, o0, h, d = bench.stack_inputs(params, cfg, batch,
                                                     dtype, fused)
            tag = f"{dname} {'fused' if fused else 'fixed'}"
            k_out = TK.stack_forward(static, dtype, W, o0, h, d)
            gen = torch.Generator(device=dev).manual_seed(7)
            do = torch.randn(k_out[0].shape, generator=gen, device=dev)
            dsk = torch.randn(k_out[1].shape, generator=gen, device=dev)
            k_b = TK.stack_backward(static, dtype, W, k_out[2], k_out[3], h,
                                    d, do, dsk)
            # the twins take seconds: one call each, on the host clock
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r_out = TK.fixed_stack_reference_fwd(static, dtype, W, o0, h, d)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r_b = TK.fixed_stack_reference_bwd(static, dtype, W, k_out[2],
                                               k_out[3], h, d, do, dsk)
            torch.cuda.synchronize()
            twin_ms[(dname, fused)] = ((t1 - t0) * 1e3,
                                       (time.perf_counter() - t1) * 1e3)
            names = ["o_out", "skip", "oall", "st"]
            pairs = list(zip(k_out, r_out))
            names += ["do0", "dh"] + [f"d{k}" for k in TK._WEIGHT_KEYS]
            pairs += [(k_b[0], r_b[0]), (k_b[1], r_b[1])] + [
                (k_b[2][k], r_b[2][k]) for k in TK._WEIGHT_KEYS]
            res = {n: rel_err(a, b) for n, (a, b) in zip(names, pairs)}
            for n, (a, _) in zip(names, pairs):
                check(bool(torch.isfinite(a).all()), f"K2 {tag} {n} finite")
            worst = max(res, key=lambda n: res[n][0])
            phase("k2", f"{tag} maxd {static[2]}: worst {worst} "
                        f"{res[worst][0]:.3e} (tol {K2_TOL[dname]}); "
                        + ", ".join(f"{n} {v[0]:.1e}" for n, v in res.items()))
            check(res[worst][0] <= K2_TOL[dname],
                  f"K2 {tag} {worst} {res[worst][0]} > {K2_TOL[dname]}")
            if not fused:
                again = TK.stack_backward(static, dtype, W, k_out[2],
                                          k_out[3], h, d, do, dsk)
                same = all(torch.equal(a, b) for a, b in
                           zip(k_b[:2] + tuple(k_b[2].values()),
                               again[:2] + tuple(again[2].values())))
                phase("k2", f"{tag} backward twice bit-identical: {same}")
                check(same, f"K2 {tag} backward must be deterministic")
                del again
            fwd_err = max(v[1] for n, v in res.items() if n in names[:4])
            bwd_err = max(v[1] for n, v in res.items() if n not in names[:4])
            errs[(dname, fused)] = (fwd_err, bwd_err)
            del k_out, r_out, k_b, r_b, pairs
    torch.cuda.empty_cache()

    # 7. the training main path: train_loop through the kernels
    utts, scaler = memory_corpus(cfg, seed=7)
    tcfg = TrainConfig(lr=1e-4, iters=steps, checkpoint_interval=steps,
                       intervals=1, batch_length=batch_length,
                       max_length=max_length, batch_size=1, seed=1,
                       fixed_engine="pallas")

    def batches():
        return DB.window_batches(
            DB.utterance_stream(utts, lambda u: u, seed=1), cfg,
            feat_transform=scaler.transform, batch_length=batch_length,
            batch_size=1, max_length=max_length)

    with tempfile.TemporaryDirectory() as expdir:
        TK.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = TT.train_loop(cfg, tcfg, batches(), expdir, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (TK.fwd_launch_count, TK.bwd_launch_count)
        check(min(launches) > 0, f"the main path must launch both K2 "
                                 f"kernels, got {launches}")
        losses = TT.read_loss_record(os.path.join(expdir, "loss-final.yml"))
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"losses {losses}")
        final = load_checkpoint(os.path.join(expdir, "checkpoint-final.pkl"))
        ckpt = load_checkpoint(os.path.join(expdir,
                                            f"checkpoint-{steps}.pkl"))
        mine = [p.detach().cpu().numpy() for p in
                TS.tree_leaves(state.params)]
        for tree in (final["model"], ckpt["model"]):
            check(all(np.array_equal(a, b) for a, b in
                      zip(TS.tree_leaves(tree), mine)),
                  "checkpoints must reload equal to the trained params")
        check(ckpt["iterations"] == steps
              and ckpt["optimizer"]["count"] == steps, "checkpoint state")
        b_np = next(batches())
    phase("main", f"train_loop, kernel engine, f32, B=1, T={T}, "
                  f"{steps} steps: losses {[round(x, 6) for x in losses]}, "
                  f"{wall:.3f} s wall (build and checkpoints included), K2 "
                  f"launches fwd {launches[0]} bwd {launches[1]}; "
                  f"checkpoint-final.pkl and checkpoint-{steps}.pkl reload "
                  f"equal | {card}")
    b_np.pop("window_lens")
    b = TS.batch_to_device(b_np, dev)
    # one step's loss and gradients with each engine, and with the plain
    # engine in f64: the weight gradients are cancelling sums over all T
    # rows, whose f32 rounding alone moves either engine by 1e-3 to 5e-3
    # of a leaf's scale, so the f64 gradient is the yardstick
    losses, grads = {}, {}
    for engine, dtype in (("xla", f32), ("pallas", f32), ("f64", f64)):
        p = tree_map(lambda t: t.detach().to(dtype).requires_grad_(),
                     state.params)
        loss = TS._loss_fn(p, cfg, b, dtype, False,
                           "xla" if engine == "f64" else engine)
        loss.backward()
        losses[engine] = float(loss.detach())
        grads[engine] = [torch.zeros_like(x) if x.grad is None
                         else x.grad.double() for x in TS.tree_leaves(p)]
    loss_rel = abs(losses["pallas"] - losses["xla"]) / abs(losses["xla"])
    names = TS.tree_leaves(tree_names(state.params))
    rows = []
    for n, gp, gx, gt in zip(names, grads["pallas"], grads["xla"],
                             grads["f64"]):
        rows.append((rel_err(gp, gx)[0], rel_err(gp, gt)[0],
                     rel_err(gx, gt)[0], n))
    worst = max(rows)
    worst_x = max(r[2] for r in rows)
    bad = [r for r in rows if r[1] > max(STEP_GRAD_TOL, 2 * worst_x)]
    phase("main", f"one step from the trained params: loss xla "
                  f"{losses['xla']:.7f} pallas {losses['pallas']:.7f} f64 "
                  f"{losses['f64']:.7f} (engines rel {loss_rel:.2e}, tol "
                  f"{STEP_LOSS_TOL}); gradient leaves, max |d| / max |ref|: "
                  f"worst pallas-vs-xla {worst[3]} {worst[0]:.2e} (against "
                  f"f64: pallas {worst[1]:.2e}, xla {worst[2]:.2e}); worst "
                  f"pallas-vs-f64 {max(r[1] for r in rows):.2e}, worst "
                  f"xla-vs-f64 {worst_x:.2e}; leaves where pallas is "
                  f"farther from f64 than max({STEP_GRAD_TOL}, 2 x xla's "
                  f"worst): {len(bad)}")
    check(loss_rel <= STEP_LOSS_TOL, f"engine losses differ by {loss_rel}")
    check(not bad, f"kernel-engine gradients off the f64 gradient: {bad}")
    del grads, state
    torch.cuda.empty_cache()

    # 8. times at the main path's variant (fixed layers only), f32 and bf16
    times = {}
    for dtype in (f32, bf16):
        dname = "float32" if dtype == f32 else "bfloat16"
        static, W, o0, h, d = bench.stack_inputs(params, cfg, batch, dtype,
                                                 False)
        f_ms, out = bench.cuda_ms(
            lambda: TK.stack_forward(static, dtype, W, o0, h, d))
        gen = torch.Generator(device=dev).manual_seed(8)
        do = torch.randn(out[0].shape, generator=gen, device=dev)
        dsk = torch.randn(out[1].shape, generator=gen, device=dev)
        b_ms, _ = bench.cuda_ms(lambda: TK.stack_backward(
            static, dtype, W, out[2], out[3], h, d, do, dsk))
        fp_ms, bp_ms = twin_ms[(dname, False)]
        bounds = bench.stack_bounds(static, 1, T, dtype)
        steps_ms = {e: bench.train_step_ms(params, cfg, b_np, e, dtype)[0]
                    for e in ("xla", "pallas")}
        times[dname] = (f_ms, b_ms, fp_ms, bp_ms, bounds, steps_ms)
        phase("time", f"K2 {dname} B=1 T={T} {len(static[0])} layers: fwd "
                      f"{f_ms:.3f} ms ({bounds['fwd'][2] / f_ms / 1e9:.2f} "
                      f"TFLOP/s; twin {fp_ms:.3f} ms; bound "
                      f"{bounds['fwd'][0]:.4f} ms by {bounds['fwd'][1]}), "
                      f"bwd {b_ms:.3f} ms "
                      f"({bounds['bwd'][2] / b_ms / 1e9:.2f} TFLOP/s; twin "
                      f"{bp_ms:.3f} ms; bound {bounds['bwd'][0]:.4f} ms by "
                      f"{bounds['bwd'][1]}); train step xla "
                      f"{steps_ms['xla']:.3f} ms, pallas "
                      f"{steps_ms['pallas']:.3f} ms | {card}")
        del out
    f_ms, b_ms, fp_ms, bp_ms, bounds, steps_ms = times["float32"]
    common = {"route": "cuda", "source": "qpnet_tpu_torch/csrc/train_kernel.cu",
              "library_ms": None}
    return [
        dict(name="train_kernel_fwd", **common,
             replaces="qpnet_tpu/ops/train_kernel.py:195",
             tpu_kernel="qpnet_tpu/ops/train_kernel.py::_fwd_call",
             launches=launches[0], max_abs_err=errs[("float32", False)][0],
             ms=f_ms, plain_ms=fp_ms, bound_ms=bounds["fwd"][0],
             bound_by=bounds["fwd"][1], bf16_ms=times["bfloat16"][0],
             train_step_ms=steps_ms),
        dict(name="train_kernel_bwd", **common,
             replaces="qpnet_tpu/ops/train_kernel.py:431",
             tpu_kernel="qpnet_tpu/ops/train_kernel.py::_bwd_call",
             launches=launches[1], max_abs_err=errs[("float32", False)][1],
             ms=b_ms, plain_ms=bp_ms, bound_ms=bounds["bwd"][0],
             bound_by=bounds["bwd"][1], bf16_ms=times["bfloat16"][1],
             train_step_ms=steps_ms)]


if __name__ == "__main__":
    sys.exit(main())
