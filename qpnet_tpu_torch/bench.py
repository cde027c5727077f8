"""Time the port's kernels on the card.

    python -m qpnet_tpu_torch.bench --batch 1 8 20 64 --frames 4
    python -m qpnet_tpu_torch.bench --network Rd10Rr3Ed4Er1 --quantize w8a8
    python -m qpnet_tpu_torch.bench --train

Decode (default): for each batch, one K1 call over `frames` frames of the
named network (random weights from a seed, sampling mode, frame-constant d
from an 80 Hz F0, maxd bucket 48), bf16 or w8a8, timed with CUDA events
after a warm-up call, beside its bound (`k1_bound`), then the device time of
each of the kernel's CUDA kernels and the device idle share over one more
call, from torch.profiler, and the host launches of a call (one context
kernel and one graph replay per frame).

--train: at B=1, T=30030 (the reference training window), for f32 and
bf16: the K2 forward and backward ms per call (fixed layers only, and with
the adaptive layers fused), their bounds, and the ms of a whole training
step with each engine (xla: the plain PyTorch engine; pallas: the kernels).

Prints one JSON line per measurement with the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models import generate as G
from qpnet_tpu_torch.models.qpnet import init_params
from qpnet_tpu_torch.ops import dilated_factor
from qpnet_tpu_torch.ops import gen_kernel as K

# K1's CUDA kernels by name, each with the profiler's name for it (spaces
# removed); prod_kernel<P, Q8>: P 0 gate, 1 out, 2 post-net 1, 3 post-net 2
KERNELS = {"embed": "embed_kernel", "gate": "prod_kernel<0,false>",
           "gate_q": "prod_kernel<0,true>", "out": "prod_kernel<1,false>",
           "out_q": "prod_kernel<1,true>", "post1": "prod_kernel<2,false>",
           "post2": "prod_kernel<3,false>", "sample": "sample_kernel",
           "set_ctx": "set_ctx_kernel", "advance": "advance_kernel"}


def card() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


# sampling rate, and the constant F0 of every row: 80 Hz, the lowest of a
# decode's usual range, puts d = 34.5 in the maxd bucket 48
FS, F0 = 22050, 80.0


def kernel_inputs(params, cfg, B, frames, seed=0, quantize="none"):
    """((packed, cfg, bufF0, bufA0, x0, h_frames, d_frames, seed), maxd) for
    one K1 call of `frames` frames on the parameters' device, with the
    weights packed for `quantize`."""
    rng = np.random.default_rng(seed)
    up = cfg.upsampling_factor
    dev = params["up_w"].device
    h = rng.normal(size=(B, frames, cfg.n_aux)).astype(np.float32)
    d = np.full((B, frames * up),
                dilated_factor(np.array([F0]), FS, cfg.dense_factor)[0],
                np.float32)
    x = np.full((B, 1), cfg.n_quantize // 2, np.int32)
    maxd, x_seed, d_gen = G._seed_and_d(cfg, x, d, frames * up)
    h_pad, d_fr, _ = G._pallas_host_prep(cfg, h, d_gen, frames * up, dev)
    packed, bufF0, bufA0, x0 = G._prologue(
        params, cfg, torch.as_tensor(x_seed, device=dev), h_pad[0], maxd,
        const_seed=True, quantize=quantize)
    return (packed, cfg, bufF0, bufA0, x0, h_pad[:frames], d_fr[:frames],
            seed), maxd


def k1_bound(args, B, n_steps, quantize="none"):
    """(bound_ms, bound_by, MB, GFLOP, weights_us_per_step) of one K1 call
    with `args` (as `kernel_inputs` returns them): its inputs read once and
    its outputs (samples, state) written once over the HBM rate, against
    its products at the card's peak for their type (int8 for the w8a8
    W_in/W_out products, bf16 for the rest); and the time to read the
    packed weights once, which a step that keeps none of them on chip pays
    every step."""
    packed, cfg, bufF0, bufA0, x0, h_pad, d_fr, _ = args
    L = len(cfg.dilationsF) + len(cfg.dilationsA)
    R, S, Q = cfg.n_resch, cfg.n_skipch, cfg.n_quantize
    weights = sum(t.numel() * t.element_size() for t in packed.values())
    nbytes = weights + 2 * sum(t.numel() * t.element_size()
                               for t in (bufF0, bufA0, x0))
    nbytes += sum(t.numel() * t.element_size() for t in (h_pad, d_fr))
    nbytes += n_steps * B * 4
    main = n_steps * 2 * B * L * (2 * R * 2 * R + R * (S + R))
    rest = n_steps * 2 * B * (S * S + S * Q)
    rest += h_pad.shape[0] * 2 * B * L * K.AUX_PAD * 2 * R
    ops_s = (main / (INT8_OP_PER_S if quantize == "w8a8" else BF16_FLOP_PER_S)
             + rest / BF16_FLOP_PER_S)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", nbytes / 1e6,
            (main + rest) / 1e9, weights / HBM_BYTES_PER_S * 1e6)


def kernel_us_per_step(args, kw, n_steps):
    """(device us per step of each of K1's CUDA kernels, device idle share)
    over one K1 call, from torch.profiler's trace; (None, None) where the
    profiler saw no kernel.  Under programmatic dependent launch a kernel
    starts while the one before it finishes and waits for it on the card,
    so the kernels' times add up to more than the step; the idle share is
    the part of the call's device span that no kernel covers."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        K.generate(*args, **kw)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    out, spans = {}, []
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") != "kernel" or ev.get("ph") != "X":
            continue
        key = ev["name"].replace(" ", "")
        name = next((n for n, k in KERNELS.items() if k in key), None)
        if name is None:
            continue
        out[name] = out.get(name, 0.0) + float(ev["dur"]) / n_steps
        spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    if not spans:
        return None, None
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    span = max(b for _, b in spans) - spans[0][0]
    return out, 1.0 - busy / span


def step_ms(args, kw, reps=3) -> float:
    K.generate(*args, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        K.generate(*args, **kw)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps / kw["n_steps"]


# ---------------------------------------------------------------------------
# the training kernel (K2)
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12      # f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12     # dense bf16 tensor-core peak
INT8_OP_PER_S = 1979e12      # dense int8 tensor-core peak


def f0_track(rng, n_frames: int, lo=80.0, hi=300.0, unvoiced=0.0):
    """A smooth random F0 contour in [lo, hi] Hz, with unvoiced (0) frames
    at the given rate."""
    knots = rng.uniform(lo, hi, size=max(2, n_frames // 40 + 2))
    f0 = np.interp(np.linspace(0, len(knots) - 1, n_frames),
                   np.arange(len(knots)), knots)
    f0[rng.random(n_frames) < unvoiced] = 0.0
    return f0


def train_batch(cfg, B, T, seed, valid_len=20000):
    """A numpy batch in the batcher's layout: random classes and aux, d
    from an F0 track in 80-300 Hz (frame-constant)."""
    rng = np.random.default_rng(seed)
    up, F = cfg.upsampling_factor, T // cfg.upsampling_factor
    d = np.stack([dilated_factor(f0_track(rng, F), FS, cfg.dense_factor)
                  for _ in range(B)])
    return {
        "x": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
        "h": rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32),
        "t": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
        "d": np.repeat(d, up, axis=1).astype(np.float32),
        "valid_len": np.int32(min(valid_len, T)),
    }


def stack_inputs(params, cfg, batch, dtype, fused):
    """(static, weights, o0, h_pad, d_frames) of the K2 call that
    `forward(fixed_engine="pallas")` makes on `batch`, on the params'
    device, with the weights detached."""
    from qpnet_tpu_torch.models import qpnet as Q
    from qpnet_tpu_torch.ops import train_kernel as TK
    dev = params["up_w"].device
    up = cfg.upsampling_factor
    x = torch.as_tensor(batch["x"], device=dev)
    h = torch.as_tensor(batch["h"], device=dev)
    d = torch.as_tensor(batch["d"], device=dev)
    with torch.no_grad():
        o0 = Q.embed(params, x).to(dtype)
        h_up = Q.upsample_aux(params, h, up).to(dtype)
        h_pad = torch.nn.functional.pad(h_up, (0, TK.AUX_PAD - cfg.n_aux))
        layers = list(params["fixed"]) + (list(params["adaptive"])
                                          if fused else [])
        W = TK.stack_weights(layers, cfg.n_aux)
    maxd = G.bucket_maxd(float(np.ceil(batch["d"].max())))
    static = (tuple(cfg.dilationsF),
              tuple(cfg.dilationsA) if fused else (), maxd if fused else 1,
              up, cfg.n_resch, cfg.n_skipch)
    d_frames = d[:, ::up].float().contiguous() if fused else None
    return static, W, o0, h_pad, d_frames


def stack_bounds(static, B, T, dtype):
    """{"fwd": (bound_ms, bound_by, flops, bytes), "bwd": (...)} of one K2
    call: each input read once and each output written once over the HBM
    rate, against its products at the card's peak for the type (f32
    outside the tensor cores, bf16 dense tensor cores)."""
    dilsF, dilsA, _, _, R, S = static
    L, M = len(dilsF) + len(dilsA), B * T
    K1 = 2 * R + 48
    e = 2 if dtype == torch.bfloat16 else 4
    weights = L * (K1 * 2 * R + R * (S + R)) * e
    flops = 2 * M * L * (K1 * 2 * R + R * (S + R))
    d_bytes = 4 * B * (-(-T // static[3])) if dilsA else 0
    act = M * R * e
    fwd_bytes = (act + M * 48 * e + d_bytes + weights + L * 3 * R * 4
                 + act + M * S * 4 + L * act + 2 * L * act)
    bwd_bytes = (M * R * 4 + M * S * 4 + L * act + 2 * L * act + M * 48 * e
                 + d_bytes + weights + M * R * 4 + M * 48 * 4
                 + L * (K1 * 2 * R + 2 * R + R * (S + R) + R) * 4)
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    out = {}
    for name, fl, nb in (("fwd", flops, fwd_bytes),
                         ("bwd", 2 * flops, bwd_bytes)):
        b_ms, o_ms = nb / HBM_BYTES_PER_S * 1e3, fl / rate * 1e3
        out[name] = (max(b_ms, o_ms), "bytes" if b_ms >= o_ms
                     else "operations", fl, nb)
    return out


def cuda_ms(fn, reps: int = 3):
    """(ms per call of fn after a warm-up call, fn's last result), from
    CUDA events."""
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


def train_step_ms(params, cfg, batch, engine, dtype, steps=2):
    """ms per `make_train_step` step (host clock to a synchronize, after a
    warm-up step) of a copy of `params` with a fresh Adam."""
    import time

    from qpnet_tpu_torch.data.batcher import padded_shape
    from qpnet_tpu_torch.models.qpnet import tree_map
    from qpnet_tpu_torch.train import step as TS
    p = tree_map(lambda t: t.detach().clone(), params)
    tx = TS.make_optimizer()
    state = TS.TrainState(p, tx.init(p), 0)
    B, T = batch["x"].shape
    remat = B * padded_shape(T, cfg.upsampling_factor) > (
        130_000 if dtype == torch.float32 else 260_000)
    step = TS.make_train_step(cfg, tx, compute_dtype=dtype, remat=remat,
                              fixed_engine=engine)
    b = TS.batch_to_device(batch, p["up_w"].device)
    state, loss = step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, float(loss)


def _short(kernel: str) -> str:
    """A CUDA kernel's name without its return type, argument list and
    anonymous namespace (template arguments kept: they tell the port's
    GEMMs apart)."""
    k = kernel.replace("(anonymous namespace)::", "").replace(
        "__nv_bfloat16", "bf16")
    if k.startswith("void "):
        k = k[5:]
    return k.split("(")[0].strip() or "(unnamed)"


def train_step_profile(params, cfg, batch, engine, dtype, top=10):
    """(device ms by kernel name for the `top` largest, device ms in all)
    over one training step, from torch.profiler; None where it saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from qpnet_tpu_torch.models.qpnet import tree_map
    from qpnet_tpu_torch.train import step as TS
    p = tree_map(lambda t: t.detach().clone(), params)
    tx = TS.make_optimizer()
    state = TS.TrainState(p, tx.init(p), 0)
    step = TS.make_train_step(cfg, tx, compute_dtype=dtype, remat=False,
                              fixed_engine=engine)
    b = TS.batch_to_device(batch, p["up_w"].device)
    state, _ = step(state, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, b)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if t and getattr(ev, "device_type", None) is not None and \
                "CUDA" in str(ev.device_type):
            key = _short(ev.key)
            by_name[key] = by_name.get(key, 0.0) + t / 1e3
    if not by_name:
        return None
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(ranked[:top]), sum(by_name.values())


def train_main(name, T=30030):
    from qpnet_tpu_torch.ops import train_kernel as TK
    cfg = ModelConfig()
    params = init_params(0, cfg, device="cuda")
    TK.build()
    batch = train_batch(cfg, 1, T, seed=1)
    for dtype in (torch.float32, torch.bfloat16):
        dname = "float32" if dtype == torch.float32 else "bfloat16"
        for fused in (False, True):
            static, W, o0, h, d = stack_inputs(params, cfg, batch, dtype,
                                               fused)
            f_ms, out = cuda_ms(lambda: TK.stack_forward(static, dtype, W, o0,
                                                         h, d))
            g = torch.Generator(device="cuda").manual_seed(2)
            do = torch.randn(out[0].shape, generator=g, device="cuda")
            dsk = torch.randn(out[1].shape, generator=g, device="cuda")
            b_ms, _ = cuda_ms(lambda: TK.stack_backward(
                static, dtype, W, out[2], out[3], h, d, do, dsk))
            bounds = stack_bounds(static, 1, T, dtype)
            print(json.dumps({
                "kernel": "K2", "dtype": dname, "B": 1, "T": T,
                "layers": len(static[0]) + len(static[1]),
                "fwd_ms": f_ms, "bwd_ms": b_ms,
                "fwd_bound_ms": bounds["fwd"][0],
                "bwd_bound_ms": bounds["bwd"][0],
                "fwd_tflop_per_s": bounds["fwd"][2] / f_ms / 1e9,
                "bwd_tflop_per_s": bounds["bwd"][2] / b_ms / 1e9,
                "card": name}), flush=True)
            del out
        for engine in ("xla", "pallas"):
            ms, loss = train_step_ms(params, cfg, batch, engine, dtype)
            prof = train_step_profile(params, cfg, batch, engine, dtype)
            print(json.dumps({
                "train_step": engine, "dtype": dname, "B": 1, "T": T,
                "ms": ms, "loss": loss,
                "device_ms": None if prof is None else prof[1],
                "device_ms_by_kernel": None if prof is None else prof[0],
                "card": name}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[1, 8, 20, 64])
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--network", default="default",
                   choices=["default", "Rd10Rr3Ed4Er1"])
    p.add_argument("--quantize", default="none", choices=["none", "w8a8"])
    p.add_argument("--train", action="store_true",
                   help="time the training kernel and step instead")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA device")
    if a.train:
        return train_main(card())
    cfg = ModelConfig.from_network_name(a.network)
    params = init_params(0, cfg, device="cuda")
    K.build()
    name = card()
    for B in a.batch:
        args, maxd = kernel_inputs(params, cfg, B, a.frames,
                                   quantize=a.quantize)
        n = a.frames * cfg.upsampling_factor
        kw = dict(B=B, maxd=maxd, n_steps=n, mode="sampling",
                  quantize=a.quantize)
        ms = step_ms(args, kw)
        bound = k1_bound(args, B, n, a.quantize)
        per_kernel, idle = kernel_us_per_step(args, kw, n)
        print(json.dumps({
            "network": a.network, "quantize": a.quantize, "B": B,
            "steps": n, "maxd": maxd, "ms_per_step": ms,
            "samples_per_s": B / ms * 1e3,
            "bound_us_per_step": bound[0] / n * 1e3, "bound_by": bound[1],
            "weights_us_per_step": bound[4],
            "kernel_us_per_step": per_kernel, "device_idle_share": idle,
            **K.host_launches(cfg, n), "card": name}), flush=True)
        del args


if __name__ == "__main__":
    main()
