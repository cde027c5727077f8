"""Time the generation kernel (K1) on the card across decode batches.

    python -m qpnet_tpu_torch.bench --batch 1 8 20 64 --frames 4

For each batch: one K1 call over `frames` frames of the default network
(random weights from a seed, sampling mode, frame-constant d from an 80 Hz
F0, maxd bucket 48), timed with CUDA events after a warm-up call, then the device time of
each of the kernel's CUDA kernels over one more call, from torch.profiler.
Prints one JSON line per batch with the card's name and power limit.
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

KERNELS = ("embed_kernel", "gate_kernel", "out_kernel", "post_kernel")


def card() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


# sampling rate, and the constant F0 of every row: 80 Hz, the lowest of a
# decode's usual range, puts d = 34.5 in the maxd bucket 48
FS, F0 = 22050, 80.0


def kernel_inputs(params, cfg, B, frames, seed=0):
    """((packed, cfg, bufF0, bufA0, x0, h_frames, d_frames, seed), maxd) for
    one K1 call of `frames` frames on the parameters' device."""
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
        const_seed=True)
    return (packed, cfg, bufF0, bufA0, x0, h_pad[:frames], d_fr[:frames],
            seed), maxd


def kernel_us_per_step(args, kw, n_steps):
    """Device microseconds per step of each CUDA kernel over one K1 call,
    from torch.profiler; None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        K.generate(*args, **kw)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        name = next((n for n in KERNELS if n in ev.key), None)
        if t and name:
            out[name] = out.get(name, 0.0) + t / n_steps
    return out or None


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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[1, 8, 20, 64])
    p.add_argument("--frames", type=int, default=4)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA device")
    cfg = ModelConfig()
    params = init_params(0, cfg, device="cuda")
    K.build()
    name = card()
    for B in a.batch:
        args, maxd = kernel_inputs(params, cfg, B, a.frames)
        n = a.frames * cfg.upsampling_factor
        kw = dict(B=B, maxd=maxd, n_steps=n, mode="sampling")
        ms = step_ms(args, kw)
        print(json.dumps({
            "B": B, "steps": n, "maxd": maxd, "ms_per_step": ms,
            "samples_per_s": B / ms * 1e3,
            "kernel_us_per_step": kernel_us_per_step(args, kw, n),
            "card": name}), flush=True)


if __name__ == "__main__":
    main()
