"""Training smoke of the deep network at its registry shape, on the card:
the port of the JAX package's root `tools/deep_train_smoke.py`.

The reference registers Rd10Rr3Ed4Er1 as a training entry (max_length
22500, batch_length 20000, batch 1).  This tool trains that geometry at
full width (R=512, S=256, Q=256, A=39, up=110; 30 fixed layers with
dilations up to 512 and 4 adaptive ones) for a few hundred iterations on a
synthetic 22,050 Hz corpus, and reports ms per step, the first step's time
(the kernels' build and the allocator's warm-up), peak device memory, K2's
launches and a loss gate: it exits 1 unless the mean loss of the last 50
iterations is below the mean of the first 50.

The corpus is the JAX tool's (`tests/helpers.py::make_synthetic_corpus`:
6 utterances of 1.5 s plus a random extra, F0 a linear ramp within
50-120 Hz, seed 7, unscaled features), made by the same numpy stream and
kept in memory: the audio is rounded through int16 as the JAX tool's wav
write and read round it, and the batcher's windowing
(`data/batcher.py::window_batches`) cuts the windows the JAX tool's
`train_window_generator` cuts from those files.

usage: python -m qpnet_tpu_torch.tools.deep_train_smoke [--iters 300]
         [--dtype bfloat16|float32] [--remat auto|on|off] [--lr 1e-4]
         [--json out.json] [--device cuda|cpu]
         [--fixed_engine auto|xla|pallas]

--fixed_engine auto resolves to the plain engine (xla), as in the JAX
package; pallas runs the residual stack through K2 (fixed layers only).
--device cpu runs the same loop on the CPU (K2's twin with pallas): at
this size it is for the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

NETWORK = "Rd10Rr3Ed4Er1"
# the registry's training windows of the deep net
BATCH_LENGTH, MAX_LENGTH, BATCH_SIZE = 20000, 22500, 1
GATE_WINDOW = 50             # iterations at each end of the loss gate


def synthetic_utterances(n_utts: int = 6, fs: int = 22050, up: int = 110,
                         n_aux: int = 39, seconds: float = 1.5,
                         f0_lo: float = 50.0, f0_hi: float = 120.0,
                         seed: int = 7) -> list:
    """[(fs, x, h)]: the utterances `tests/helpers.py::
    make_synthetic_corpus` writes for the same arguments, as its wav and h5
    files read back: a pitched tone plus noise rounded to int16 and scaled
    by 1/32768, and f32 features whose dim 0 is 1 and dim 1 the F0 ramp."""
    rng = np.random.default_rng(seed)
    utts = []
    for _ in range(n_utts):
        n = int(fs * seconds) + rng.integers(0, fs // 4)
        n_frames = n // up
        n = n_frames * up
        f0 = np.linspace(rng.uniform(f0_lo, f0_hi),
                         rng.uniform(f0_lo, f0_hi), n_frames)
        phase = np.cumsum(2 * np.pi * np.repeat(f0, up) / fs)
        x = 0.4 * np.sin(phase) + 0.05 * rng.normal(size=n)
        pcm = (x * 32767).astype(np.int16)
        h = rng.normal(size=(n_frames, n_aux)).astype(np.float32)
        h[:, 0] = 1.0
        h[:, 1] = f0
        utts.append((fs, np.asarray(pcm, np.float32) / 32768, h))
    return utts


def window_stream(cfg, utts, batch_length: int = BATCH_LENGTH,
                  max_length: int = MAX_LENGTH,
                  batch_size: int = BATCH_SIZE, seed: int = 1):
    """The batcher's endless shuffled windows of in-memory utterances,
    as `train_window_generator(..., seed=seed)` cuts them from files."""
    from qpnet_tpu_torch.data.batcher import utterance_stream, window_batches
    return window_batches(
        utterance_stream(utts, lambda u: u, shuffle=True, seed=seed,
                         loop=True), cfg, batch_length=batch_length,
        batch_size=batch_size, max_length=max_length)


def train_run(cfg, iters: int, dtype: str = "bfloat16", remat: bool = True,
              lr: float = 1e-4, device="cuda", fixed_engine: str = "auto",
              batch_length: int = BATCH_LENGTH, max_length: int = MAX_LENGTH,
              batch_size: int = BATCH_SIZE, utts=None, params=None,
              log=print) -> dict:
    """Train `cfg` for `iters` steps from random parameters of seed 0 (or
    the numpy tree `params`) on `utts` (default: `synthetic_utterances`
    at the config's widths) and return the JAX tool's JSON record but its
    "network" (which `main` names), plus "device", "fixed_engine", "card",
    "peak_device_mib", "k2_launches" and "losses" (every iteration's)."""
    import torch

    from qpnet_tpu_torch.models.qpnet import (count_params, init_params,
                                              params_from_numpy,
                                              resolve_device)
    from qpnet_tpu_torch.ops import train_kernel as TK
    from qpnet_tpu_torch.train import step as TS
    device = resolve_device(device)
    on_card = device.type == "cuda"
    card = None
    if on_card:
        from qpnet_tpu_torch.bench import card as card_line
        card = card_line()
    log(f"device: {device} ({card or 'cpu'})")
    compute_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    engine = TS.resolve_fixed_engine(fixed_engine, cfg, batch_size,
                                     max_length, compute_dtype)
    if utts is None:
        utts = synthetic_utterances(up=cfg.upsampling_factor, n_aux=cfg.n_aux)
    batches = window_stream(cfg, utts, batch_length, max_length, batch_size)
    tx = TS.make_optimizer(lr=lr)
    p = (init_params(0, cfg, device=device) if params is None
         else params_from_numpy(params, device))
    n_params = count_params(p)
    log(f"params: {n_params / 1e6:.1f}M  dtype={dtype} remat={remat} "
        f"engine={engine}")
    step = TS.make_train_step(cfg, tx, compute_dtype=compute_dtype,
                              remat=remat, fixed_engine=engine)
    state = TS.TrainState(p, tx.init(p), 0)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    k2_before = (TK.fwd_launch_count, TK.bwd_launch_count)
    losses, step_s = [], []
    for i, batch in zip(range(iters), batches):
        batch.pop("window_lens", None)
        t0 = time.perf_counter()
        state, loss = step(state, TS.batch_to_device(batch, device))
        if on_card:
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if i == 0:
            log(f"first step (build, warm-up): {step_s[0]:.1f}s")
        if i % 50 == 0:
            log(f"iter {i}: loss {float(loss):.4f}")
    losses = torch.stack(losses).float().cpu().numpy()
    # steady state: after the first 10 steps, as the JAX tool times it
    warm = min(10, max(len(step_s) - 1, 0))
    first = float(losses[:GATE_WINDOW].mean())
    last = float(losses[-GATE_WINDOW:].mean())
    return {
        "params_m": n_params / 1e6, "dtype": dtype,
        "remat": remat, "iters": iters,
        "ms_per_step_median": round(1e3 * float(np.median(step_s[warm:])),
                                    3),
        "compile_s": round(step_s[0], 3),
        "loss_first50_mean": round(first, 4),
        "loss_last50_mean": round(last, 4),
        "loss_decreased": bool(last < first),
        "device": str(device), "fixed_engine": engine, "card": card,
        "peak_device_mib": (round(torch.cuda.max_memory_allocated(device)
                                  / 2 ** 20, 1) if on_card else None),
        "k2_launches": [TK.fwd_launch_count - k2_before[0],
                        TK.bwd_launch_count - k2_before[1]],
        "losses": [float(v) for v in losses],
    }


def registry_geometry():
    """(cfg, batch_length, max_length, batch_size) of the deep net, full
    width, as the registry trains it."""
    from qpnet_tpu_torch.config import ModelConfig
    return (ModelConfig.from_network_name(NETWORK), BATCH_LENGTH, MAX_LENGTH,
            BATCH_SIZE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--remat", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--fixed_engine", default="auto",
                    choices=["auto", "xla", "pallas"])
    args = ap.parse_args(argv)
    cfg, batch_length, max_length, batch_size = registry_geometry()
    out = {"network": NETWORK, **train_run(
        cfg, args.iters, args.dtype,
        remat={"auto": True, "on": True, "off": False}[args.remat],
        lr=args.lr, device=args.device, fixed_engine=args.fixed_engine,
        batch_length=batch_length, max_length=max_length,
        batch_size=batch_size)}
    out.pop("losses")
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if out["loss_decreased"] else 1


if __name__ == "__main__":
    sys.exit(main())
