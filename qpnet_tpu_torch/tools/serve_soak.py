"""Sustained serving soak: N concurrent TCP streams for M minutes, ported
from the JAX package's `tools/serve_soak.py`.

A closed-loop load: each of `--streams` clients requests utterance after
utterance for `--minutes` from a `StreamingService` behind `serve_tcp`,
while the tool samples process RSS, open file descriptors, the service's
queue depth and per-chunk latency.  The run passes when every request
completes with the right sample count, no client errs, and neither RSS nor
the fd count grows between the first and last thirds of the run, nor the
median chunk latency by half or more.

Before the clients start, the service builds a session for every
power-of-two group size up to min(streams, max_streams), so no group pays
for building its session inside the measurement.

  python -m qpnet_tpu_torch.tools.serve_soak [--minutes 10] [--streams 64]
      [--seconds 2.0] [--network default] [--quantize none|w8a8]
      [--tiny] [--device cuda|cpu] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=3, dilationF_repeat=1,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=10, dense_factor=8)


def count_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def current_rss_mib() -> float:
    """Current RSS (ru_maxrss is a high-water mark, which cannot show
    growth over time)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return -1.0


def prewarm_buckets(streams: int, max_streams: int) -> list:
    """Every power-of-two group size up to min(streams, max_streams)
    (rounded up to its bucket): the group sizes a closed loop of `streams`
    clients can form."""
    top = 1 << (max(1, min(streams, max_streams)) - 1).bit_length()
    return [1 << i for i in range(top.bit_length())]


def run_soak(minutes: float, streams: int, seconds: float,
             tiny: bool = False, fs: int = 22050, f0: float = 120.0,
             quantize: str = "none", network: str = "default",
             gather_window_s: float = 0.25, sample_every_s: float = 5.0,
             verbose: bool = True, device="cuda") -> dict:
    """The soak on `device` (CUDA by default; "cpu" runs the kernel's
    plain twin); `tiny` uses a CPU-sized network at fs = 1000 with chunks
    of 0.1 s.  Returns a JSON-clean summary whose "ok" is the pass rule
    above."""
    from qpnet_tpu_torch.config import ModelConfig
    from qpnet_tpu_torch.models.qpnet import init_params, resolve_device
    from qpnet_tpu_torch.serve import (StreamingService, request_stream,
                                       serve_tcp)

    device = resolve_device(device)
    chunk = {}                  # the service's default chunk
    if tiny:
        cfg = ModelConfig(**TINY)
        fs = 1000
        chunk = dict(min_chunk_samples=100)
    else:
        cfg = ModelConfig.from_network_name(network)
    params = init_params(0, cfg, device=device)
    max_streams = min(streams, 64)
    svc = StreamingService(params, cfg, max_streams=max_streams, maxd=32,
                           gather_window_s=gather_window_s, mode="sampling",
                           seed=100, quantize=quantize, devices=[device],
                           max_pending=4 * streams, **chunk)
    srv = serve_tcp(svc, port=0)
    addr = srv.server_address

    buckets = prewarm_buckets(streams, max_streams)
    if verbose:
        print(f"# init: {device}, prewarming group sizes {buckets}",
              flush=True)
    t_pw = time.time()
    svc.prewarm(buckets)
    prewarm_s = round(time.time() - t_pw, 1)
    if verbose:
        print(f"# init: prewarm done in {prewarm_s}s", flush=True)

    rng = np.random.default_rng(0)
    F = max(2, int(seconds * fs) // cfg.upsampling_factor)
    h = rng.normal(size=(F, cfg.n_aux)).astype(np.float32)
    h[:, 1] = f0
    d = np.full(F, fs / (f0 * cfg.dense_factor), np.float32)
    n_expect = F * cfg.upsampling_factor

    stop = threading.Event()
    errors: list = []
    chunk_lat: list = []        # (t_wall, latency) samples
    completions = [0]
    lock = threading.Lock()

    def client(idx: int):
        while not stop.is_set():
            try:
                t_prev = time.perf_counter()
                n = 0
                for chunk in request_stream(addr, h, d):
                    now = time.perf_counter()
                    with lock:
                        chunk_lat.append((time.time(), now - t_prev))
                    t_prev = now
                    n += len(chunk)
                if n != n_expect:
                    with lock:
                        errors.append(f"client {idx}: {n} != {n_expect}")
                    return
                with lock:
                    completions[0] += 1
            except Exception as e:  # noqa: BLE001 — reported in the summary
                if stop.is_set():
                    return
                with lock:
                    errors.append(f"client {idx}: {type(e).__name__} {e}")
                return

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(streams)]
    t_start = time.time()
    for t in threads:
        t.start()

    samples = []
    deadline = t_start + minutes * 60.0
    try:
        while time.time() < deadline and not errors:
            time.sleep(min(sample_every_s, max(0.1, deadline - time.time())))
            s = {"t": round(time.time() - t_start, 1),
                 "rss_mib": round(current_rss_mib(), 1),
                 "fds": count_fds(),
                 "pending": len(svc._pending),
                 "done": svc.stats["streams_done"],
                 "completions": completions[0]}
            samples.append(s)
            if verbose:
                print(json.dumps(s), flush=True)
    finally:
        stop.set()
        # let in-flight utterances finish, then tear down
        for t in threads:
            t.join(timeout=60)
        srv.shutdown()
        srv.server_close()
        svc.close()

    lat = (np.asarray([v for _, v in chunk_lat[1:]]) if len(chunk_lat) > 1
           else np.asarray([0.0]))
    third = max(1, len(samples) // 3)
    first_t, last_t = samples[:third], samples[-third:]
    rss_first = float(np.median([s["rss_mib"] for s in first_t]))
    rss_last = float(np.median([s["rss_mib"] for s in last_t]))
    fd_growth = (np.median([s["fds"] for s in last_t])
                 - np.median([s["fds"] for s in first_t]))
    # per-chunk latency stability: median of the last third over the first
    n3 = max(1, len(lat) // 3)
    lat_drift = float(np.median(lat[-n3:]) / max(np.median(lat[:n3]), 1e-9))
    rss_growth = rss_last - rss_first
    return {
        "minutes": minutes, "streams": streams,
        "utterance_s": n_expect / fs,
        "prewarm_s": prewarm_s,
        "prewarmed_buckets": buckets,
        "device": str(device),
        "completions": completions[0],
        "errors": errors[:5],
        "rss_mib_first_third": round(rss_first, 1),
        "rss_mib_last_third": round(rss_last, 1),
        "rss_growth_mib": round(rss_growth, 1),
        "fd_growth": int(fd_growth),
        "pending_final": samples[-1]["pending"] if samples else -1,
        "chunk_latency_ms_median": round(float(np.median(lat)) * 1e3, 1),
        "chunk_latency_ms_p99": round(float(np.percentile(lat, 99)) * 1e3,
                                      1),
        "chunk_latency_drift": round(lat_drift, 3),
        "ok": bool(not errors and completions[0] > 0 and fd_growth <= 4
                   and rss_growth < 64.0 and lat_drift < 1.5),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fs", type=int, default=22050)
    ap.add_argument("--f0", type=float, default=120.0)
    ap.add_argument("--network", default="default")
    ap.add_argument("--quantize", default="none", choices=["none", "w8a8"])
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized network at fs = 1000")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the generation kernel's plain twin")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = run_soak(args.minutes, args.streams, args.seconds,
                   tiny=args.tiny, fs=args.fs, f0=args.f0,
                   quantize=args.quantize, network=args.network,
                   device=args.device)
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
