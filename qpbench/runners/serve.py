"""Streaming service: `serve.StreamingService` behind `serve.serve_tcp` on
127.0.0.1, loaded by closed-loop TCP clients in a child process
(`qpbench.serve_client`).

Traffic parameters: `clients` (conversations), `seconds` [lo, hi] (stream
lengths), `reply_delay_s` [lo, hi] (the wait after a stream's audio has
played before the next turn is sent), `schedule_seed` (draws the
conversations' schedule of lengths and delays, the same for every run
seed: `corpus.schedule`), `speaker_f0_hz`, `drain_s`, `service` (the
StreamingService's settings: max_streams, maxd, gather_window_s,
min_chunk_samples, first_chunk_samples, quantize, mode), `prewarm` (the
group sizes built before the window), `check_streams`, `stretch_s` (the
traced stretch), `limit`, `control`.

The window runs from t_start for --seconds.  Every stream sent in it is
timed from its send to its first PCM bytes; one that never gets them counts
as failed.  Samples count where they arrived in the window, the feeds in
flight at its ends by the share of their time inside it (`delivered`), so
that the count does not jump by a whole feed when a chunk lands a
millisecond either side of an end.  A group is the streams whose first
audio came from one feed (they arrive together; groups are at least a feed
apart).

A traced run keeps its window as an untraced run has it: the clients go on
past its end, and once every stream sent in it has its first audio the
service is paused, the profiler opened, a stretch of `stretch_s` traced,
the service paused again and the profiler closed; then the clients stop.
So the per-layer metrics read from the window (first audio, delivered
samples, groups) see no pause.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from qpbench import corpus
from qpbench.runners.decode import model_config
from qpbench.harness import ROOT, Check, Run
from qpbench.trace import Stretch


def pcm_table(Q: int) -> np.ndarray:
    """The int16 PCM of each mu-law class on the wire (decoded, scaled by
    32768 and truncated)."""
    m = Q - 1
    fx = (np.arange(Q, dtype=np.float64) - 0.5) / m * 2 - 1
    wav = np.sign(fx) / m * ((1 + m) ** np.abs(fx) - 1)
    return np.trunc(np.clip(wav * 32768, -32768, 32767))


def tokens_of(pcm: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Classes of PCM samples: the nearest table entry; -1 where none lies
    within one step of the PCM's own rounding."""
    idx = np.abs(pcm[:, None].astype(np.float64) - table[None]).argmin(1)
    return np.where(np.abs(table[idx] - pcm) <= 1, idx, -1)


def delivered(chunks, t_send, t0: float, t1: float) -> float:
    """Samples of a stream's chunks [(arrival, n)] delivered in [t0, t1]: a
    chunk is made over the time since the stream's chunk before it (the
    first over as long as the second's), so a chunk in flight at an end of
    the window counts by the share of that time inside it."""
    out, prev = 0.0, None
    for i, (t, n) in enumerate(chunks):
        if prev is None:
            gap = chunks[1][0] - t if len(chunks) > 1 else t - t_send
            prev = t - gap
        if t > prev:
            out += n * max(0.0, min(t, t1) - max(prev, t0)) / (t - prev)
        elif t0 <= t <= t1:
            out += n
        prev = t
    return out


@contextlib.contextmanager
def paused(svc, feed_s: float = 3.0):
    """Hold the service's lock for longer than a feed: its scheduler stops
    at the end of the feed it runs (it takes the lock to count it), so the
    card is idle and no thread launches while the body runs.  A feed of
    5,500 samples takes about 1-2 s at the largest group, 32.  Traced runs
    only, after their window."""
    with svc._cv:
        time.sleep(feed_s)
        yield


def group_sizes(recs, t_start: float, t_end: float, gap_s: float = 0.2):
    """Sizes of the groups that started and finished inside [t_start,
    t_end]: streams whose first audio came within gap_s of each other came
    from one feed."""
    got = sorted((r for r in recs if r["t_first"] is not None),
                 key=lambda r: r["t_first"])
    groups, prev = [], None
    for r in got:
        if prev is None or r["t_first"] - prev > gap_s:
            groups.append([])
        groups[-1].append(r)
        prev = r["t_first"]
    return [len(g) for g in groups
            if all(r["t_send"] >= t_start and r["t_done"] is not None
                   and r["t_done"] <= t_end for r in g)]


def run(ctx) -> Run:
    from qpnet_tpu_torch.serve import StreamingService, serve_tcp

    from qpbench.weights import make_params
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    mcfg = model_config(cfg)
    params = make_params(cfg, ctx.seed, dev)
    if dev.type == "cuda":
        from qpnet_tpu_torch.ops import gen_kernel
        gen_kernel.build()
    svc = StreamingService(params, mcfg, seed=corpus.small_seed(ctx.seed, 5),
                           devices=[dev], **tr["service"])
    svc.prewarm(tr["prewarm"])
    srv = serve_tcp(svc, "127.0.0.1", 0)
    fd, out_path = tempfile.mkstemp(suffix=".pkl")
    os.close(fd)
    fd, job_path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump({"host": "127.0.0.1", "port": srv.server_address[1],
                   "seed": ctx.seed, "cfg": cfg, "traffic": tr,
                   "out": out_path}, f)
    child = subprocess.Popen(
        [sys.executable, "-m", "qpbench.serve_client", job_path],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        cwd=str(ROOT))
    try:
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the load's process did not start")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_start = time.monotonic() + 0.05
        t_end = t_start + ctx.seconds
        child.stdin.write(json.dumps({"t_start": t_start, "t_end": t_end,
                                      "hold": bool(ctx.trace)}) + "\n")
        child.stdin.flush()
        time.sleep(max(0.0, t_start - time.monotonic()))
        run = Run(setup_s=time.monotonic() - ctx.t_start,
                  window_s=ctx.seconds)
        ctx.phase("serve.window")
        stretch = None
        if ctx.trace:
            if child.stdout.readline().strip() != "window_done":
                raise RuntimeError("the load's process stopped early")
            ctx.phase("serve.traced")
            stretch = Stretch()
            with paused(svc):
                stretch.open()
            time.sleep(tr["stretch_s"])
            end = time.time_ns()
            with paused(svc):
                stretch.close(end)
            child.stdin.write("stop\n")
            child.stdin.flush()
        ctx.phase("serve.drain")
        child.wait()
        with open(out_path, "rb") as f:
            recs = pickle.load(f)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        for p in (out_path, job_path):
            if os.path.exists(p):
                os.unlink(p)
        srv.shutdown()
        srv.server_close()
        svc.close()
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del svc
    sent = [r for r in recs if r["t_send"] is not None
            and t_start <= r["t_send"] < t_end]
    run.attempted = len(sent)
    waits = []
    for r in sent:
        bad = r["err"] is not None or r["t_first"] is None or \
            (r["t_done"] is not None and r["n"] != r["expected"])
        run.failed += bad
        waits.append(float("inf") if r["t_first"] is None
                     else (r["t_first"] - r["t_send"]) * 1e3)
    in_window = sum(delivered(r["chunks"], r["t_send"], t_start, t_end)
                    for r in recs)
    sizes = group_sizes(recs, t_start, t_end)
    run.counts.update(
        serve_samples=in_window, first_audio_ms=waits,
        serve_group_sizes=sizes, groups_inside=" ".join(map(str, sizes)),
        quantize=tr["service"].get("quantize", "none"))
    if stretch is not None:
        run.trace = stretch.read(ctx.phase)
    judge(ctx, run, params, [r for r in recs if r["pcm"] is not None])
    return run


def judge(ctx, run, params, done):
    """The widest gap of the served tokens of a sample of the finished
    streams, the longest among them."""
    from qpbench.reference import judge as J
    from qpbench.reference.precision import make_mm
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    if not done:
        run.failed += 1
        return
    table = pcm_table(cfg["n_quantize"])
    pick = J.pick_sample(corpus.rng(ctx.seed, 9),
                         [r["expected"] for r in done], tr["check_streams"])
    items, corrupt = [], 0
    for i in pick:
        r = done[i]
        h, d = corpus.serve_stream(cfg, tr, ctx.seed, r["client"], r["turn"])
        tok = tokens_of(r["pcm"], table)
        corrupt += int((tok < 0).sum())
        items.append((torch.as_tensor(h, device=dev),
                      torch.as_tensor(d, device=dev),
                      torch.as_tensor(np.maximum(tok, 0), device=dev)))
    control = make_mm(tr["control"]) if ctx.control else None
    served, low = J.widest_gaps(params, cfg, items, control)
    run.checks["greedy_logit_gap"] = Check(
        float("inf") if corrupt else served, tr["limit"])
    if low is not None:
        run.counts["control_logit_gap"] = low
    run.counts["checked_tokens"] = sum(len(i[2]) for i in items)
