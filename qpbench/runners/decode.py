"""Batch decode: the reference's `qpnet_decode` loop through
`models.generate.batch_fast_generate`, one call after another (a closed
loop).

Traffic parameters: `batch` (utterances a call), `batches_per_round`,
`seconds` [lo, hi] (utterance lengths), `speaker_f0_hz` (F0 ranges),
`quantize`, `modes` (the batches take them in turn by length, so the
longest batch is greedy with two modes), `check_utterances` (greedy
utterances judged), `limit` (the widest logit gap a greedy token may have),
`check_sampled` and `sampled_limit` (sampled utterances judged, and the
largest |mean -log p_ref - entropy| their tokens may read; without
`sampled_limit` the sampled calls are judged by their lengths only),
`control` (the control's precision).

A round is batches_per_round * batch utterances of evenly spaced lengths,
drawn from the seed, sorted by length into batches (as `qpnet_decode`
does) and decoded in an order the seed shuffles.  The window runs whole
rounds: the first always, another only where the rate so far says it fits
in --seconds, so every seed decodes the same lengths.  The window is the
wall time from the first call's start to the last call's end.  A traced
run profiles the round's shortest call whole; the profiler's stop after it
(a synchronize and the processing of a few million kernel events, between
two calls) is left out of that run's window.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from qpbench import corpus
from qpbench.harness import Check, Run
from qpbench.trace import Stretch


def model_config(cfg):
    from qpnet_tpu_torch.config import ModelConfig
    import dataclasses
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def make_round(cfg, traffic, seed: int, r: int):
    """[(h (B, F, A), d (B, F up), n_samples [B], frames [B], mode)] of
    round r, in the order they are decoded."""
    up, B = cfg["upsampling_factor"], traffic["batch"]
    n = B * traffic["batches_per_round"]
    g = corpus.rng(seed, 1, r)
    frames = corpus.even_lengths(n, *traffic["seconds"], up)
    frames = frames[g.permutation(n)]
    utts = []
    for i, F in enumerate(frames):
        h, f0 = corpus.utterance(g, int(F), corpus.speaker_range(traffic, i),
                                 cfg["n_aux"])
        utts.append((h, corpus.dilation(f0, cfg["dense_factor"])))
    order = np.argsort(frames, kind="stable")
    batches = []
    for idx in np.array_split(order, traffic["batches_per_round"]):
        Fm = int(frames[idx].max())
        h = np.zeros((len(idx), Fm, cfg["n_aux"]), np.float32)
        d = np.zeros((len(idx), Fm * up), np.float32)
        for j, i in enumerate(idx):
            hi, di = utts[i]
            h[j, :len(hi)] = hi
            d[j, :len(di) * up] = np.repeat(di, up)
        fr = [int(frames[i]) for i in idx]
        batches.append((h, d, [f * up - 1 for f in fr], fr))
    modes = traffic["modes"]
    return [(*batches[b], modes[b % len(modes)])
            for b in g.permutation(len(batches))]


def run(ctx) -> Run:
    from qpnet_tpu_torch.models import generate as G

    from qpbench.weights import make_params
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    mcfg = model_config(cfg)
    up, B, q = cfg["upsampling_factor"], tr["batch"], tr["quantize"]
    params = make_params(cfg, ctx.seed, dev)
    if dev.type == "cuda":
        from qpnet_tpu_torch.ops import gen_kernel
        gen_kernel.build()
    mid = cfg["n_quantize"] // 2

    def call(h, d, n_samples, mode, seed):
        x = np.full((h.shape[0], 1), mid, np.int32)
        return G.batch_fast_generate(params, mcfg, x, h, n_samples, d,
                                     seed=seed, mode=mode, quantize=q,
                                     engine="auto", device=dev)

    # warm-up: one short call a mode at the cell's B and the rounds' maxd
    lo_f0 = min(r[0] for r in tr["speaker_f0_hz"])
    d_lo = float(corpus.dilation(np.array([lo_f0]), cfg["dense_factor"])[0])
    for mode in sorted(set(tr["modes"])):
        F = 10
        call(np.zeros((B, F, cfg["n_aux"]), np.float32),
             np.full((B, F * up), d_lo, np.float32), [F * up - 1] * B, mode,
             1)
    rounds = [make_round(cfg, tr, ctx.seed, 0)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run = Run(setup_s=time.monotonic() - ctx.t_start)

    stretch, stretch_call, profiler_s = None, None, 0.0
    useful, frames_done, steps_done = 0, 0, 0
    greedy, sampled, k = [], [], 0
    t0 = time.perf_counter()
    ctx.phase("decode.window")
    r = 0
    while True:
        if r > 0:
            spent = time.perf_counter() - t0 - profiler_s
            need = sum(max(b[2]) + 1 for b in rounds[-1])
            if spent + need * spent / max(steps_done, 1) > ctx.seconds:
                break
            rounds.append(make_round(cfg, tr, ctx.seed, r))
        for h, d, n_samples, fr, mode in rounds[-1]:
            seed = corpus.small_seed(ctx.seed, 2, r, k)
            traced = ctx.trace and stretch is None and \
                max(fr) == min(max(b[3]) for b in rounds[0])
            if traced:
                stretch = Stretch()
                stretch.open()
                stretch_call = (h.shape[0], max(n_samples), n_samples, fr)
            ctx.phase(f"decode.call.{mode}")
            out = call(h, d, n_samples, mode, seed)
            if traced:
                t_stop = time.perf_counter()
                stretch.close()
                profiler_s = time.perf_counter() - t_stop
            ctx.phase("decode.between_calls")
            run.attempted += len(n_samples)
            for i, n in enumerate(n_samples):
                if i >= len(out) or len(out[i]) != n:
                    run.failed += 1
                    continue
                useful += n
                frames_done += fr[i]
                (greedy if mode == "argmax" else sampled).append(
                    (h[i, :fr[i]], d[i, ::up][:fr[i]], np.asarray(out[i])))
            steps_done += max(n_samples) + 1
            k += 1
        r += 1
    run.window_s = time.perf_counter() - t0 - profiler_s
    ctx.phase("decode.after")
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    run.counts.update(decode_useful_samples=useful,
                      decode_frames=frames_done, quantize=q, batch=B,
                      maxd=math.ceil(d_lo),
                      calls=k)
    if stretch is not None:
        run.trace = stretch.read(ctx.phase)
        Bc, steps, n_samples, fr = stretch_call
        run.counts["stretch_call"] = {
            "B": Bc, "padded_steps": -(-steps // (10 * up)) * 10 * up,
            "useful_samples": sum(n_samples), "frames": sum(fr)}
    judge(ctx, run, params, greedy, sampled)
    return run


def judge(ctx, run, params, greedy, sampled):
    """The widest gap of the greedy tokens of a sample of the finished
    greedy utterances, the longest among them; and, where the traffic sets
    `sampled_limit`, the sampled tokens' mean excess over the entropy on a
    sample of the sampled utterances, the longest among them."""
    from qpbench.reference import judge as J
    from qpbench.reference.precision import make_mm
    tr, dev = ctx.traffic, ctx.device

    def items(utts, n, key):
        pick = J.pick_sample(corpus.rng(ctx.seed, key),
                             [len(t) for _, _, t in utts], n)
        return [tuple(torch.as_tensor(x, device=dev) for x in utts[i])
                for i in pick]
    if greedy:
        chosen = items(greedy, tr["check_utterances"], 9)
        control = make_mm(tr["control"]) if ctx.control else None
        served, low = J.widest_gaps(params, ctx.cfg, chosen, control)
        run.checks["greedy_logit_gap"] = Check(served, tr["limit"])
        if low is not None:
            run.counts["control_logit_gap"] = low
        run.counts["checked_tokens"] = sum(len(i[2]) for i in chosen)
    if sampled and "sampled_limit" in tr:
        chosen = items(sampled, tr["check_sampled"], 10)
        run.checks["sampled_nll_excess"] = Check(
            J.sampled_excess(params, ctx.cfg, chosen), tr["sampled_limit"])
        run.counts["checked_sampled_tokens"] = sum(len(i[2]) for i in chosen)
    if not greedy or ("sampled_limit" in tr and not sampled):
        run.failed += 1
