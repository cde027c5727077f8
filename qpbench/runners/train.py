"""Training: `train.trainer.train_loop` as `qpnet_train` runs it, over
`data.batcher.window_batches` of seeded in-memory utterances.

Traffic parameters: `seconds` [lo, hi] (utterance lengths),
`utterances` (a pass's count; the passes repeat in orders drawn from the
seed), `speaker_f0_hz`, `train` (the TrainConfig's dtype, fixed_engine,
lr and intervals; the windows' batch_length, max_length and batch_size
are the configuration's),
`setup_steps` (the steps before the window, the reference's among them),
`stretch_steps`, `limits` {loss, grad, change}, `control`.

One `train_loop` runs it all.  Its batches come through the benchmark's
iterator, which times each `next()` the loop makes, opens the window after
`setup_steps` steps (after a synchronize) and closes it at the first
`next()` past --seconds (after a synchronize), raising out of the loop:
no checkpoint is written, since the interval lies past the window.  The
step function the loop makes is wrapped to keep, for the check, the
parameters before the first step, Adam's first moments after it and the
parameters after the third, and each step's loss.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from qpbench import corpus
from qpbench.runners.decode import model_config
from qpbench.harness import Check, Run
from qpbench.reference import train as RT
from qpbench.trace import Stretch


class WindowClosed(Exception):
    pass


def utterances(cfg, tr, seed):
    """A pass's (fs, x in [-1, 1], h raw, f0): a pitched tone at the F0
    contour with a little noise, raw aux [1, F0, normal...]."""
    up = cfg["upsampling_factor"]
    n = tr["utterances"]
    g = corpus.rng(seed, 6)
    frames = corpus.even_lengths(n, *tr["seconds"], up)[g.permutation(n)]
    out = []
    for i, F in enumerate(frames):
        f0 = corpus.f0_track(g, int(F), *corpus.speaker_range(tr, i))
        phase = np.cumsum(2 * np.pi * np.repeat(f0, up) / corpus.FS)
        x = (0.4 * np.sin(phase)
             + 0.02 * g.standard_normal(int(F) * up)).astype(np.float32)
        h = g.standard_normal((int(F), cfg["n_aux"]))
        h[:, 0], h[:, 1] = 1.0, f0
        out.append((corpus.FS, x, h, f0))
    return out


def scaler(utts):
    """Standardize the raw aux by the pass's frames (the uv dim kept)."""
    frames = np.concatenate([u[2] for u in utts])
    mean, scale = frames.mean(0), frames.std(0)
    mean[0], scale[0] = 0.0, 1.0
    return lambda h: (h - mean) / scale


def stream(utts, seed):
    """The utterances pass after pass, each pass in an order from the seed."""
    p = 0
    while True:
        for i in corpus.rng(seed, 7, p).permutation(len(utts)):
            yield utts[i]
        p += 1


class Recorder:
    """Wraps the loop's step function; keeps what the check reads."""

    def __init__(self, step_fn):
        self.step_fn, self.losses = step_fn, []
        self.p0 = self.m1 = self.p3 = self.state = None

    def __call__(self, state, batch, *a):
        n = len(self.losses)
        if n == 0:
            self.p0 = {k: v.detach().clone() for k, v in RT.leaves(
                state.params)}
        state, loss = self.step_fn(state, batch, *a)
        self.losses.append(loss.detach())
        if n == 0:
            opt = state.opt_state
            self.m1 = {k: opt.state[v]["exp_avg"].detach().clone()
                       for k, v in RT.leaves(state.params)}
        if n == 2:
            self.p3 = {k: v.detach().clone() for k, v in RT.leaves(
                state.params)}
        self.state = state
        return state, loss


def run(ctx) -> Run:
    from qpnet_tpu_torch.config import TrainConfig
    from qpnet_tpu_torch.data.batcher import background, window_batches
    from qpnet_tpu_torch.train import trainer

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    mcfg = model_config(cfg)
    seed = ctx.seed % 2 ** 32
    utts = utterances(cfg, tr, ctx.seed)
    transform = scaler(utts)
    shape = {k: cfg[k] for k in ("batch_length", "batch_size", "max_length")}
    tcfg = TrainConfig(seed=seed, iters=10 ** 9,
                       checkpoint_interval=10 ** 9, **shape, **tr["train"])
    batches = background(2)(window_batches)(
        (u[:3] for u in stream(utts, ctx.seed)), mcfg,
        feat_transform=transform, **shape)
    rec, waits = {}, []
    clock = {"steps": 0, "t0": None, "t1": None, "stretch": None}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    run = Run()

    def feed():
        while True:
            n = clock["steps"]
            if n == tr["setup_steps"]:
                sync()
                run.setup_s = time.monotonic() - ctx.t_start
                clock["t0"] = time.perf_counter()
                ctx.phase("train.window")
            if clock["t0"] is not None:
                now = time.perf_counter()
                st = clock["stretch"]
                if ctx.trace and st is None and n == tr["setup_steps"] + 2:
                    st = clock["stretch"] = Stretch()
                    st.open()
                    clock["stretch_at"] = n
                closing = now - clock["t0"] >= ctx.seconds
                if st is not None and not st.closed and (
                        closing or
                        n == clock["stretch_at"] + tr["stretch_steps"]):
                    st.close()
                if closing:
                    sync()
                    clock["t1"] = time.perf_counter()
                    raise WindowClosed
            ctx.phase("train.next_batch")
            a = time.perf_counter()
            b = next(batches)
            if clock["t0"] is not None:
                waits.append(time.perf_counter() - a)
            ctx.phase("train.step")
            clock["steps"] = n + 1
            yield b

    make = trainer.make_train_step

    def recording(*a, **kw):
        rec["r"] = Recorder(make(*a, **kw))
        return rec["r"]

    trainer.make_train_step = recording
    try:
        with tempfile.TemporaryDirectory() as expdir:
            trainer.train_loop(mcfg, tcfg, feed(), expdir, device=dev)
        raise RuntimeError("train_loop ended before the window closed")
    except WindowClosed:
        pass
    finally:
        trainer.make_train_step = make
    ctx.phase("train.after")
    r = rec["r"]
    steps = clock["steps"] - tr["setup_steps"]
    run.window_s = clock["t1"] - clock["t0"]
    run.attempted = steps
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    losses = torch.stack(r.losses).float().cpu().numpy()
    run.failed = int((~np.isfinite(losses[-steps:])).sum()) if steps else 1
    T = -(-cfg["max_length"] // cfg["upsampling_factor"]) \
        * cfg["upsampling_factor"]
    run.counts.update(train_steps=steps, train_B=cfg["batch_size"], train_T=T,
                      batch_wait_s=waits[:steps])
    if clock["stretch"] is not None:
        run.trace = clock["stretch"].read(ctx.phase)
    prog = {"losses": [float(v) for v in losses[:3]], "p0": r.p0,
            "m1": r.m1, "p3": r.p3}
    r.state = None
    rec.clear()
    judge(ctx, run, prog, utts, transform, seed)
    return run


def judge(ctx, run, prog, utts, transform, seed):
    """The first three steps against the reference's: each loss, the first
    gradient (Adam's first moment after one step over 1 - 0.9) and the
    change of the parameters after three, by the worst leaf."""
    from qpbench.reference import judge as J
    from qpbench.reference.precision import make_mm
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    J.full_f32()
    wins = RT.windows(stream(utts, ctx.seed), cfg, transform, 3)
    params = RT.init_params(seed, cfg, dev)
    lr = tr["train"]["lr"]
    readings = {}
    for name, mm in [("ref", None)] + ([("control", make_mm(tr["control"]))]
                                       if ctx.control else []):
        kw = {} if mm is None else {"mm": mm}
        readings[name] = RT.adam_steps(params, cfg, wins, dev, lr, **kw)
    losses, grad, change = readings["ref"]
    keep = RT.kept_leaves(grad)
    g_prog = {k: v / (1 - 0.9) for k, v in prog["m1"].items()}
    c_prog = {k: prog["p3"][k] - prog["p0"][k] for k in prog["p0"]}
    lim = tr["limits"]

    def numbers(l_side, g_side, c_side):
        return (max(abs(a - b) / abs(b) for a, b in zip(l_side, losses)),
                RT.leaf_gap(g_side, grad, keep)[0],
                RT.leaf_gap(c_side, change, keep)[0])

    lo, gr, ch = numbers(prog["losses"], g_prog, c_prog)
    run.checks["loss_gap"] = Check(lo, lim["loss"])
    run.checks["grad_gap"] = Check(gr, lim["grad"])
    run.checks["change_gap"] = Check(ch, lim["change"])
    run.counts["kept_leaves"] = len(keep)
    run.counts["leaves"] = len(grad)
    if "control" in readings:
        run.counts["control"] = dict(zip(
            ("loss_gap", "grad_gap", "change_gap"),
            numbers(*readings["control"])))
