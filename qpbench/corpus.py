"""Seeded inputs of the cells: utterance lengths, F0 contours, aux features.

Every seed draws the same set of lengths (evenly spaced over the traffic's
range) and the same speakers' F0 ranges, in another order and with other
contents, so two seeds give the same amount of work.  Each F0 contour is
smooth and continuous (knots every 40 frames, linearly joined), and one of
its knots sits at its speaker's lowest F0, so every batch reaches the same
largest dilation factor.  Plain numpy: nothing here touches the program.
"""

from __future__ import annotations

import numpy as np

FS = 22050


def rng(*keys) -> np.random.Generator:
    """A generator keyed by whole numbers of any size (the run's seed and
    the draw's place)."""
    return np.random.default_rng([int(k) for k in keys])


def small_seed(*keys) -> int:
    """A seed below 2**31 for the program's own samplers, drawn from the
    keys."""
    return int(rng(*keys).integers(1, 2 ** 31 - 1))


def even_lengths(n: int, lo_s: float, hi_s: float, up: int) -> np.ndarray:
    """n frame counts evenly spaced over [lo_s, hi_s] seconds."""
    secs = lo_s + (hi_s - lo_s) * (np.arange(n) + 0.5) / n
    return (secs * FS).astype(np.int64) // up


def f0_track(g: np.random.Generator, n_frames: int, lo: float,
             hi: float) -> np.ndarray:
    """A smooth F0 contour in [lo, hi] Hz that reaches lo once."""
    knots = g.uniform(lo, hi, size=max(2, n_frames // 40 + 2))
    knots[g.integers(len(knots))] = lo
    f0 = np.interp(np.linspace(0, len(knots) - 1, n_frames),
                   np.arange(len(knots)), knots)
    f0[np.argmin(f0)] = lo
    return f0


def dilation(f0: np.ndarray, dense_factor: int) -> np.ndarray:
    """d = fs / F0 / dense_factor, the pitch-dependent dilation factor."""
    return FS / np.asarray(f0, np.float64) / dense_factor


def utterance(g: np.random.Generator, frames: int, f0_range, n_aux: int):
    """(h (frames, n_aux) f32 standard normal, f0 (frames,) Hz)."""
    f0 = f0_track(g, frames, *f0_range)
    h = g.standard_normal((frames, n_aux)).astype(np.float32)
    return h, f0


def speaker_range(traffic: dict, i: int):
    ranges = traffic["speaker_f0_hz"]
    return ranges[i % len(ranges)]


def serve_stream(cfg, traffic, seed: int, client: int, turn: int):
    """(h (F, A) f32, d (F,) f32) of a client's stream at a turn.  Its
    length is the conversation schedule's (`schedule`), the same for every
    seed; its aux and F0 contour are drawn from the seed."""
    F = schedule(cfg, traffic, client, turn)[0]
    h, f0 = utterance(rng(seed, 3, client, turn), F,
                      speaker_range(traffic, client), cfg["n_aux"])
    return h, dilation(f0, cfg["dense_factor"]).astype(np.float32)


def schedule(cfg, traffic, client: int, turn: int):
    """(frames, reply delay in s) of a client's stream at a turn: the
    conversations' fixed schedule, drawn from the traffic's
    `schedule_seed` and not from the run's seed.  At every turn the clients
    speak the same evenly spaced set of lengths over `seconds` and wait the
    same evenly spaced set of reply delays over `reply_delay_s`, each dealt
    out in an order of that turn's own; turn 0's delay is counted from the
    window's start."""
    n = traffic["clients"]
    frames = even_lengths(n, *traffic["seconds"], cfg["upsampling_factor"])
    lo, hi = traffic["reply_delay_s"]
    delays = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    key = traffic["schedule_seed"]
    return (int(frames[rng(key, 2, turn).permutation(n)[client]]),
            float(delays[rng(key, 4, turn).permutation(n)[client]]))
