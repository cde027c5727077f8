"""Harvest-style F0 estimator (Morise 2017, the WORLD `harvest` — the
estimator sprocket's FeatureExtractor actually calls, SURVEY.md §2.2).

Follows Harvest's structure:
  1. dense log-spaced candidate channels (24 per octave vs DIO's 2): each
     channel low-passes the signal at its boundary frequency and derives
     the four event-interval tracks (negative/positive zero crossings,
     peaks, dips);
  2. per-frame candidate pooling across channels, keeping candidates whose
     four interval estimates agree;
  3. instantaneous-frequency refinement of every candidate (the
     StoneMask mechanism) with a stability score;
  4. Viterbi contour tracking over {candidates + unvoiced} per frame with
     log-pitch transition costs, then short-voiced-run removal.

This is an algorithmic reimplementation (pyworld is not available in this
image); it reproduces Harvest's dense-candidate robustness rather than its
bit-exact output.  Validated on ground-truth synthetic signals
(tests/test_world.py) to tighter tolerances than the DIO path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from qpnet_tpu_torch.dsp.world.dio import (
    _SpectrumCache, _event_times, _interval_f0_track, _low_cut_fft,
    decimate_for_f0,
)
from qpnet_tpu_torch.dsp.world.refine import refine_many


def _channel_candidates(xb: np.ndarray, fs: int,
                        boundary_f0: float,
                        f0_floor: float, f0_ceil: float,
                        frame_times: np.ndarray):
    """One channel's per-frame candidate + agreement score."""
    tracks = []
    for kind in ("negzc", "poszc"):
        tracks.append(_interval_f0_track(_event_times(xb, fs, kind),
                                         frame_times))
    d = np.diff(xb)
    for kind in ("peak", "dip"):
        s0, s1 = d[:-1], d[1:]
        if kind == "peak":
            idx = np.where((s0 > 0) & (s1 <= 0))[0]
        else:
            idx = np.where((s0 < 0) & (s1 >= 0))[0]
        if len(idx) == 0:
            tracks.append(np.zeros(len(frame_times)))
            continue
        frac = s0[idx] / (s0[idx] - s1[idx] + 1e-30)
        tracks.append(_interval_f0_track((idx + 0.5 + frac) / fs,
                                         frame_times))
    tr = np.stack(tracks)                     # (4, F)
    cand = tr.mean(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        spread = tr.std(axis=0) / np.maximum(cand, 1e-9)
    bad = ((cand < f0_floor) | (cand > f0_ceil)
           | (cand <= boundary_f0 / 2) | (cand > boundary_f0 * 2)
           | np.any(tr <= 0, axis=0))
    cand = np.where(bad, 0.0, cand)
    spread = np.where(bad, np.inf, spread)
    return cand, spread


def harvest(x: np.ndarray, fs: int, f0_floor: float = 71.0,
            f0_ceil: float = 800.0, frame_period: float = 5.0,
            channels_in_octave: float = 24.0,
            agreement_threshold: float = 0.10,
            max_candidates: int = 6,
            transition_cost: float = 8.0,
            unvoiced_cost: float = 0.35) -> Tuple[np.ndarray, np.ndarray]:
    """Estimate F0. Returns (f0, time_axis); f0==0 marks unvoiced."""
    x = np.asarray(x, np.float64)
    n_frames = int(len(x) / (fs * frame_period / 1000.0)) + 1
    time_axis = np.arange(n_frames) * frame_period / 1000.0
    xlc = _low_cut_fft(x, fs, 50.0)

    n_ch = 1 + int(np.log2(f0_ceil / f0_floor) * channels_in_octave)
    boundaries = f0_floor * 2.0 ** ((np.arange(n_ch) + 1)
                                    / channels_in_octave)
    cands = np.zeros((n_ch, n_frames))
    spreads = np.full((n_ch, n_frames), np.inf)
    xd, fs_d = decimate_for_f0(xlc, fs, f0_ceil)
    cache = _SpectrumCache(xd, fs_d, float(boundaries[0]))
    xbs = cache.band_lowpass_many(boundaries)   # one batched inverse FFT
    for c, bf in enumerate(boundaries):
        cands[c], spreads[c] = _channel_candidates(
            xbs[c], fs_d, bf, f0_floor, f0_ceil, time_axis)

    # pool per-frame candidates: best-agreeing channels, deduped by ~5%.
    # Vectorized across frames: walk channels in per-frame agreement order
    # (n_ch small iterations of (F, max_candidates) ops instead of a
    # Python loop over every frame).
    order = np.argsort(spreads, axis=0)              # (n_ch, F)
    sp_sorted = np.take_along_axis(spreads, order, axis=0)
    f_sorted = np.take_along_axis(cands, order, axis=0)
    pooled = np.zeros((n_frames, max_candidates))
    n_chosen = np.zeros(n_frames, np.int64)
    frames = np.arange(n_frames)
    for r in range(n_ch):
        f = f_sorted[r]                              # (F,)
        ok = (sp_sorted[r] <= agreement_threshold) & (f > 0)
        # dedupe: skip candidates within 5% of one already chosen
        dup = np.any(
            np.abs(f[:, None] - pooled) < 0.05 * np.maximum(pooled, 1e-9),
            axis=1)
        take = ok & ~dup & (n_chosen < max_candidates)
        if not take.any():
            continue
        pooled[frames[take], n_chosen[take]] = f[take]
        n_chosen[take] += 1

    # instantaneous-frequency refinement + stability score (batched)
    tq, kq = np.nonzero(pooled > 0)
    r_all = refine_many(x, fs, time_axis[tq], pooled[tq, kq])
    refined = np.zeros_like(pooled)
    score = np.zeros_like(pooled)
    ok = (r_all > 0) & (r_all >= f0_floor) & (r_all <= f0_ceil)
    refined[tq[ok], kq[ok]] = r_all[ok]
    f_ok = pooled[tq[ok], kq[ok]]
    score[tq[ok], kq[ok]] = np.maximum(
        0.0, 1.0 - 5.0 * np.abs(r_all[ok] - f_ok) / f_ok)

    # Viterbi over states {unvoiced} + candidates
    S = max_candidates + 1     # state 0 = unvoiced
    INF = 1e30
    cost = np.full((n_frames, S), INF)
    back = np.zeros((n_frames, S), np.int32)
    # emission costs for all frames at once: state 0 = unvoiced
    emits = np.full((n_frames, S), INF)
    emits[:, 0] = unvoiced_cost
    valid = refined > 0
    emits[:, 1:][valid] = 1.0 - score[valid]
    cost[0] = emits[0]
    logf = np.log(np.maximum(refined, 1e-9))          # (F, K)
    srange = np.arange(S)
    for t in range(1, n_frames):
        trans = np.full((S, S), unvoiced_cost)        # voicing switches
        trans[0, 0] = 0.0
        trans[1:, 1:] = transition_cost * np.abs(
            logf[t][:, None] - logf[t - 1][None, :])
        tot = cost[t - 1][None, :] + trans            # (s, p)
        bp = np.argmin(tot, axis=1)
        back[t] = bp
        cost[t] = tot[srange, bp] + emits[t]
    # backtrack
    f0 = np.zeros(n_frames)
    s = int(np.argmin(cost[-1]))
    for t in range(n_frames - 1, -1, -1):
        f0[t] = refined[t, s - 1] if s > 0 else 0.0
        s = int(back[t, s])

    # drop very short voiced runs (Harvest's final cleaning)
    min_frames = max(1, int(round(30.0 / frame_period)))
    i = 0
    while i < n_frames:
        if f0[i] > 0:
            j = i
            while j < n_frames and f0[j] > 0:
                j += 1
            if j - i < min_frames:
                f0[i:j] = 0.0
            i = j
        else:
            i += 1
    return f0, time_axis
