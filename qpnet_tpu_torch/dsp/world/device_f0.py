"""Device F0 estimation in plain PyTorch: harvest and dio+stonemask.

The port of `qpnet_tpu/dsp/world/jax_f0.py`.  Every function runs in float32
on the device its input tensor lies on (an array that is not a tensor goes
to `device`, CUDA by default), with the JAX module's stages and contracts:

  * candidate-band filtering: the per-band Nuttall-sinc low-pass bank is a
    constant of (length, fs, F0 range), built on the host once and cached
    on the device, so all channels reduce to one broadcast spectrum
    multiply and one batched irfft;
  * event-interval tracks: `cummax` of masked event times gives "previous
    event", a flipped `cummin` gives "next event", and the straddling
    interval 1/(next-prev) is sampled at frame centers;
  * candidate pooling: a stable per-frame sort over channels, then the
    walk over channel ranks carrying the (F, K) pooled table (kernel W1);
  * refinement: the StoneMask instantaneous-frequency correction as
    windowed DFTs at the 6 harmonic frequencies over a static slot;
  * contour: the {unvoiced + K candidates} Viterbi (kernel W2), and the
    short-run cleanup as two index prefix scans.

The sequential stages (the pooling over ranks, the Viterbi, DIO's contour
loops) are one launch each of `ops/world_kernel.py`'s kernels on the card,
and their plain PyTorch versions on the CPU.  Nothing comes back to the
host until the caller fetches the result.  Ties are broken as JAX breaks
them: sorts are stable and `argmin`/`min` take the first index.
"""

from __future__ import annotations

import contextlib
import functools
import math
import time

import numpy as np
import torch

from qpnet_tpu_torch.dsp.world.common import next_pow2
from qpnet_tpu_torch.dsp.world.dio import (band_lowpass_responses,
                                           decimation_plan)
from qpnet_tpu_torch.ops import world_kernel

_NEG = -1e30
_POS = 1e30
N_HARMONICS = 6


def as_signal(x, device="cuda") -> torch.Tensor:
    """A float32 tensor of x: a tensor stays on its device, an array goes to
    `device` (CUDA unless the caller asks for the CPU)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    from qpnet_tpu_torch.models.qpnet import resolve_device
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=resolve_device(device))


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """num / t as one IEEE division (a Python scalar over a tensor is
    `t.reciprocal() * num` in PyTorch, which rounds twice)."""
    return torch.div(torch.full_like(t, num), t)


def frame_axis(F: int, frame_period: float, device) -> torch.Tensor:
    """np.arange(F) * (frame_period / 1000) in float64, cast to float32 —
    the axis JAX builds on the host and casts once."""
    return (torch.arange(F, dtype=torch.float64, device=device)
            * (frame_period / 1000.0)).to(torch.float32)


# Stage marks: while `stage_marks()` is open, the device pass records a
# CUDA event (on the CPU, a host clock reading) at the end of each stage,
# so that one call's time splits by stage.  Off, a mark costs one test.
_MARKS = None


@contextlib.contextmanager
def stage_marks():
    """Collect [(stage, event or seconds), ...] from the passes run inside;
    `marks_ms` turns them into each stage's ms."""
    global _MARKS
    _MARKS = marks = []
    try:
        yield marks
    finally:
        _MARKS = None


def mark(stage: str, device: torch.device) -> None:
    """The end of `stage` on `device`, when stage_marks() is open."""
    if _MARKS is None:
        return
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        _MARKS.append((stage, ev))
    else:
        _MARKS.append((stage, time.perf_counter()))


def marks_ms(marks) -> list:
    """[(stage, ms from the previous mark), ...] for every mark after the
    first; CUDA events must have completed (synchronize first)."""
    return [(s1, t0.elapsed_time(t1) if isinstance(t0, torch.cuda.Event)
             else (t1 - t0) * 1e3)
            for (_, t0), (s1, t1) in zip(marks, marks[1:])]


def fmod_floor(a: torch.Tensor, b: float) -> torch.Tensor:
    """jnp.mod: the remainder with the sign of the divisor (b > 0)."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & (r < 0), r + b, r)


# ---------------------------------------------------------------------------
# constants: the host estimators' decimation geometry and filter bank
# ---------------------------------------------------------------------------

def _boundaries(f0_floor: float, f0_ceil: float,
                channels_in_octave: float) -> np.ndarray:
    n_ch = 1 + int(np.log2(f0_ceil / f0_floor) * channels_in_octave)
    return f0_floor * 2.0 ** ((np.arange(n_ch) + 1) / channels_in_octave)


@functools.lru_cache(maxsize=8)
def _band_bank(n_d: int, fs_d: float, f0_floor: float, f0_ceil: float,
               channels_in_octave: float, device: torch.device):
    """(fftl_d, (n_ch, fftl_d//2+1) float32 responses on the device,
    (n_ch, 1) float32 boundaries) sized like dio._SpectrumCache: padded
    past the longest (lowest-band) filter."""
    boundaries = _boundaries(f0_floor, f0_ceil, channels_in_octave)
    max_half = int(round(fs_d / boundaries[0] / 2.0))
    fftl_d = next_pow2(n_d + 2 * max_half + 1)
    H = band_lowpass_responses(boundaries, fs_d, fftl_d)
    return (fftl_d, torch.as_tensor(H.astype(np.float32), device=device),
            torch.as_tensor(boundaries.astype(np.float32),
                            device=device)[:, None])


# ---------------------------------------------------------------------------
# event-interval tracks as prefix scans
# ---------------------------------------------------------------------------

def _straddle_track(sig, fs_d: float, centers, mask, offset: float):
    """F0 track at frame-center samples from one event type
    (jax_f0._straddle_track).

    sig: (C, n) band signals; centers: (F,) sample indices at fs_d; mask:
    (C, n-1) event-between-samples mask; the event time is
    (i + offset + frac)/fs_d with frac the linear zero-crossing position.
    Returns (C, F) f0 values (0 where undefined)."""
    s0, s1 = sig[:, :-1], sig[:, 1:]
    frac = s0 / (s0 - s1 + 1e-30)
    i = torch.arange(s0.shape[1], dtype=torch.float32, device=sig.device)
    t_ev = torch.where(mask, (i[None, :] + offset + frac) / fs_d, 0.0)

    prev = torch.cummax(torch.where(mask, t_ev, _NEG), dim=1).values
    nxt = torch.flip(torch.cummin(torch.flip(
        torch.where(mask, t_ev, _POS), [1]), dim=1).values, [1])

    # frame center c: previous event at sample <= c-1, next at sample >= c
    c = centers.clamp(1, s0.shape[1] - 1)
    p = prev[:, c - 1]                                  # (C, F)
    q = nxt[:, c]
    interval = q - p
    ok = (p > _NEG / 2) & (q < _POS / 2) & (interval > 1e-6)
    f0 = torch.where(ok, rdiv(1.0, interval.clamp_min(1e-6)), 0.0)
    # the host's "needs >= 3 events" guard per channel
    enough = mask.sum(dim=1) >= 3
    return torch.where(enough[:, None], f0, 0.0)


def _channel_tracks(xbs, fs_d: float, centers):
    """(4, C, F) tracks: negzc / poszc / peak / dip (dio.py order)."""
    def neg(a, b):
        return (a > 0) & (b <= 0)

    def pos(a, b):
        return (a < 0) & (b >= 0)

    d = xbs[:, 1:] - xbs[:, :-1]
    return torch.stack([
        _straddle_track(xbs, fs_d, centers, neg(xbs[:, :-1], xbs[:, 1:]), 0.0),
        _straddle_track(xbs, fs_d, centers, pos(xbs[:, :-1], xbs[:, 1:]), 0.0),
        _straddle_track(d, fs_d, centers, neg(d[:, :-1], d[:, 1:]), 0.5),
        _straddle_track(d, fs_d, centers, pos(d[:, :-1], d[:, 1:]), 0.5)])


def _mask_valid(x, n_valid):
    n = x.shape[0]
    if n_valid is None:
        return x, n
    return torch.where(torch.arange(n, device=x.device) < n_valid, x,
                       0.0), n_valid


def _candidate_tracks(x, fs: int, n_valid, f0_floor: float, f0_ceil: float,
                      frame_period: float, channels_in_octave: float):
    """Shared candidate front-end of the device estimators
    (jax_f0._candidate_tracks): 50 Hz low-cut, f0_ceil decimation,
    Nuttall-sinc band bank, four event-interval tracks.

    Returns (tracks (4, C, F), boundaries (C, 1), frame_times (F,), masked
    full-rate signal)."""
    dev = x.device
    x, _ = _mask_valid(x, n_valid)
    n = x.shape[0]

    frame_shift = fs * frame_period / 1000.0
    F = int(n / frame_shift) + 1
    frame_times = (torch.arange(F, dtype=torch.float32, device=dev)
                   * (frame_period / 1000.0))

    # low-cut (50 Hz) + decimation in one spectrum pass
    fftl, m, fs_d, n_d = decimation_plan(n, fs, f0_ceil)
    X = torch.fft.rfft(x, fftl)
    f = torch.fft.rfftfreq(fftl, 1.0 / fs, device=dev)
    gain = torch.clamp((f - 25.0) / 25.0, 0.0, 1.0)    # 50 Hz low-cut
    Xg = X * gain
    if m < fftl:
        xd = torch.fft.irfft(Xg[: m // 2 + 1], m) * (m / fftl)
        xd = xd[:n_d]
    else:
        xd = torch.fft.irfft(Xg, fftl)[:n]

    # candidate channels: one batched spectrum multiply + irfft
    fftl_d, H, bnd = _band_bank(n_d, float(fs_d), float(f0_floor),
                                float(f0_ceil), float(channels_in_octave),
                                dev)
    Xd = torch.fft.rfft(xd, fftl_d)
    xbs = torch.fft.irfft(Xd[None, :] * H, fftl_d, dim=-1)[:, :n_d]

    centers = torch.round(frame_times * fs_d).long().clamp(0, n_d - 1)
    return _channel_tracks(xbs, fs_d, centers), bnd, frame_times, x


def _screen(tr, bnd, f0_floor: float, f0_ceil: float):
    """(cand, std, bad): the tracks' mean and population spread per
    (channel, frame), as jnp.mean and jnp.std take them, and the
    candidates out of range, out of band or with a missing track."""
    cand = tr.mean(dim=0)
    std = torch.sqrt(((tr - cand) ** 2).mean(dim=0))
    bad = ((cand < f0_floor) | (cand > f0_ceil)
           | (cand <= bnd / 2) | (cand > bnd * 2)
           | torch.any(tr <= 0, dim=0))
    return cand, std, bad


# ---------------------------------------------------------------------------
# pooling, refinement, contour
# ---------------------------------------------------------------------------

def _pool_candidates(cands, spreads, agreement_threshold: float,
                     max_candidates: int):
    """Best-agreeing, ~5%-deduped candidates per frame: (F, K)
    (jax_f0._pool_candidates; the sort is stable, as jnp.argsort is, and
    stays outside the loop over ranks, kernel W1)."""
    order = torch.argsort(spreads, dim=0, stable=True)
    return world_kernel.pool(torch.gather(cands, 0, order),
                             torch.gather(spreads, 0, order),
                             agreement_threshold, max_candidates)


def _refine(x, fs: int, frame_times, pooled, f0_floor: float,
            f0_ceil: float, n_valid: int, clamp_range: bool = True):
    """StoneMask IF refinement of every pooled candidate (jax_f0._refine).

    Windowed DFTs evaluated directly at harmonic frequencies over a static
    +-hw_max slot (the Blackman window is zero outside its per-query
    support, so one common slot is exact).
    Returns (refined (F, K), score (F, K))."""
    dev = x.device
    valid = pooled > 0
    f0c = torch.where(valid, pooled, 100.0)             # (F, K)
    hw = rdiv(1.5 * fs, f0c).to(torch.int32) + 1
    hw_max = int(1.5 * fs / f0_floor) + 1

    centers = torch.round(frame_times * fs).long()      # (F,)
    offs = torch.arange(-hw_max, hw_max + 1, device=dev)  # (W,)
    idx = centers[:, None] + offs[None, :]              # (F, W)
    inside = (idx >= 0) & (idx < n_valid)
    seg = torch.where(inside, x[idx.clamp(0, x.shape[0] - 1)], 0.0)

    tt = offs[None, None, :] / hw[:, :, None]           # (F, K, W)
    w = torch.where(torch.abs(tt) <= 1.0,
                    0.42 + 0.5 * torch.cos(math.pi * tt)
                    + 0.08 * torch.cos(2 * math.pi * tt), 0.0)
    segw = seg[:, None, :] * w                          # (F, K, W)
    seg1 = torch.cat([seg[:, 1:], torch.zeros_like(seg[:, :1])], dim=1)
    segw1 = seg1[:, None, :] * w

    num = torch.zeros_like(f0c)
    den = torch.zeros_like(f0c)
    offs_f = offs.to(torch.float32)
    for h in range(N_HARMONICS):
        fk = f0c * (h + 1)                              # (F, K)
        ok = fk < fs / 2
        ph = (2 * math.pi / fs) * fk[:, :, None] * offs_f[None, None, :]
        cw, sw = torch.cos(ph), torch.sin(ph)
        re1 = torch.sum(segw * cw, dim=-1)
        im1 = -torch.sum(segw * sw, dim=-1)
        re2 = torch.sum(segw1 * cw, dim=-1)
        im2 = -torch.sum(segw1 * sw, dim=-1)
        # phase advance over one sample -> instantaneous frequency
        cross_im = im2 * re1 - re2 * im1
        cross_re = re2 * re1 + im2 * im1
        inst = torch.atan2(cross_im, cross_re) * fs / (2 * math.pi)
        dev_ = fmod_floor(inst - fk + fs / 2, fs) - fs / 2
        inst = fk + dev_
        pk = torch.where(ok, torch.sqrt(re1 * re1 + im1 * im1), 0.0)
        num = num + pk * torch.where(ok, inst, 0.0) / float(h + 1)
        den = den + pk
    refined = torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)
    bad = (~valid) | (refined <= 0) | (refined < f0c * 0.5) \
        | (refined > f0c * 2.0)
    if clamp_range:
        # harvest rejects refinements leaving the analysis range; the
        # stonemask contract (refine.py) keeps them (only the octave test)
        bad = bad | (refined < f0_floor) | (refined > f0_ceil)
    refined = torch.where(bad, 0.0, refined)
    score = torch.where(refined > 0, torch.clamp_min(
        1.0 - 5.0 * torch.abs(refined - pooled) / pooled.clamp_min(1e-9),
        0.0), 0.0)
    return refined, score


def _viterbi(refined, score, transition_cost: float,
             unvoiced_cost: float):
    """Contour tracking over {unvoiced + K candidates}; returns (F,) f0
    (jax_f0._viterbi: its forward and back-track scans are kernel W2)."""
    F = refined.shape[0]
    emits = torch.cat([torch.full((F, 1), unvoiced_cost,
                                  device=refined.device),
                       torch.where(refined > 0, 1.0 - score, 1e30)], dim=1)
    logf = torch.log(refined.clamp_min(1e-9))           # (F, K)
    return world_kernel.viterbi(emits, logf, refined, transition_cost,
                                unvoiced_cost)


def _drop_short_runs(f0, min_frames: int):
    """Zero voiced runs shorter than min_frames (two index prefix scans)."""
    v = f0 > 0
    n = f0.shape[0]
    iota = torch.arange(n, device=f0.device)
    true = torch.ones(1, dtype=torch.bool, device=f0.device)
    onset = v & torch.cat([true, ~v[:-1]])
    start = torch.cummax(torch.where(onset, iota, -1), dim=0).values
    offset = v & torch.cat([~v[1:], true])
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(offset, iota, n), [0]), dim=0).values, [0])
    return torch.where(v & (end - start + 1 < min_frames), 0.0, f0)


# ---------------------------------------------------------------------------
# public entries
# ---------------------------------------------------------------------------

def device_harvest(x, fs: int, n_valid=None, f0_floor: float = 71.0,
                   f0_ceil: float = 800.0, frame_period: float = 5.0,
                   channels_in_octave: float = 24.0,
                   agreement_threshold: float = 0.10,
                   max_candidates: int = 6, transition_cost: float = 8.0,
                   unvoiced_cost: float = 0.35,
                   device="cuda") -> torch.Tensor:
    """Device F0 track, the port of jax_f0.jax_harvest; same contract as
    harvest.harvest.

    x: (n,) waveform, optionally zero-padded to a bucketed length;
    n_valid: true signal length — samples beyond are ignored.
    Returns (F,) f0 where F = n//(fs*frame_period/1000)+1 for the PADDED
    length; callers slice to the true frame count.

    On the card max_candidates runs from 1 to world_kernel.MAX_POOL = 255
    (W1; the Viterbi's K + 1 states up to MAX_STATES = 256, W2, whose
    back-pointers are uint8) and the channel ranks, 1 + int(log2(f0_ceil /
    f0_floor) * channels_in_octave), up to world_kernel.pool_max_ranks(K);
    past those W1 or W2 raises ValueError naming the limit.  On the CPU
    the plain versions take any shape."""
    x = as_signal(x, device)
    n_valid = x.shape[0] if n_valid is None else int(n_valid)
    tr, bnd, frame_times, x = _candidate_tracks(
        x, fs, n_valid, f0_floor, f0_ceil, frame_period, channels_in_octave)
    cand, std, bad = _screen(tr, bnd, f0_floor, f0_ceil)
    # a screened-out candidate is 0 with spread _POS
    spread = torch.where(bad, _POS, std / cand.clamp_min(1e-9))
    cand = torch.where(bad, 0.0, cand)
    mark("F0 candidates", x.device)
    pooled = _pool_candidates(cand, spread, agreement_threshold,
                              max_candidates)           # (F, K)
    mark("F0 pooling loop", x.device)
    refined, score = _refine(x, fs, frame_times, pooled, f0_floor, f0_ceil,
                             n_valid)
    mark("F0 refinement", x.device)
    f0 = _viterbi(refined, score, transition_cost, unvoiced_cost)
    mark("F0 Viterbi loop", x.device)
    f0 = _drop_short_runs(f0, max(1, int(round(30.0 / frame_period))))
    mark("F0 short runs", x.device)
    return f0


def _fix_contour_scan(f0, cands, frame_period: float, allowed_range: float,
                      f0_floor: float):
    """dio._fix_contour (WORLD FixF0Contour steps 1-4) as array ops and a
    forward and a backward walk over frames, kernel W3
    (jax_f0._fix_contour_scan).

    Steps 1-2 (erode discontinuities, require a fully-voiced +-vrm/2
    window) are sliding-window masks.  Steps 3-4 (re-extend each voiced
    section forward/backward one frame at a time, accepting the band
    candidate nearest the extrapolated contour) carry (prev2, prev1,
    alive, was_gap) through the walks; the comments of the JAX scan give
    the host walk's semantics they reproduce.

    cands: (C, F) per-band candidates (0 where invalid)."""
    n = f0.shape[0]
    vrm = int(0.5 + 1000.0 / frame_period / f0_floor) * 2 + 1
    if n <= vrm:
        return f0
    half = vrm // 2
    dev = f0.device
    iota = torch.arange(n, device=dev)

    # step 1: erode discontinuities (voiced onsets included)
    prev = torch.cat([torch.zeros(1, device=dev), f0[:-1]])
    rel = torch.abs(f0 - prev) / (1e-12 + f0)
    step1 = torch.where((iota < vrm) | (rel >= allowed_range), 0.0, f0)

    # step 2: voiced only if the whole +-half window is voiced
    voiced = (step1 > 0).to(torch.float32)
    csum = torch.cat([torch.zeros(1, device=dev), torch.cumsum(voiced, 0)])
    window_ok = (csum[vrm:] - csum[:-vrm]) >= vrm       # (n-vrm+1,)
    ones = torch.ones(half, dtype=torch.bool, device=dev)
    keep = torch.cat([ones, window_ok, ones])
    step2 = torch.where(keep, step1, 0.0)

    return world_kernel.fix_contour(step2, cands.T, allowed_range)


def device_dio(x, fs: int, n_valid=None, f0_floor: float = 71.0,
               f0_ceil: float = 800.0, frame_period: float = 5.0,
               channels_in_octave: float = 2.0, allowed_range: float = 0.1,
               device="cuda") -> torch.Tensor:
    """Device DIO F0 track, the port of jax_f0.jax_dio; same contract as
    dio.dio (without the time axis, which frame_period implies).

    Shares the candidate front-end with device_harvest; DIO's selection is
    the per-frame best band (minimal normalized interval spread), then the
    FixF0Contour loops.

    On the card the band count C = 1 + int(log2(f0_ceil / f0_floor) *
    channels_in_octave) runs from 1 to world_kernel.MAX_CANDS = 256 (W3);
    past it W3 raises ValueError naming the limit.  On the CPU the plain
    version takes any C."""
    x = as_signal(x, device)
    tr, bnd, _, _ = _candidate_tracks(
        x, fs, n_valid, f0_floor, f0_ceil, frame_period, channels_in_octave)
    cand, rel, bad = _screen(tr, bnd, f0_floor, f0_ceil)
    cand = torch.where(bad, 0.0, cand)
    rel = torch.where(bad, _POS, rel)

    score = rel / cand.clamp_min(1e-9)
    best = torch.argmin(score, dim=0)[None, :]          # first index on ties
    f0 = torch.gather(cand, 0, best)[0]
    best_rel = torch.gather(rel, 0, best)[0] / f0.clamp_min(1e-9)
    f0 = torch.where(best_rel < allowed_range, f0, 0.0)
    return _fix_contour_scan(f0, cand, frame_period, allowed_range, f0_floor)


def device_stonemask(x, f0, fs: int, n_valid=None, f0_floor: float = 71.0,
                     f0_ceil: float = 800.0, frame_period: float = 5.0,
                     device="cuda") -> torch.Tensor:
    """Device StoneMask, the port of jax_f0.jax_stonemask: two
    instantaneous-frequency refinement passes; only the octave divergence
    test rejects.  f0_floor sizes the static window slot for pass 2, whose
    pass-1 values may sit as low as f0_floor/2."""
    x = as_signal(x, device)
    x, n_valid = _mask_valid(x, n_valid)
    f0 = as_signal(f0, x.device)
    frame_times = frame_axis(f0.shape[0], frame_period, x.device)
    r1, _ = _refine(x, fs, frame_times, f0[:, None], f0_floor * 0.5,
                    f0_ceil, n_valid, clamp_range=False)
    r2, _ = _refine(x, fs, frame_times, r1, f0_floor * 0.5, f0_ceil,
                    n_valid, clamp_range=False)
    r1, r2 = r1[:, 0], r2[:, 0]
    return torch.where(r2 > 0, r2, r1)
