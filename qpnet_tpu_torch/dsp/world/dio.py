"""DIO fundamental-frequency estimator (Morise 2009/2010, the WORLD `dio`).

Algorithm structure (faithful to WORLD dio.cc, vectorized in numpy):
  1. low-cut the signal (FFT-domain high-pass at 50 Hz);
  2. per octave-spaced candidate band: zero-phase low-pass with a Nuttall
     FIR at the band's boundary frequency, then derive four event-interval
     tracks (negative/positive zero crossings, peaks, dips);
  3. each band yields per-frame candidate F0 = mean of the four interval
     estimates and reliability = their stddev; the best band per frame
     minimizes stddev/candidate;
  4. contour fixing: kill frames with unreliable candidates or out-of-range
     values, remove too-short voiced runs, and trim segment edges whose
     step-to-step change exceeds `allowed_range`.

Returned F0 is 0 for unvoiced frames, one frame per `frame_period` ms.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from qpnet_tpu_torch.dsp.world.common import next_pow2, nuttall


def _smooth_even_length(n: int) -> int:
    """Smallest even 5-smooth (2^a 3^b 5^c) integer >= n — pocketfft is
    O(n log n) only for smooth lengths."""
    m = n + (n & 1)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 2


def decimation_plan(n: int, fs: int, f0_ceil: float,
                    oversample: float = 10.0) -> Tuple[int, int, float, int]:
    """Static geometry of the f0-ceiling decimation: (fftl, m, fs_d, n_d).

    m == fftl means "no decimation".  Shared by the host path below and
    the device pipeline (device_f0), which takes the plan as a constant.
    """
    fftl = next_pow2(n)
    target = oversample * f0_ceil
    if target >= fs:
        return fftl, fftl, float(fs), n
    m = _smooth_even_length(int(np.ceil(fftl * target / fs)))
    if m >= fftl:
        return fftl, fftl, float(fs), n
    return fftl, m, fs * m / fftl, int(n * m / fftl)


def decimate_for_f0(x: np.ndarray, fs: int, f0_ceil: float,
                    oversample: float = 10.0) -> Tuple[np.ndarray, float]:
    """FFT brick-wall decimation of `x` to ~oversample*f0_ceil Hz.

    Every candidate band low-passes below ~2*f0_ceil, so event detection
    only needs a few samples per period of the highest candidate; WORLD's
    own harvest runs candidate estimation on an 8 kHz decimation of the
    input (harvest.cc GetRawF0Candidates) for the default 800 Hz ceiling.
    Returns (x_decimated, fs_decimated); a no-op when fs is already low.
    """
    n = len(x)
    fftl, m, fs_d, n_d = decimation_plan(n, fs, f0_ceil, oversample)
    if m >= fftl:
        return x, float(fs)
    X = np.fft.rfft(x, fftl)
    xd = np.fft.irfft(X[: m // 2 + 1], m) * (m / fftl)
    return xd[:n_d], fs_d


def _low_cut_fft(x: np.ndarray, fs: int, cutoff: float = 50.0) -> np.ndarray:
    n = len(x)
    fftl = next_pow2(n)
    X = np.fft.rfft(x, fftl)
    f = np.fft.rfftfreq(fftl, 1.0 / fs)
    # smooth edge to avoid ringing
    gain = np.clip((f - cutoff / 2) / (cutoff / 2), 0.0, 1.0)
    return np.fft.irfft(X * gain, fftl)[:n]


class _SpectrumCache:
    """One forward FFT of the signal shared across all candidate bands.

    The per-band low-pass is a frequency-domain multiply; recomputing
    rfft(x) for each of up to ~84 harvest channels dominated analysis cost.
    The cache uses a single padded length covering the longest filter.
    """

    def __init__(self, x: np.ndarray, fs: float, min_boundary_f0: float):
        max_filter_half = int(round(fs / min_boundary_f0 / 2.0))
        self.n = len(x)
        self.fftl = next_pow2(self.n + 2 * max_filter_half + 1)
        self.X = np.fft.rfft(x, self.fftl)
        self.fs = fs

    def _response(self, boundary_f0: float) -> np.ndarray:
        """Zero-phase response of the band's Nuttall-windowed sinc filter,
        evaluated on a coarse FFT grid and interpolated to the signal grid
        (a full-length filter FFT per band dominated analysis cost)."""
        filter_length_half = int(round(self.fs / boundary_f0 / 2.0))
        w = nuttall(filter_length_half * 2 + 1)
        t = np.arange(-filter_length_half, filter_length_half + 1)
        lpf = np.sinc(2 * boundary_f0 * t / self.fs) * w
        lpf /= lpf.sum()
        coarse = max(8192, next_pow2(len(lpf) * 2))
        Hc = np.fft.rfft(np.roll(np.concatenate(
            [lpf, np.zeros(coarse - len(lpf))]), -filter_length_half)).real
        fc = np.linspace(0.0, 0.5, len(Hc))
        fx = np.linspace(0.0, 0.5, self.fftl // 2 + 1)
        return np.interp(fx, fc, Hc)

    def band_lowpass(self, boundary_f0: float) -> np.ndarray:
        return np.fft.irfft(self.X * self._response(boundary_f0),
                            self.fftl)[: self.n]

    def band_lowpass_many(self, boundary_f0s) -> np.ndarray:
        """(n_ch, n) band-filtered copies via ONE batched inverse FFT —
        the per-channel irfft was the dominant cost of dio/harvest.

        Runs in float32: the bands only locate zero-crossing/peak events
        whose times are refined later against the full-rate float64 signal
        (refine.py), so single precision costs nothing downstream and
        halves the dominant irfft."""
        H = self._responses_batched(boundary_f0s).astype(np.float32)
        X32 = self.X.astype(np.complex64)
        return np.fft.irfft(X32[None, :] * H, self.fftl,
                            axis=-1)[:, : self.n]

    def _responses_batched(self, boundary_f0s) -> np.ndarray:
        """(n_ch, fftl//2+1) exact zero-phase responses via ONE batched
        filter FFT at the signal grid (the per-channel coarse-grid rfft +
        interp of _response dominated once the signal itself was
        decimated)."""
        return band_lowpass_responses(boundary_f0s, self.fs, self.fftl)


def band_lowpass_responses(boundary_f0s, fs: float,
                           fftl: int) -> np.ndarray:
    """(n_ch, fftl//2+1) zero-phase Nuttall-windowed-sinc band low-pass
    responses on the signal grid — the candidate filter bank shared by
    the host estimators (via _SpectrumCache) and the device pipeline
    (device_f0, where it is a cached constant)."""
    kernels = np.zeros((len(boundary_f0s), fftl))
    for c, boundary_f0 in enumerate(boundary_f0s):
        half = int(round(fs / boundary_f0 / 2.0))
        w = nuttall(half * 2 + 1)
        t = np.arange(-half, half + 1)
        lpf = np.sinc(2 * boundary_f0 * t / fs) * w
        lpf /= lpf.sum()
        kernels[c, t % fftl] = lpf           # centered at sample 0
    return np.fft.rfft(kernels, axis=-1).real


def _band_lowpass(x: np.ndarray, fs: int, boundary_f0: float) -> np.ndarray:
    """Single-band convenience wrapper around _SpectrumCache."""
    return _SpectrumCache(x, fs, boundary_f0).band_lowpass(boundary_f0)


def _event_times(sig: np.ndarray, fs: float, kind: str) -> np.ndarray:
    """Times (s) of zero-crossing events ("negzc"/"poszc").  Peak/dip
    events are derived by the callers from the derivative signal with a
    +0.5-sample offset (the derivative lives between samples)."""
    s0, s1 = sig[:-1], sig[1:]
    if kind == "poszc":
        idx = np.where((s0 < 0) & (s1 >= 0))[0]
    else:
        idx = np.where((s0 > 0) & (s1 <= 0))[0]
    if len(idx) == 0:
        return np.zeros(0)
    frac = s0[idx] / (s0[idx] - s1[idx] + 1e-30)
    return (idx + frac) / fs


def _interval_f0_track(times: np.ndarray, frame_times: np.ndarray
                       ) -> np.ndarray:
    """Event times -> instantaneous F0 at event midpoints, interpolated to
    frame times; 0 where undefined."""
    if len(times) < 3:
        return np.zeros(len(frame_times))
    intervals = np.diff(times)
    centers = (times[:-1] + times[1:]) / 2
    good = intervals > 1e-6
    if good.sum() < 2:
        return np.zeros(len(frame_times))
    f0 = 1.0 / intervals[good]
    out = np.interp(frame_times, centers[good], f0)
    out[frame_times < centers[good][0]] = f0[0]
    out[frame_times > centers[good][-1]] = f0[-1]
    return out


def _band_candidate(x_band: np.ndarray, fs: float, boundary_f0: float,
                    f0_floor: float, f0_ceil: float,
                    frame_times: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One band's (candidate_f0, reliability) per frame."""
    tracks = []
    for kind in ("negzc", "poszc", "peak", "dip"):
        if kind in ("peak", "dip"):
            d = np.diff(x_band)
            sig = d
            s0, s1 = sig[:-1], sig[1:]
            if kind == "peak":
                idx = np.where((s0 > 0) & (s1 <= 0))[0]
            else:
                idx = np.where((s0 < 0) & (s1 >= 0))[0]
            if len(idx) == 0:
                tracks.append(np.zeros(len(frame_times)))
                continue
            frac = s0[idx] / (s0[idx] - s1[idx] + 1e-30)
            times = (idx + 0.5 + frac) / fs
            tracks.append(_interval_f0_track(times, frame_times))
        else:
            times = _event_times(x_band, fs, kind)
            tracks.append(_interval_f0_track(times, frame_times))
    tr = np.stack(tracks)  # (4, F)
    cand = tr.mean(axis=0)
    rel = tr.std(axis=0)
    # out-of-band or out-of-range candidates are unreliable
    bad = ((cand <= boundary_f0 / 2) | (cand > boundary_f0 * 2)
           | (cand < f0_floor) | (cand > f0_ceil) | np.any(tr <= 0, axis=0))
    rel = np.where(bad, np.inf, rel)
    cand = np.where(bad, 0.0, cand)
    return cand, rel


def _select_best_f0(current: float, past: float, frame_cands: np.ndarray,
                    allowed_range: float) -> float:
    """Candidate closest to the half-step linear extrapolation of the
    contour; 0 when even the best disagrees by more than allowed_range
    (WORLD dio.cc SelectBestF0)."""
    reference = (current * 3.0 - past) / 2.0
    errors = np.abs(reference - frame_cands)
    best = int(np.argmin(errors))
    if errors[best] / max(reference, 1e-12) >= allowed_range:
        return 0.0
    return float(frame_cands[best])


def _fix_contour(f0: np.ndarray, cands: np.ndarray, frame_period_ms: float,
                 allowed_range: float = 0.1,
                 f0_floor: float = 71.0) -> np.ndarray:
    """WORLD FixF0Contour (dio.cc steps 1-4).

    Steps 1-2 aggressively erode: any frame whose step-to-step change
    exceeds `allowed_range` (including every voiced onset, where the
    previous frame is 0) and any frame within half a voice-range window of
    an unvoiced frame go to 0.  Steps 3-4 then re-extend each surviving
    voiced section forward/backward, one frame at a time, accepting the
    band candidate that best matches the extrapolated contour — recovering
    the eroded onsets/offsets only where the candidate pool agrees.

    cands: (n_bands, n_frames) per-band candidate F0s (0 where invalid).
    """
    n = len(f0)
    vrm = int(0.5 + 1000.0 / frame_period_ms / f0_floor) * 2 + 1
    if n <= vrm:
        return f0.copy()

    # step 1: erode discontinuities (onsets included: prev==0 -> ratio ~ 1)
    step1 = f0.copy()
    step1[:vrm] = 0.0
    prev = np.concatenate([[0.0], f0[:-1]])
    rel = np.abs(f0 - prev) / (1e-12 + f0)
    step1[rel >= allowed_range] = 0.0

    # step 2: a frame is voiced only if its whole +-vrm/2 window is voiced
    half = vrm // 2
    step2 = step1.copy()
    voiced = (step1 > 0).astype(np.float64)
    window_ok = np.convolve(voiced, np.ones(vrm), mode="valid") >= vrm
    step2[half: n - half][~window_ok[: n - 2 * half]] = 0.0

    # voiced-section boundaries on step2
    v = step2 > 0
    starts = np.where(v[1:] & ~v[:-1])[0] + 1     # first voiced frame
    ends = np.where(~v[1:] & v[:-1])[0]           # last voiced frame
    if v[0]:
        starts = np.concatenate([[0], starts])
    if v[-1]:
        ends = np.concatenate([ends, [n - 1]])

    # step 3: extend each section forward until candidates disagree
    step3 = step2.copy()
    for i, e in enumerate(ends):
        limit = n - 1 if i == len(ends) - 1 else int(starts[i + 1]) - 1 \
            if i + 1 < len(starts) else n - 1
        for j in range(int(e), min(limit, n - 2) + 1):
            if j < 1:
                break
            step3[j + 1] = _select_best_f0(step3[j], step3[j - 1],
                                           cands[:, j + 1], allowed_range)
            if step3[j + 1] == 0.0:
                break

    # step 4: extend each section backward
    step4 = step3.copy()
    for i in range(len(starts) - 1, -1, -1):
        s = int(starts[i])
        limit = 1 if i == 0 else int(ends[i - 1]) + 1
        for j in range(s, limit, -1):
            if j > n - 2:
                continue
            step4[j - 1] = _select_best_f0(step4[j], step4[j + 1],
                                           cands[:, j - 1], allowed_range)
            if step4[j - 1] == 0.0:
                break
    return step4


def dio(x: np.ndarray, fs: int, f0_floor: float = 71.0,
        f0_ceil: float = 800.0, frame_period: float = 5.0,
        channels_in_octave: float = 2.0,
        allowed_range: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """Estimate F0. Returns (f0, time_axis); f0==0 marks unvoiced frames."""
    x = np.asarray(x, np.float64)
    n_frames = int(len(x) / (fs * frame_period / 1000.0)) + 1
    time_axis = np.arange(n_frames) * frame_period / 1000.0
    xlc = _low_cut_fft(x, fs, 50.0)

    n_bands = 1 + int(np.log2(f0_ceil / f0_floor) * channels_in_octave)
    boundary_f0s = f0_floor * (2.0 ** ((np.arange(n_bands) + 1)
                                       / channels_in_octave))
    cands = np.zeros((n_bands, n_frames))
    rels = np.full((n_bands, n_frames), np.inf)
    xd, fs_d = decimate_for_f0(xlc, fs, f0_ceil)
    cache = _SpectrumCache(xd, fs_d, float(boundary_f0s[0]))
    xbs = cache.band_lowpass_many(boundary_f0s)   # one batched inverse FFT
    for b, bf0 in enumerate(boundary_f0s):
        cands[b], rels[b] = _band_candidate(
            xbs[b], fs_d, bf0, f0_floor, f0_ceil, time_axis)

    # best band per frame: minimal normalized reliability
    score = rels / np.maximum(cands, 1e-9)
    best = np.argmin(score, axis=0)
    f0 = cands[best, np.arange(n_frames)]
    best_rel = rels[best, np.arange(n_frames)] / np.maximum(f0, 1e-9)
    f0 = np.where(best_rel < allowed_range, f0, 0.0)
    f0 = _fix_contour(f0, cands, frame_period, allowed_range,
                      f0_floor=f0_floor)
    return f0, time_axis
