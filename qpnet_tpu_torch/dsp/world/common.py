"""Shared WORLD utilities: windows, minimum-phase spectra, interpolation."""

from __future__ import annotations

import numpy as np


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def nuttall(n: int) -> np.ndarray:
    """Nuttall window (WORLD's FIR prototype for band filtering)."""
    t = np.linspace(0, 1, n, endpoint=True) if n > 1 else np.zeros(1)
    return (0.355768 - 0.487396 * np.cos(2 * np.pi * t)
            + 0.144232 * np.cos(4 * np.pi * t)
            - 0.012604 * np.cos(6 * np.pi * t))


def minimum_phase_spectrum(log_amp_half: np.ndarray) -> np.ndarray:
    """Half log-amplitude spectrum (fftl//2+1,) -> complex minimum-phase
    spectrum of the same length (cepstral method)."""
    fftl = (len(log_amp_half) - 1) * 2
    c = np.fft.irfft(log_amp_half, n=fftl)
    # fold: double positive quefrencies, zero negative ones
    c[1: fftl // 2] *= 2.0
    c[fftl // 2 + 1:] = 0.0
    return np.exp(np.fft.rfft(c))


def safe_log(x: np.ndarray, floor: float = 1e-300) -> np.ndarray:
    return np.log(np.maximum(x, floor))


def matlab_round(x) -> int:
    """floor(x + 0.5) — WORLD rounds half away from zero for positives."""
    return int(np.floor(x + 0.5))


def get_windowed_waveform(x: np.ndarray, fs: int, f0: float, position: float,
                          window_type: str, length_ratio: float) -> np.ndarray:
    """F0-adaptive windowed segment around `position` seconds.

    WORLD's GetWindowedWaveform: half length = round(ratio*fs/f0/2), the
    window is evaluated on the *index offsets* (so a segment clipped at the
    signal edge keeps its window shape), and the window-weighted mean is
    subtracted so the segment has zero DC leak.  Used by CheapTrick and D4C
    (the reference reaches it through pyworld, feature_extract.py:324-327).
    """
    half = matlab_round(length_ratio * fs / f0 / 2.0)
    base = np.arange(-half, half + 1)
    origin = matlab_round(position * fs + 0.001)
    safe = np.clip(origin + base, 0, len(x) - 1)
    pos = (2.0 * base / length_ratio) / fs
    if window_type == "blackman":
        w = (0.42 + 0.5 * np.cos(np.pi * pos * f0)
             + 0.08 * np.cos(2.0 * np.pi * pos * f0))
    elif window_type == "hanning":
        w = 0.5 + 0.5 * np.cos(np.pi * pos * f0)
    else:
        raise ValueError(window_type)
    seg = x[safe] * w
    return seg - w * (seg.sum() / w.sum())


def dc_correction(spec_half: np.ndarray, f0: float, fs: int,
                  fft_size: int) -> np.ndarray:
    """Mirror the spectrum below f0 back onto itself (WORLD DCCorrection):
    bins under f0 get += linear interp of the spectrum at (f0 - f)."""
    out = spec_half.astype(np.float64).copy()
    upper_limit = 2 + int(f0 * fft_size / fs)
    n_rep = upper_limit - 1
    if n_rep <= 0:
        return out
    freqs = np.arange(n_rep) * fs / fft_size
    src = (f0 - freqs) * fft_size / fs          # fractional source bins
    i0 = np.clip(np.floor(src).astype(int), 0, len(out) - 2)
    frac = src - i0
    out[:n_rep] += out[i0] * (1.0 - frac) + out[i0 + 1] * frac
    return out


def linear_smoothing(spec_half: np.ndarray, width_hz: float, fs: int,
                     fft_size: int) -> np.ndarray:
    """Centered rectangular smoothing of width `width_hz` over the half
    spectrum, mirror-extended at DC and Nyquist (WORLD LinearSmoothing).

    Implemented as a direct fractional-box convolution rather than WORLD's
    cumulative-integral subtraction: with a ~150 dB dynamic range the cumsum
    difference cancels catastrophically and floors small bins to 0.
    """
    half = fft_size // 2
    bin_hz = fs / fft_size
    w_bins = width_hz / bin_hz
    lo, hi = -w_bins / 2.0, w_bins / 2.0
    m_lo = int(np.floor(lo))
    m_hi = int(np.ceil(hi))
    cells = np.arange(m_lo, m_hi)
    weights = np.clip(np.minimum(hi, cells + 1) - np.maximum(lo, cells),
                      0.0, None)
    weights /= weights.sum()
    pad = m_hi + 1
    ext = np.concatenate([spec_half[1: pad + 1][::-1], spec_half,
                          spec_half[-pad - 1: -1][::-1]])
    out = np.zeros(half + 1)
    base = pad  # ext[base + k] == spec_half[k]
    for j, c in enumerate(cells):
        out += weights[j] * ext[base + c: base + c + half + 1]
    return out
