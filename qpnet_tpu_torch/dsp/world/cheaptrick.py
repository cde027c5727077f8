"""CheapTrick spectral-envelope estimator (Morise 2015, WORLD `cheaptrick`).

Per voiced frame (unvoiced uses the default F0):
  1. pitch-synchronous Hanning window spanning 3 periods with the
     window-weighted mean removed (WORLD GetWindowedWaveform), normalized
     by the window energy;
  2. power spectrum, DC-corrected below f0 (the sub-f0 bins get the
     mirrored spectrum at f0-f added), then f0-adaptive *linear smoothing*
     (rectangular kernel of width 2/3*f0) to fill harmonic gaps;
  3. cepstral liftering: sinc smoothing lifter sin(pi*f0*tau)/(pi*f0*tau)
     and the spectral-recovery lifter q0 + 2*q1*cos(2*pi*f0*tau) with
     q1 = -0.15, q0 = 1 - 2*q1 (WORLD's kQ1; the original 2015 paper used
     -0.09, current WORLD revised it).

Returns a power spectrogram (F, fftl//2+1).  The reference reaches this
algorithm through pyworld via sprocket (feature_extract.py:324-327).
"""

from __future__ import annotations

import numpy as np

from qpnet_tpu_torch.dsp.world.common import dc_correction, safe_log

DEFAULT_F0 = 500.0
Q1 = -0.15  # WORLD kQ1 (cheaptrick.cpp); the 2015 paper's value was -0.09


def _windowed_power_spectrum(x: np.ndarray, fs: int, t: float, f0: float,
                             fftl: int) -> np.ndarray:
    half_window = int(1.5 * fs / f0 + 0.5)
    center = int(round(t * fs))
    idx = np.arange(center - half_window, center + half_window + 1)
    seg = np.zeros(len(idx))
    valid = (idx >= 0) & (idx < len(x))
    seg[valid] = x[idx[valid]]
    tt = (np.arange(len(seg)) - half_window) / fs
    w = 0.5 + 0.5 * np.cos(np.pi * tt * f0 / 1.5)
    windowed = seg * w
    windowed -= w * (windowed.sum() / w.sum())     # zero DC leak
    windowed /= np.sqrt(np.sum(w ** 2))
    ps = np.abs(np.fft.rfft(windowed, fftl)) ** 2
    return dc_correction(ps, f0, fs, fftl)


def _linear_smoothing(ps: np.ndarray, fs: int, fftl: int, width: float
                      ) -> np.ndarray:
    """Rectangular smoothing of the power spectrum over `width` Hz.

    Implemented as a direct fractional-box convolution on a mirrored axis
    (NOT the cumulative-integral trick: with a ~150 dB dynamic range the
    cumsum subtraction cancels catastrophically and floors small bins to 0).
    """
    half = fftl // 2
    bin_hz = fs / fftl
    w_bins = width / bin_hz
    lo, hi = -w_bins / 2.0, w_bins / 2.0
    m_lo = int(np.floor(lo))
    m_hi = int(np.ceil(hi))
    cells = np.arange(m_lo, m_hi)
    weights = np.clip(np.minimum(hi, cells + 1) - np.maximum(lo, cells),
                      0.0, None)
    weights /= weights.sum()
    pad = m_hi + 1
    # mirror-extend both edges (spectrum is symmetric around DC and Nyquist)
    ext = np.concatenate([ps[1: pad + 1][::-1], ps, ps[-pad - 1: -1][::-1]])
    out = np.zeros(half + 1)
    base = pad  # ext[base + k] == ps[k]
    for j, c in enumerate(cells):
        out += weights[j] * ext[base + c: base + c + half + 1]
    return out


def _lifter(log_ps: np.ndarray, fs: int, fftl: int, f0: float) -> np.ndarray:
    c = np.fft.irfft(log_ps, fftl)
    tau = np.arange(fftl)
    tau = np.minimum(tau, fftl - tau) / fs  # symmetric quefrency
    arg = np.pi * f0 * tau
    smooth = np.where(arg == 0, 1.0, np.sin(np.maximum(arg, 1e-30))
                      / np.maximum(arg, 1e-30))
    q0 = 1.0 - 2.0 * Q1
    recover = q0 + 2.0 * Q1 * np.cos(2 * np.pi * f0 * tau)
    return np.fft.rfft(c * smooth * recover).real


def cheaptrick(x: np.ndarray, f0: np.ndarray, time_axis: np.ndarray,
               fs: int, fft_size: int = None, f0_floor: float = 71.0
               ) -> np.ndarray:
    x = np.asarray(x, np.float64)
    if fft_size is None:
        fft_size = 1 << int(np.ceil(np.log2(3.0 * fs / f0_floor + 1)))
    F = len(f0)
    out = np.zeros((F, fft_size // 2 + 1))
    # WORLD's fit guarantee: a 3-period window must fit fft_size; frames
    # below this limit fall back to the default F0 (CheapTrickGeneralBody)
    f0_low_limit = 3.0 * fs / (fft_size - 3.0)
    for i in range(F):
        cf0 = f0[i] if f0[i] > f0_floor / 2 else DEFAULT_F0
        if cf0 < f0_low_limit:
            cf0 = DEFAULT_F0
        ps = _windowed_power_spectrum(x, fs, time_axis[i], cf0, fft_size)
        ps = _linear_smoothing(ps, fs, fft_size, 2.0 * cf0 / 3.0)
        ps = np.maximum(ps, 1e-300)
        log_ps = _lifter(safe_log(ps), fs, fft_size, cf0)
        out[i] = np.exp(log_ps)
    return out
