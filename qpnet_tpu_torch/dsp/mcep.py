"""Mel-cepstral analysis layer — SPTK-algorithm reimplementations.

The reference reaches these through pysptk inside sprocket
(SURVEY.md §2.2): `FeatureExtractor.mcep` == sp2mc(CheapTrick spectrum),
`npow` == normalized frame power of the spectrogram, and the MLSA filter
coefficients come from mc2b.  pysptk is not available in this image, so the
algorithms are implemented from their definitions (frequency-warped
cepstrum via the freqt recursion) and validated by round-trip property
tests (tests/test_dsp_mcep.py).

All functions are vectorized over frames (numpy host path); `freqt` is the
O(M1*M2) recursion applied to whole spectrograms at once.
"""

from __future__ import annotations

import numpy as np


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Frequency transform (warping) of cepstrum rows.

    c: (..., M1+1) cepstrum; returns (..., order+1) warped cepstrum.
    Classic SPTK recursion: iterate input coefficients from highest to
    lowest, updating the warped accumulator g.
    """
    c = np.asarray(c, dtype=np.float64)
    single = c.ndim == 1
    if single:
        c = c[None]
    F, m1p1 = c.shape
    b = 1.0 - alpha * alpha
    g = np.zeros((F, order + 1))
    for i in range(m1p1 - 1, -1, -1):
        d = g.copy()
        g[:, 0] = c[:, i] + alpha * d[:, 0]
        if order >= 1:
            g[:, 1] = b * d[:, 0] + alpha * d[:, 1]
        for m in range(2, order + 1):
            g[:, m] = d[:, m - 1] + alpha * (d[:, m] - g[:, m - 1])
    return g[0] if single else g


def sp2mc(powerspec: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """Power spectrum (..., fftl//2+1) -> mel-cepstrum (..., order+1).

    pysptk.sp2mc equivalent: real cepstrum of log power spectrum, c0 halved,
    then freqt warping.
    """
    powerspec = np.asarray(powerspec, dtype=np.float64)
    single = powerspec.ndim == 1
    if single:
        powerspec = powerspec[None]
    logsp = np.log(np.maximum(powerspec, 1e-300))
    c = np.fft.irfft(logsp, axis=-1)  # (..., fftl)
    c = c[:, : powerspec.shape[-1]].copy()
    c[:, 0] /= 2.0
    mc = freqt(c, order, alpha)
    return mc[0] if single else mc


def mc2sp(mc: np.ndarray, alpha: float, fftlen: int) -> np.ndarray:
    """Mel-cepstrum -> power spectrum (inverse of sp2mc up to the
    low-order truncation)."""
    mc = np.asarray(mc, dtype=np.float64)
    single = mc.ndim == 1
    if single:
        mc = mc[None]
    half = fftlen // 2
    c = freqt(mc, half, -alpha)
    c[:, 0] *= 2.0
    sym = np.concatenate([c, c[:, -2:0:-1]], axis=-1)  # (..., fftlen)
    logsp = np.fft.rfft(sym, axis=-1).real
    sp = np.exp(logsp)
    return sp[0] if single else sp


def mc2b(mc: np.ndarray, alpha: float) -> np.ndarray:
    """Mel-cepstrum -> MLSA filter coefficients (SPTK mc2b recursion):
      b[M] = mc[M];  b[m] = mc[m] - alpha*b[m+1]
    """
    mc = np.asarray(mc, dtype=np.float64)
    b = mc.copy()
    for m in range(mc.shape[-1] - 2, -1, -1):
        b[..., m] = mc[..., m] - alpha * b[..., m + 1]
    return b


def b2mc(b: np.ndarray, alpha: float) -> np.ndarray:
    """Inverse of mc2b."""
    b = np.asarray(b, dtype=np.float64)
    mc = b.copy()
    mc[..., :-1] = b[..., :-1] + alpha * b[..., 1:]
    return mc


def spvec2pow(specvec: np.ndarray) -> float:
    """Frame power from a half power spectrum (sprocket convention:
    trapezoid over the symmetric spectrum / fftl)."""
    fftl2 = (len(specvec) - 1) * 2
    return (specvec[0] + specvec[-1] + 2.0 * np.sum(specvec[1:-1])) / fftl2


def spectrogram2npow(spectrogram: np.ndarray) -> np.ndarray:
    """Normalized frame power in dB (sprocket FeatureExtractor.npow):
    10*log10(frame_power / utterance_mean_power)."""
    pows = np.array([spvec2pow(row) for row in np.asarray(spectrogram)])
    meanpow = np.mean(pows)
    return 10.0 * np.log10(pows / meanpow)


def extfrm(data: np.ndarray, npow: np.ndarray, power_threshold: float = -20):
    """Power-threshold VAD frame extraction
    (reference feature_extract.py:105-114)."""
    T = data.shape[0]
    if T != len(npow):
        raise ValueError("Length of two vectors is different.")
    valid_index = np.where(npow > power_threshold)
    extdata = data[valid_index]
    assert extdata.shape[0] <= T
    return extdata, valid_index[0]
