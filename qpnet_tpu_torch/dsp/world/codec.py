"""Aperiodicity coding — WORLD codec.cc equivalents.

Band structure: one coarse value per 3000 Hz below (fs/2 - 3000); at
fs=22050 that is 2 bands (matching the reference's 2-dim codeap at 22.05 kHz,
param_feat.py:38-43).  Coding stores the band values in dB (20*log10 ap);
decoding interpolates the dB anchors [(0 Hz, -60 dB), (band_i, coded_i),
(fs/2, ~0 dB)] over the full spectrum.
"""

from __future__ import annotations

import numpy as np

FREQUENCY_INTERVAL = 3000.0
UNVOICED_DB = -1e-12  # ap ~= 1 at nyquist anchor


def n_aperiodicity_bands(fs: int) -> int:
    return int(min(15000.0, fs / 2.0 - FREQUENCY_INTERVAL)
               // FREQUENCY_INTERVAL)


def band_frequencies(fs: int) -> np.ndarray:
    n = n_aperiodicity_bands(fs)
    return FREQUENCY_INTERVAL * (np.arange(n) + 1)


def code_aperiodicity(ap: np.ndarray, fs: int) -> np.ndarray:
    """(F, fftl//2+1) aperiodicity in (0,1] -> (F, n_bands) coarse dB."""
    ap = np.atleast_2d(np.asarray(ap, np.float64))
    half = ap.shape[1]
    bands = band_frequencies(fs)
    idx = np.minimum((bands / (fs / 2.0) * (half - 1)).round().astype(int),
                     half - 1)
    return 20.0 * np.log10(np.maximum(ap[:, idx], 1e-12))


def expand_coarse(coarse_db_or_lin: np.ndarray, fs: int, fft_size: int,
                  coarse_is_db: bool = False) -> np.ndarray:
    """One frame's coarse band values (linear ap, or dB) -> full spectrum."""
    half = fft_size // 2 + 1
    bands = band_frequencies(fs)
    if coarse_is_db:
        vals_db = np.asarray(coarse_db_or_lin, np.float64)
    else:
        vals_db = 20.0 * np.log10(
            np.maximum(np.asarray(coarse_db_or_lin, np.float64), 1e-12))
    anchors_f = np.concatenate([[0.0], bands, [fs / 2.0]])
    anchors_db = np.concatenate([[-60.0], vals_db, [UNVOICED_DB]])
    freqs = np.linspace(0, fs / 2.0, half)
    full_db = np.interp(freqs, anchors_f, anchors_db)
    return 10.0 ** (full_db / 20.0)


def decode_aperiodicity(coded: np.ndarray, fs: int, fft_size: int
                        ) -> np.ndarray:
    """(F, n_bands) coarse dB -> (F, fftl//2+1) aperiodicity in (0,1]."""
    coded = np.atleast_2d(np.asarray(coded, np.float64))
    out = np.stack([
        expand_coarse(row, fs, fft_size, coarse_is_db=True) for row in coded])
    return np.clip(out, 1e-12, 1.0 - 1e-12)
