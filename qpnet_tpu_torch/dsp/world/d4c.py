"""D4C band-aperiodicity estimator (Morise 2016, WORLD `d4c`).

Faithful reimplementation of the published D4C algorithm (the reference
reaches it through pyworld via sprocket, feature_extract.py:324-327 and
pyworld.decode_aperiodicity at :264).  Per voiced frame:

  1. *Love train* pre-test: the windowed spectrum's cumulative power
     between 100 Hz and 4 kHz relative to 100 Hz..7.9 kHz; frames below
     0.85 are treated as fully aperiodic (vuv safety net).
  2. *Static group delay*: two pitch-synchronous spectral centroids at
     +-0.25/f0 around the frame center are summed and divided by the
     f0-smoothed power spectrum; removing its own f0-width smoothing
     leaves only the fine (intra-harmonic) group-delay structure.
  3. *Coarse aperiodicity per 3 kHz band*: a Nuttall-windowed segment of
     the group delay around each band center is Fourier-analyzed; the
     ratio of the sorted cumulative power excluding the top `boundary`
     coefficients to the total is the band's aperiodicity in dB — a
     periodic signal concentrates group-delay power in few coefficients,
     noise spreads it.
  4. The coarse values (plus -60 dB at 0 Hz and ~0 dB at Nyquist) are
     linearly interpolated over the full spectrum and mapped to linear
     amplitude 10^(dB/20).

Returns the full-resolution aperiodicity spectrogram (F, fftl//2+1) with
values in (0, 1], matching pyworld.d4c's output contract.
"""

from __future__ import annotations

import numpy as np

from qpnet_tpu_torch.dsp.world.codec import FREQUENCY_INTERVAL, band_frequencies
from qpnet_tpu_torch.dsp.world.common import (
    dc_correction, get_windowed_waveform, linear_smoothing, matlab_round,
    nuttall,
)

UNVOICED_AP = 1.0 - 1e-12
FLOOR_F0_D4C = 47.0
LOVE_TRAIN_LOWEST_F0 = 40.0
LOVE_TRAIN_THRESHOLD = 0.85
# the 15 kHz band cap lives in codec.n_aperiodicity_bands (shared with
# the aperiodicity codec, which must agree on the band structure)


def _get_centroid(x: np.ndarray, fs: int, f0: float, position: float,
                  fft_size: int) -> np.ndarray:
    """Energy-normalized spectral centroid numerator Re{X}Re{X_t}+Im{X}Im{X_t}
    where X_t is the FFT of the ramp-weighted windowed waveform."""
    seg = get_windowed_waveform(x, fs, f0, position, "blackman", 4.0)
    power = np.sqrt(np.dot(seg, seg))
    if power <= 0.0:
        return np.zeros(fft_size // 2 + 1)
    seg = seg / power
    spec1 = np.fft.rfft(seg, fft_size)
    spec2 = np.fft.rfft(seg * (np.arange(len(seg)) + 1.0), fft_size)
    return spec1.real * spec2.real + spec1.imag * spec2.imag


def _get_static_centroid(x: np.ndarray, fs: int, f0: float, position: float,
                         fft_size: int) -> np.ndarray:
    c1 = _get_centroid(x, fs, f0, position - 0.25 / f0, fft_size)
    c2 = _get_centroid(x, fs, f0, position + 0.25 / f0, fft_size)
    return dc_correction(c1 + c2, f0, fs, fft_size)


def _get_smoothed_power_spectrum(x: np.ndarray, fs: int, f0: float,
                                 position: float, fft_size: int
                                 ) -> np.ndarray:
    seg = get_windowed_waveform(x, fs, f0, position, "hanning", 4.0)
    ps = np.abs(np.fft.rfft(seg, fft_size)) ** 2
    ps = dc_correction(ps, f0, fs, fft_size)
    return linear_smoothing(ps, f0, fs, fft_size)


def _get_static_group_delay(static_centroid: np.ndarray,
                            smoothed_ps: np.ndarray, f0: float, fs: int,
                            fft_size: int) -> np.ndarray:
    sgd = static_centroid / np.maximum(smoothed_ps, 1e-300)
    sgd = linear_smoothing(sgd, f0 / 2.0, fs, fft_size)
    return sgd - linear_smoothing(sgd, f0, fs, fft_size)


def _get_coarse_aperiodicity(sgd: np.ndarray, fs: int, fft_size: int,
                             n_bands: int, window: np.ndarray) -> np.ndarray:
    window_length = len(window)
    boundary = matlab_round(fft_size * 8.0 / window_length)
    half_window = window_length // 2
    half = fft_size // 2
    coarse = np.empty(n_bands)
    for i in range(n_bands):
        center = int(FREQUENCY_INTERVAL * (i + 1) * fft_size / fs)
        # the first band's window starts one bin before DC; zero-fill
        idx = np.arange(center - half_window,
                        center - half_window + window_length)
        valid = (idx >= 0) & (idx < len(sgd))
        seg = np.zeros(window_length)
        seg[valid] = sgd[idx[valid]]
        ps = np.abs(np.fft.rfft(seg * window, fft_size)) ** 2
        cumulative = np.cumsum(np.sort(ps))
        coarse[i] = 10.0 * np.log10(
            cumulative[half - boundary - 1] / cumulative[half])
    return coarse


def _love_train(x: np.ndarray, fs: int, f0: np.ndarray,
                time_axis: np.ndarray) -> np.ndarray:
    """Per-frame low/high-band power ratio used as a voicing safety net."""
    fft_size = 1 << (1 + int(np.log2(3.0 * fs / LOVE_TRAIN_LOWEST_F0 + 1)))
    b0 = int(np.ceil(100.0 * fft_size / fs))
    b1 = int(np.ceil(4000.0 * fft_size / fs))
    b2 = int(np.ceil(7900.0 * fft_size / fs))
    b2 = min(b2, fft_size // 2)
    out = np.zeros(len(f0))
    for i in range(len(f0)):
        if f0[i] <= 0.0:
            continue
        cf0 = max(f0[i], LOVE_TRAIN_LOWEST_F0)
        seg = get_windowed_waveform(x, fs, cf0, time_axis[i], "blackman", 3.0)
        ps = np.abs(np.fft.rfft(seg, fft_size)) ** 2
        ps[: b0 + 1] = 0.0
        c = np.cumsum(ps)
        out[i] = c[b1] / max(c[b2], 1e-300)
    return out


def d4c(x: np.ndarray, f0: np.ndarray, time_axis: np.ndarray, fs: int,
        fft_size: int = None, threshold: float = LOVE_TRAIN_THRESHOLD
        ) -> np.ndarray:
    x = np.asarray(x, np.float64)
    f0 = np.asarray(f0, np.float64)
    if fft_size is None:
        fft_size = 1 << int(np.ceil(np.log2(3.0 * fs / 71.0 + 1)))
    half = fft_size // 2 + 1

    fft_size_d4c = 1 << (1 + int(np.log2(4.0 * fs / FLOOR_F0_D4C + 1)))
    bands = band_frequencies(fs)
    n_bands = len(bands)
    # common frequency-domain window for the coarse-band analysis
    window_length = int(FREQUENCY_INTERVAL * fft_size_d4c / fs) * 2 + 2
    window = nuttall(window_length)

    aperiodicity0 = _love_train(x, fs, f0, time_axis)

    freqs = np.arange(half) * fs / fft_size
    anchors_f = np.concatenate([[0.0], bands, [fs / 2.0]])

    ap = np.full((len(f0), half), UNVOICED_AP)
    for i in range(len(f0)):
        if f0[i] <= 0.0 or aperiodicity0[i] <= threshold:
            continue
        cf0 = max(f0[i], FLOOR_F0_D4C)
        centroid = _get_static_centroid(x, fs, cf0, time_axis[i],
                                        fft_size_d4c)
        smoothed = _get_smoothed_power_spectrum(x, fs, cf0, time_axis[i],
                                                fft_size_d4c)
        sgd = _get_static_group_delay(centroid, smoothed, cf0, fs,
                                      fft_size_d4c)
        coarse = _get_coarse_aperiodicity(sgd, fs, fft_size_d4c, n_bands,
                                          window)
        # low-F0 frames are penalized toward periodic (WORLD's F0 revision)
        coarse = np.minimum(0.0, coarse + (cf0 - 100.0) / 50.0)
        anchors_db = np.concatenate([[-60.0], coarse, [-1e-12]])
        ap[i] = 10.0 ** (np.interp(freqs, anchors_f, anchors_db) / 20.0)
    return np.clip(ap, 1e-12, UNVOICED_AP)
