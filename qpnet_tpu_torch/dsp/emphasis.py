"""Spectral emphasis engine: differential-MLSA filtering of waveforms with
a constant per-corpus mel-cepstral coefficient vector, the port of
`qpnet_tpu/dsp/emphasis.py`.

The shared core of the two recipe workers (reference
src/bin/noise_shaping.py:94-140 applies the filter to training targets,
src/bin/noise_restored.py:70-121 the inverse to generated audio):

    coefs  = emphasis_coefs(stats, ...)        # mean mcep * mag, c0 = 0
    y      = emphasize(x, fs, coefs, ...)      # MLSA diff filter + 70 Hz HPF
    write  = filter_wav_file(src, dst, ...)    # dtype-preserving wav I/O

The filter coefficients are frame-constant, so the frame count only needs
to cover the signal; no WORLD analysis pass is run.  Both the MLSA filter
and the 70 Hz low-cut (the 255 taps of `filters.low_cut_filter`) run in the
port's float64 C++ core with their state carried, so `StreamingEmphasizer`
gives `emphasize`'s output bit for bit, for any chunking.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile

from qpnet_tpu_torch.data.h5io import read_hdf5
from qpnet_tpu_torch.dsp import native
from qpnet_tpu_torch.dsp.mcep import mc2b
from qpnet_tpu_torch.dsp.mlsa import (mlsa_filter_stateful, mlsa_init_state,
                                      synthesis_diff)

HIGHPASS_CUTOFF_HZ = 70.0


def highpass_taps(fs: int) -> np.ndarray:
    """The recipe's 70 Hz low-cut: 255-tap firwin high-pass, as
    `filters.low_cut_filter` designs it."""
    from scipy.signal import firwin
    return firwin(255, HIGHPASS_CUTOFF_HZ / (fs // 2), pass_zero=False)


def emphasis_coefs(stats_path: str, feature_type: str, dim_start: int,
                   dim_end: int, mag: float, invert: bool) -> np.ndarray:
    """Filter coefficients from corpus statistics: the mean mel-cepstrum
    slice scaled by `mag`, with the power term zeroed.  `invert=True`
    flips the signs of the higher coefficients (the de-emphasis direction,
    reference noise_shaping.py:125-131)."""
    mean = read_hdf5(stats_path, "/%s/mean" % feature_type)
    coefs = np.array(mean[dim_start:dim_end], np.float64) * mag
    coefs[0] = 0.0
    if invert:
        coefs[1:] = -coefs[1:]
    return coefs


def frame_count(n_samples: int, fs: int, shiftms: float) -> int:
    """Frames covering the signal at the analysis hop (one frame per
    shift, inclusive of t=0)."""
    return int(n_samples / (fs * shiftms / 1000.0)) + 1


def emphasize(x: np.ndarray, fs: int, coefs: np.ndarray, alpha: float,
              shiftms: float) -> np.ndarray:
    """Differential MLSA filtering with frame-constant coefficients,
    followed by the recipe's 70 Hz low-cut."""
    frames = np.tile(coefs, (frame_count(len(x), fs, shiftms), 1))
    y = synthesis_diff(np.asarray(x, np.float64), frames, alpha,
                       shiftms, fs)
    return native.fir(y, highpass_taps(fs))


class StreamingEmphasizer:
    """Chunk-by-chunk differential-MLSA emphasis with carried filter state:
    `concat(process(chunks))` equals `emphasize(concat(chunks))` bit for
    bit, for any chunking.  The MLSA state and the 70 Hz FIR's input
    history both persist across chunks.  (The JAX package's streaming
    filter runs a float32 scan, so it agrees with this one within float32
    rounding.)

    This is what lets the serving path apply the recipe's noise
    restoration filter (reference noise_restored.py) to audio as it
    streams: models trained on noise-shaped targets need it for correct
    output spectra.
    """

    def __init__(self, fs: int, coefs: np.ndarray, alpha: float,
                 shiftms: float = 5.0, pd: int = 4, highpass: bool = True):
        self.fs, self.alpha, self.pd = fs, float(alpha), pd
        self.hopsize = int(fs * shiftms / 1000)
        # frame-constant coefficients: one b row serves every sample
        self._b = mc2b(np.asarray(coefs, np.float64)[None, :], self.alpha)
        self._state = mlsa_init_state(self._b.shape[1] - 1, pd)
        self._fir = highpass_taps(fs) if highpass else None
        self._fir_hist = np.zeros(254) if highpass else None

    def process(self, chunk: np.ndarray) -> np.ndarray:
        """Filter one chunk (any length); returns the same length."""
        y, self._state = mlsa_filter_stateful(
            np.asarray(chunk, np.float64), self._b, self._state,
            self.alpha, self.pd, self.hopsize)
        if self._fir is not None:
            y, self._fir_hist = native.fir_state(y, self._fir,
                                                 self._fir_hist)
        return y


def filter_wav_file(src: str, dst: str, fs_expected: int,
                    coefs: np.ndarray, alpha: float, shiftms: float) -> None:
    """Read `src`, filter, write `dst` preserving the sample dtype.

    Raises ValueError on a sample-rate mismatch (the recipe treats that as
    a corpus configuration error)."""
    fs, x = wavfile.read(src)
    if fs != fs_expected:
        raise ValueError(
            f"{src}: sample rate {fs} != configured {fs_expected}")
    in_dtype = x.dtype
    y = emphasize(x.astype(np.float64), fs, coefs, alpha, shiftms)
    y = np.clip(y, -32768, 32767)
    out_dir = os.path.dirname(dst)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    wavfile.write(dst, fs, y.astype(np.int16) if in_dtype == np.int16
                  else y)
