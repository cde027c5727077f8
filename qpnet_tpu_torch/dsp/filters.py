"""FIR high-pass / low-pass filters with the reference's exact conventions
(reference feature_extract.py:116-151): 255-tap firwin (Hamming), causal
lfilter for the low-cut, edge-padded + group-delay-compensated lfilter for
the low-pass.

The port's copy of `qpnet_tpu/dsp/filters.py`: host scipy, bit-equal to the
JAX package's host path.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import firwin, lfilter


def low_cut_filter(x: np.ndarray, fs: int, cutoff: float = 70) -> np.ndarray:
    """Causal FIR high-pass (reference feature_extract.py:116-131)."""
    nyquist = fs // 2
    norm_cutoff = cutoff / nyquist
    fil = firwin(255, norm_cutoff, pass_zero=False)
    return lfilter(fil, 1, x)


def low_pass_filter(x: np.ndarray, fs: int, cutoff: float = 70,
                    padding: bool = True) -> np.ndarray:
    """Zero-delay FIR low-pass via edge padding + half-length trim
    (reference feature_extract.py:133-151)."""
    nyquist = fs // 2
    norm_cutoff = cutoff / nyquist
    numtaps = 255
    fil = firwin(numtaps, norm_cutoff)
    x_pad = np.pad(x, (numtaps, numtaps), "edge")
    lpf_x = lfilter(fil, 1, x_pad)
    return lpf_x[numtaps + numtaps // 2: -numtaps // 2]

