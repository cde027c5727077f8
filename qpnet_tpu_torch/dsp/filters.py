"""FIR high-pass / low-pass filters with the reference's exact conventions
(reference feature_extract.py:116-151): 255-tap firwin (Hamming), causal
lfilter for the low-cut, edge-padded + group-delay-compensated lfilter for
the low-pass.

The port's copy of `qpnet_tpu/dsp/filters.py`: host scipy, bit-equal to the
JAX package's host path, and `device_fir` (the JAX package's `jax_fir`) for
tensors on the torch device.
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



def device_fir(x, taps):
    """Causal FIR filtering of a tensor, lfilter(taps, 1, x) in its dtype
    and on its device (the port of the JAX package's `jax_fir`), as one
    FFT product (the tensor cores' TF32 never touches it)."""
    import torch
    taps = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    n = x.shape[-1] + taps.shape[0] - 1
    nfft = 1 << (n - 1).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(taps, nfft),
                        nfft)
    return y[..., : x.shape[-1]]
