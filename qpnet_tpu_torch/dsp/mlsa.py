"""MLSA (Mel Log Spectrum Approximation) digital filter, the port of
`qpnet_tpu/dsp/mlsa.py`.

The filter realizes H(z) = exp( sum_m b[m] Phi_m(z) ) with the mel basis
  Phi_0 = 1,  Phi_m(z) = (1-a^2) z^-1 / (1 - a z^-1) * Atilde(z)^(m-1),
  Atilde(z) = (z^-1 - a) / (1 - a z^-1),
and the exponential approximated by an order-L Pade rational
exp(w) ~= N(w)/N(-w), N(w) = sum_l A_l w^l: two cascaded exp-filters (the
b[1] term and the b[2:] cascade), gain exp(b[0]) at the output, as SPTK's
mlsadf.  Every Phi_m carries at least one sample of delay, so the Pade
feedback is computable sample by sample: a time-recursive IIR.

It runs on the host, as the JAX package runs it, in the port's own C++ core
(`csrc/qpdsp.cpp`, float64, bound in `dsp/native.py`).  The filter's state
goes in and out of every call, so a signal filtered chunk by chunk gives the
one-shot output bit for bit.  `mlsa_filter_plain` is the same recursion as a
per-sample loop of Python floats, in the core's order of operations: the
reference the tests and chip_smoke.py hold the core against.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from qpnet_tpu_torch.dsp import native
from qpnet_tpu_torch.dsp.mcep import mc2b

# Pade approximation constants for exp(w) (order 4 and 5, SPTK values)
PADE4 = np.array([1.0, 4.999273e-1, 1.067005e-1, 1.170221e-2, 5.656279e-4])
PADE5 = np.array([1.0, 4.999391e-1, 1.107098e-1, 1.369984e-2,
                  9.564853e-4, 3.041721e-5])

# (flat float64 state: stage 1 (inputs (L,), basis outputs (L, M)), then
# stage 2; samples filtered so far)
MLSAState = Tuple[np.ndarray, int]


def _pade(pd: int) -> np.ndarray:
    if pd == 4:
        return PADE4
    if pd == 5:
        return PADE5
    raise ValueError("pd must be 4 or 5")


def mlsa_init_state(order: int, pd: int = 4) -> MLSAState:
    """Zero filter state for `mlsa_filter_stateful` (order = M, the
    mel-cepstral filter order): the two exp-filter stages of the JAX
    package's carry, flattened, and the sample counter."""
    _pade(pd)
    return np.zeros(native.mlsa_state_size(order, pd)), 0


def mlsa_filter_stateful(x: np.ndarray, b_frames: np.ndarray,
                         carry: MLSAState, alpha: float, pd: int,
                         hopsize: int) -> Tuple[np.ndarray, MLSAState]:
    """Filter `x` from `carry` (see mlsa_init_state) through the C++ core:
    (y float64, the carry after x).  Coefficients `b_frames` ((F, M+1))
    switch every `hopsize` samples of the running counter."""
    state, counter = carry
    y, state, counter = native.mlsa_filter_state(
        x, b_frames, alpha, hopsize, pd, state, counter)
    return y, (state, counter)


def mlsa_filter(x: np.ndarray, b_frames: np.ndarray, alpha: float,
                hopsize: int, pd: int = 4) -> np.ndarray:
    """Filter waveform `x` through the MLSA filter with per-frame
    coefficients `b_frames` ((F, M+1), from mc2b), switching coefficients
    every `hopsize` samples (pysptk.synthesis.Synthesizer convention);
    float64, in the C++ core."""
    b = np.atleast_2d(b_frames)
    y, _ = mlsa_filter_stateful(x, b, mlsa_init_state(b.shape[1] - 1, pd),
                                alpha, pd, hopsize)
    return y


def mlsa_filter_plain(x: np.ndarray, b_frames: np.ndarray, alpha: float,
                      hopsize: int, pd: int = 4,
                      carry: Optional[MLSAState] = None
                      ) -> Tuple[np.ndarray, MLSAState]:
    """The same recursion as the C++ core, one sample at a time in Python
    floats (slow: a reference for checks, not a path)."""
    b_frames = np.atleast_2d(np.asarray(b_frames, np.float64))
    M = b_frames.shape[1] - 1
    A = [float(a) for a in _pade(pd)[1:]]
    L = pd
    # the zero state's layout, independent of the core
    state, t0 = carry if carry is not None else (np.zeros(2 * (L + L * M)),
                                                 0)
    st = [float(v) for v in state]
    # stage s: u_prev at st[o : o + L], y_prev (L, M) at st[o + L :]
    offs = (0, L + L * M)
    aa = 1.0 - alpha * alpha
    out = np.empty(len(x))
    frame, b1, b2, gain = -1, None, None, 1.0

    def step(o, xin, b):
        s = []
        y_new = []
        for l in range(L):
            yp = o + L + l * M
            y1 = aa * st[o + l] + alpha * st[yp]
            row = [y1]
            f = b[1] * y1
            for m in range(1, M):
                ym = st[yp + m - 1] - alpha * row[m - 1] + alpha * st[yp + m]
                row.append(ym)
                f += b[m + 1] * ym
            s.append(f)
            y_new.extend(row)
        u, y, sign = xin, 0.0, -1.0
        for l in range(L):
            u -= sign * A[l] * s[l]
            y += A[l] * s[l]
            sign = -sign
        y += u
        st[o] = u
        for l in range(1, L):
            st[o + l] = s[l - 1]
        st[o + L: o + L + L * M] = y_new
        return y

    for i, xi in enumerate(np.asarray(x, np.float64)):
        fr = min((t0 + i) // hopsize, b_frames.shape[0] - 1)
        if fr != frame:
            frame = fr
            b = b_frames[fr]
            b1 = [0.0] * (M + 1)
            b1[1] = float(b[1])
            b2 = [0.0, 0.0] + [float(v) for v in b[2:]]
            gain = math.exp(float(b[0]))
        v = step(offs[0], float(xi), b1)
        out[i] = step(offs[1], v, b2) * gain
    return out, (np.asarray(st), t0 + len(x))


def synthesis_diff(x: np.ndarray, diffmcep: np.ndarray, alpha: float,
                   shiftms: float, fs: int, pd: int = 4) -> np.ndarray:
    """Filter waveform by the *differential* mel-cepstrum — the noise
    shaping / restoration primitive (sprocket Synthesizer.synthesis_diff;
    reference noise_shaping.py:125-136)."""
    hopsize = int(fs * shiftms / 1000)
    b = mc2b(diffmcep, alpha)
    return mlsa_filter(x, b, alpha, hopsize, pd=pd)
