"""Pitch-dependent dilation factors and frame-to-sample expansion (numpy),
a copy of `qpnet_tpu/ops/pitch.py`."""

from __future__ import annotations

import numpy as np


def batch_f0(h: np.ndarray, f0_threshold: float = 0.0) -> np.ndarray:
    """The continuous-F0 column (dim 1) of the aux feature matrix, clipped
    from below at ``f0_threshold``."""
    cont_f0 = np.array(h[:, 1], dtype=np.float64, copy=True)
    cont_f0[cont_f0 < f0_threshold] = f0_threshold
    return cont_f0


def dilated_factor(f0: np.ndarray, fs: float, dense_factor: int) -> np.ndarray:
    """d(t) = fs / (f0(t) * dense_factor); unvoiced (f0==0) frames get d=1."""
    f0s = np.array(f0, dtype=np.float64, copy=True)
    f0s[f0s == 0] = fs / dense_factor
    d = np.full(f0s.shape, float(fs)) / f0s / dense_factor
    if not np.all(d > 0):
        raise ValueError("dilation factors must be positive (negative F0?)")
    return d


def extend_time(feats: np.ndarray, upsampling_factor: int) -> np.ndarray:
    """Frame-rate (T, D) -> sample-rate (T*up, D) by repetition."""
    return np.repeat(feats, upsampling_factor, axis=0)
