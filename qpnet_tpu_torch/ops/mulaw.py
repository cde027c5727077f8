"""Mu-law companding on numpy arrays and torch tensors, numerically
identical to `qpnet_tpu/ops/mulaw.py`."""

from __future__ import annotations

import numpy as np
import torch


def encode_mu_law(x, mu: int = 256):
    """Encode a [-1, 1] float waveform into {0..mu-1} integer classes:
    floor((fx+1)/2*(mu-1) + 0.5), i.e. round-half-up on the companded
    signal."""
    m = mu - 1
    if isinstance(x, torch.Tensor):
        fx = torch.sign(x) * torch.log1p(m * torch.abs(x)) / np.log1p(m)
        return torch.floor((fx + 1) / 2 * m + 0.5).to(torch.int32)
    fx = np.sign(x) * np.log1p(m * np.abs(x)) / np.log1p(m)
    return np.floor((fx + 1) / 2 * m + 0.5).astype(np.int32)


def decode_mu_law(y, mu: int = 256):
    """Decode {0..mu-1} classes back to a [-1, 1] float waveform, with the
    0.5-bin recentring."""
    m = mu - 1
    if isinstance(y, torch.Tensor):
        fx = (y.to(torch.float32) - 0.5) / m * 2 - 1
        return torch.sign(fx) / m * ((1 + m) ** torch.abs(fx) - 1)
    fx = (np.asarray(y, dtype=np.float32) - 0.5) / m * 2 - 1
    return np.sign(fx) / m * ((1 + m) ** np.abs(fx) - 1)
