"""StoneMask F0 refinement (Morise 2011, WORLD `stonemask`).

For each voiced frame: window ~3 periods around the frame time, compute the
instantaneous frequency of the spectrum (via the phase difference of the
signal and its one-sample shift), and refine F0 as the power-weighted mean
of IF(k*f0)/k over the first harmonics.  Frames whose refinement diverges
from the initial estimate keep the initial value zeroed (WORLD sets f0=0
when the refined value leaves [f0/2, f0*2] bands... we clamp the same way).
"""

from __future__ import annotations

import numpy as np


def stonemask(x: np.ndarray, f0: np.ndarray, time_axis: np.ndarray,
              fs: int) -> np.ndarray:
    """Two batched refinement passes (WORLD refines the refined value)."""
    from qpnet_tpu_torch.dsp.world.refine import refine_many
    x = np.asarray(x, np.float64)
    r1 = refine_many(x, fs, time_axis, np.asarray(f0, np.float64))
    r2 = refine_many(x, fs, time_axis, r1)
    return np.where(r2 > 0, r2, r1)
