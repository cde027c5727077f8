"""Feature standardization from a stats file (`/<type>/mean`,
`/<type>/scale`), as the decode CLI applies it."""

from __future__ import annotations

import numpy as np

from qpnet_tpu_torch.data.h5io import read_hdf5


class Scaler:
    """StandardScaler-equivalent transform from stored mean and scale."""

    def __init__(self, mean: np.ndarray, scale: np.ndarray):
        self.mean_ = np.asarray(mean, np.float64)
        # sqrt(scale**2), with constant dims scaled by 1: the same values the
        # JAX package's streaming scaler derives from stored stats
        s = np.sqrt(np.asarray(scale, np.float64) ** 2)
        s[s == 0.0] = 1.0
        self.scale_ = s

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean_) / self.scale_


def load_scaler(stats_path: str, feature_type: str = "world") -> Scaler:
    return Scaler(read_hdf5(stats_path, f"/{feature_type}/mean"),
                  read_hdf5(stats_path, f"/{feature_type}/scale"))
