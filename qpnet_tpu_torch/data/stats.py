"""Feature statistics: a StandardScaler-equivalent streaming scaler with
the reference's uv-dimension pinning (mean 0 and scale 1 on dim 0), the
port's copy of `qpnet_tpu/data/stats.py`, bit-equal to it."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from qpnet_tpu_torch.data.h5io import read_hdf5, write_hdf5


class Scaler:
    """Streaming mean and std over rows (sklearn StandardScaler's
    partial_fit accumulation, ddof=0).  `Scaler()` starts empty for
    `partial_fit`; `Scaler.from_stats(mean, scale)` is the transform of a
    stats file."""

    def __init__(self):
        self.n = 0
        self.mean_ = None
        self.m2_ = None

    def partial_fit(self, x: np.ndarray) -> "Scaler":
        x = np.asarray(x, dtype=np.float64)
        if self.mean_ is None:
            self.mean_ = np.zeros(x.shape[1])
            self.m2_ = np.zeros(x.shape[1])
        for_n = x.shape[0]
        new_n = self.n + for_n
        delta = x.mean(axis=0) - self.mean_
        self.m2_ += x.var(axis=0) * for_n + (delta ** 2) * self.n * for_n / new_n
        self.mean_ += delta * for_n / new_n
        self.n = new_n
        return self

    @property
    def scale_(self) -> np.ndarray:
        s = np.sqrt(self.m2_ / self.n)
        # sklearn's _handle_zeros_in_scale: constant dims scale by 1, not 0
        s[s == 0.0] = 1.0
        return s

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean_) / self.scale_

    @classmethod
    def from_stats(cls, mean: np.ndarray, scale: np.ndarray) -> "Scaler":
        s = cls()
        s.mean_ = np.asarray(mean, np.float64)
        s.n = 1
        s.m2_ = np.asarray(scale, np.float64) ** 2
        return s


def calc_stats(file_list: Sequence[str], stats_path: str,
               feature_type: str = "world") -> None:
    """Scaler over feat[:, 1:] of every training h5; uv dim pinned to
    (mean 0, scale 1); writes /<type>/mean and /<type>/scale
    (reference calc_stats.py:19-37)."""
    scaler = Scaler()
    feat = None
    for filename in file_list:
        feat = read_hdf5(filename, f"/{feature_type}")
        scaler.partial_fit(feat[:, 1:])
    if feat is None:
        raise ValueError("empty feature list")
    mean = np.zeros(feat.shape[1])
    scale = np.ones(feat.shape[1])
    mean[1:] = scaler.mean_
    scale[1:] = scaler.scale_
    write_hdf5(stats_path, f"/{feature_type}/mean", mean)
    write_hdf5(stats_path, f"/{feature_type}/scale", scale)


def load_scaler(stats_path: str, feature_type: str = "world") -> Scaler:
    return Scaler.from_stats(read_hdf5(stats_path, f"/{feature_type}/mean"),
                             read_hdf5(stats_path, f"/{feature_type}/scale"))
