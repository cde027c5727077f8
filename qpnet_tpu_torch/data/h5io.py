"""HDF5 feature reads, same on-disk schema as the JAX package (`/world`,
`/world/mean`, `/world/scale`, ...).  h5py is imported where it is used, so
the rest of the package imports without it."""

from __future__ import annotations

import os

import numpy as np


def read_hdf5(hdf5_name: str, hdf5_path: str) -> np.ndarray:
    import h5py
    if not os.path.exists(hdf5_name):
        raise FileNotFoundError(f"there is no such a hdf5 file. ({hdf5_name})")
    with h5py.File(hdf5_name, "r") as f:
        if hdf5_path not in f:
            raise KeyError(f"there is no such a data in hdf5 file. "
                           f"({hdf5_path} in {hdf5_name})")
        return f[hdf5_path][()]


def shape_hdf5(hdf5_name: str, hdf5_path: str):
    import h5py
    with h5py.File(hdf5_name, "r") as f:
        return f[hdf5_path].shape
