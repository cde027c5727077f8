"""HDF5 feature I/O, same on-disk schema as the JAX package (`/world`,
`/f0`, `/npow`, `/vad_idx`, `/world/mean`, `/world/scale`): a file either
package writes, the other reads.  h5py is imported where it is used, so the
rest of the package imports without it.  Where the JAX package's readers
call `sys.exit(1)`, the port's raise."""

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


def write_hdf5(hdf5_name: str, hdf5_path: str, write_data,
               is_overwrite: bool = True) -> None:
    """Write one dataset, creating the file and its directory as needed;
    an existing dataset is replaced, or with is_overwrite=False raises."""
    import h5py
    write_data = np.asarray(write_data)
    dirname = os.path.dirname(hdf5_name)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with h5py.File(hdf5_name, "a") as f:
        if hdf5_path in f:
            if not is_overwrite:
                raise FileExistsError(f"dataset in hdf5 file already "
                                      f"exists. ({hdf5_path})")
            del f[hdf5_path]
        f.create_dataset(hdf5_path, data=write_data)


def check_hdf5(hdf5_name: str, hdf5_path: str) -> bool:
    import h5py
    if not os.path.exists(hdf5_name):
        return False
    with h5py.File(hdf5_name, "r") as f:
        return hdf5_path in f


def shape_hdf5(hdf5_name: str, hdf5_path: str):
    import h5py
    with h5py.File(hdf5_name, "r") as f:
        return f[hdf5_path].shape
