"""HDF5 feature I/O, same on-disk schema as the JAX package (`/world`,
`/f0`, `/npow`, `/vad_idx`, `/world/mean`, `/world/scale`): a file either
package writes, the other reads.  The files are read and written by
`hdf5_format` (the part of HDF5 that h5py writes by default), so the port
needs no h5py.  Where the JAX package's readers call `sys.exit(1)`, the
port's raise; elsewhere each function raises what h5py raised here."""

from __future__ import annotations

import os

import numpy as np

from qpnet_tpu_torch.data import hdf5_format as H


def read_hdf5(hdf5_name: str, hdf5_path: str) -> np.ndarray:
    """The dataset's array (a numpy scalar for a scalar dataset)."""
    if not os.path.exists(hdf5_name):
        raise FileNotFoundError(f"there is no such a hdf5 file. ({hdf5_name})")
    with H.File(hdf5_name) as f:
        node = f.find(hdf5_path)
        if node is None:
            raise KeyError(f"there is no such a data in hdf5 file. "
                           f"({hdf5_path} in {hdf5_name})")
        if isinstance(node, H.Group):
            raise TypeError(f"{hdf5_path} in {hdf5_name} is a group")
        return f.read(node)[()]


def _drop(sets: dict, groups: list, path: str):
    """Remove the object at `path` (a dataset, or a group with everything
    under it) from a file's contents as `hdf5_format.contents` gives them."""
    key = "/" + "/".join(p for p in path.split("/") if p and p != ".")
    under = key.rstrip("/") + "/"
    for k in [k for k in sets if k == key or k.startswith(under)]:
        del sets[k]
    groups[:] = [g for g in groups if g != key and not g.startswith(under)]


def write_hdf5(hdf5_name: str, hdf5_path: str, write_data,
               is_overwrite: bool = True) -> None:
    """Write one dataset, creating the file and its directory as needed;
    an existing dataset is replaced, or with is_overwrite=False raises.
    The file is read whole and written again (`hdf5_format.write`); a file
    holding what the writer cannot carry across (attributes, or what the
    reader refuses) raises ValueError and is left as it was."""
    write_data = np.asarray(write_data)
    H.check_dtype(write_data.dtype, hdf5_path)
    dirname = os.path.dirname(hdf5_name)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    sets, groups = {}, []
    if os.path.exists(hdf5_name):
        with H.File(hdf5_name) as f:
            sets, groups = H.contents(f)
            exists = f.find(hdf5_path) is not None
        if exists:
            if not is_overwrite:
                raise FileExistsError(f"dataset in hdf5 file already "
                                      f"exists. ({hdf5_path})")
            _drop(sets, groups, hdf5_path)
    sets[hdf5_path] = write_data
    H.write(hdf5_name, sets, groups)


def check_hdf5(hdf5_name: str, hdf5_path: str) -> bool:
    """h5py's `hdf5_path in file`."""
    if not os.path.exists(hdf5_name):
        return False
    with H.File(hdf5_name) as f:
        return f.find(hdf5_path) is not None


def shape_hdf5(hdf5_name: str, hdf5_path: str):
    if not os.path.exists(hdf5_name):
        raise FileNotFoundError(f"there is no such a hdf5 file. ({hdf5_name})")
    with H.File(hdf5_name) as f:
        node = f.find(hdf5_path, lookup=True)
        if node is None:
            raise KeyError(f"there is no such a data in hdf5 file. "
                           f"({hdf5_path} in {hdf5_name})")
        if isinstance(node, H.Group):
            raise AttributeError(f"{hdf5_path} in {hdf5_name} is a group: "
                                 f"it has no shape")
        return node.shape
