"""Orbax's checkpoint format, read and written without orbax, tensorstore
or JAX.

An orbax checkpoint (`StandardCheckpointer`, zarr v2) is a directory:

- `_METADATA`: JSON whose `tree_metadata` maps each leaf's path (the repr
  of a tuple of key strings) to `key_metadata`, the path's keys with their
  kind (`key_type` 2 a dict key, 1 a sequence index), and `value_metadata`
  (`value_type` "np.ndarray", "scalar" or "None" for an empty node such as
  optax's EmptyState).  `use_ocdbt` says where the arrays are.
- `_CHECKPOINT_METADATA`: JSON with the handler's name and timestamps.
- Each array, named by its path's keys joined with ".", is a zarr v2 array:
  `<name>/.zarray` (shape, chunks, dtype, compressor, fill value) and a
  chunk per grid cell, keyed by its indices joined with the dimension
  separator ("0" for a 0-d array).  With `use_ocdbt` these are keys of the
  OCDBT store at the directory's root (`train/ocdbt.py`); else files.

`read_checkpoint` reads both layouts: dicts and lists rebuilt from the key
types, `scalar` values as Python numbers, chunks through the host C++ zstd
decoder (`train/zstd_native.py`).  `write_checkpoint` writes the plain
layout (`use_ocdbt` false), one chunk an array in a zstd frame of raw
blocks, into a temporary directory that it then renames, so the files are
about as large as the arrays.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from qpnet_tpu_torch.train import zstd

DICT_KEY, SEQUENCE_KEY = 2, 1
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
_ZSTD = {"id": "zstd", "level": 1}


class OrbaxFormatError(ValueError):
    """A checkpoint directory is not in the orbax layout this reads."""


class _Files:
    """The plain layout: each key a file under the checkpoint."""

    def __init__(self, root: str):
        self.root = root

    def __contains__(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self.root, key))

    def read(self, key: str) -> bytes:
        try:
            with open(os.path.join(self.root, key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": math.nan, "Infinity": math.inf,
                "-Infinity": -math.inf}[value]
    return value


def read_array(store, name: str,
               decompress_into: Optional[Callable] = None) -> np.ndarray:
    """The zarr v2 array `name` of `store` (a key-value store with `read`
    and `in`).  decompress_into(data, out) decodes a chunk into `out`
    (default the host C++ decoder)."""
    if decompress_into is None:
        from qpnet_tpu_torch.train.zstd_native import decompress_into
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr format "
                               f"{meta.get('zarr_format')}")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: zarr filters {meta['filters']}")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: order {meta['order']}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {comp.get('id')}")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError:
        raise OrbaxFormatError(f"{name}: dtype {meta['dtype']!r}") from None
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise OrbaxFormatError(f"{name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        if key not in store:
            out[region] = _fill(meta.get("fill_value"))
            continue
        data = store.read(key)
        whole = chunks == shape
        buf = out if whole else np.empty(chunks, dtype)
        if comp is None:
            if len(data) != chunk_bytes:
                raise OrbaxFormatError(f"{key}: {len(data)} bytes, the "
                                       f"chunk has {chunk_bytes}")
            buf.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)
        else:
            n = decompress_into(data, buf.reshape(-1).view(np.uint8))
            if n != chunk_bytes:
                raise OrbaxFormatError(f"{key}: decodes to {n} bytes, the "
                                       f"chunk has {chunk_bytes}")
        if not whole:
            out[region] = buf[tuple(slice(0, r.stop - r.start)
                                    for r in region)]
    return out


_SEQ = object()     # marks a node whose keys are sequence indices


def _rebuild(node):
    """Dicts of sequence indices (marked by _SEQ) into lists."""
    if not isinstance(node, dict):
        return node
    seq = node.pop(_SEQ, False)
    items = {k: _rebuild(v) for k, v in node.items()}
    if not seq:
        return items
    if sorted(items) != list(range(len(items))):
        raise OrbaxFormatError(f"sequence indices {sorted(items)} are not "
                               f"0..{len(items) - 1}")
    return [items[i] for i in range(len(items))]


def read_checkpoint(path: str, decompress: Optional[Callable] = None,
                    decompress_into: Optional[Callable] = None) -> dict:
    """The tree of the orbax checkpoint directory `path`, either layout.
    decompress / decompress_into: the zstd decoders for OCDBT records and
    for chunks (default the host C++ one)."""
    with open(os.path.join(path, "_METADATA"), encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{path}: zarr3 arrays are not read")
    if meta.get("use_ocdbt"):
        from qpnet_tpu_torch.train.ocdbt import OcdbtStore
        store = OcdbtStore(path, decompress)
    else:
        store = _Files(path)
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        vm = entry["value_metadata"]
        node = root
        for k, nxt in zip(keys, keys[1:] + [None]):
            if k["key_type"] not in (DICT_KEY, SEQUENCE_KEY):
                raise OrbaxFormatError(f"key type {k['key_type']}")
            if k["key_type"] == SEQUENCE_KEY:
                node[_SEQ] = True
            name = (int(k["key"]) if k["key_type"] == SEQUENCE_KEY
                    else k["key"])
            if nxt is not None:
                node = node.setdefault(name, {})
                continue
            vtype = vm["value_type"]
            if vtype == "None":
                node[name] = None
            elif vtype in ("np.ndarray", "jax.Array", "scalar"):
                a = read_array(store, ".".join(x["key"] for x in keys),
                               decompress_into)
                node[name] = a.item() if vtype == "scalar" else a
            else:
                raise OrbaxFormatError(f"value type {vtype!r}")
    return _rebuild(root)


def _leaves(tree, path: Tuple = ()) -> List[Tuple[Tuple, object]]:
    """(path of (key, key type) pairs, leaf) in orbax's order."""
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += _leaves(tree[k], path + ((str(k), DICT_KEY),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, path + ((str(i), SEQUENCE_KEY),))
        return out
    return [(path, tree)]


def _write_array(root: str, name: str, a: np.ndarray) -> None:
    a = np.asarray(a, order="C")      # keeps 0-d arrays 0-d
    if a.dtype.byteorder == ">" or a.dtype.kind not in "biuf":
        raise OrbaxFormatError(f"{name}: dtype {a.dtype} is not written")
    os.makedirs(os.path.join(root, name))
    meta = {"chunks": [max(s, 1) for s in a.shape], "compressor": _ZSTD,
            "dimension_separator": ".", "dtype": a.dtype.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(a.shape), "zarr_format": 2}
    with open(os.path.join(root, name, ".zarray"), "w") as f:
        json.dump(meta, f, separators=(",", ":"), sort_keys=True)
    if a.size == 0:
        return
    key = ".".join(["0"] * a.ndim) or "0"
    with open(os.path.join(root, name, key), "wb") as f:
        for part in zstd.raw_frame_parts(a.reshape(-1).view(np.uint8)):
            f.write(part)


def write_checkpoint(path: str, tree: dict) -> str:
    """Write `tree` (dicts and lists of numpy arrays, Python numbers and
    None) as the orbax checkpoint directory `path` in the plain layout,
    replacing what is there; returns `path`."""
    path = path.rstrip(os.sep)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    started = time.time_ns()
    tree_meta: Dict[str, dict] = {}
    for keys, leaf in _leaves(tree):
        names = [k for k, _ in keys]
        if leaf is None:
            vtype = "None"
        else:
            vtype = "scalar" if isinstance(leaf, (int, float)) else \
                "np.ndarray"
            if isinstance(leaf, bool) or not isinstance(
                    leaf, (int, float, np.ndarray)):
                raise OrbaxFormatError(f"{'.'.join(names)}: "
                                       f"{type(leaf).__name__} is not "
                                       f"written")
            _write_array(tmp, ".".join(names), np.asarray(leaf))
        tree_meta[repr(tuple(names))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": vtype,
                               "skip_deserialize": leaf is None}}
    with open(os.path.join(tmp, "_METADATA"), "w", encoding="utf-8") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w",
              encoding="utf-8") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {},
                   "performance_metrics": {},
                   "init_timestamp_nsecs": started,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    old = path + ".old"
    if os.path.lexists(path):
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)
    return path
