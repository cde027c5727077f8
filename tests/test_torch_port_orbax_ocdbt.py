"""The port's read-only OCDBT store (`train/ocdbt.py`) and zarr v2 reader
(`train/orbax_format.py::read_array`) against tensorstore, which writes the
stores here: small nodes so the b-tree has interior levels, uncompressed
and zstd-compressed, many generations so the version tree spills out of
the manifest; every key and value equals tensorstore's `list` and `read`,
and a flipped byte fails the crc32c check.
"""

import os

import numpy as np
import pytest
import tensorstore as ts

from qpnet_tpu_torch.train import ocdbt as O
from qpnet_tpu_torch.train import orbax_format as OF
from qpnet_tpu_torch.train import zstd as Z


def _open(root, compression, arity_log2=4):
    config = {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16,
              "version_tree_arity_log2": arity_log2,
              "compression": compression}
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}",
                            "config": config}).result()


def _fill(kv, generations, per_generation, seed):
    rng = np.random.default_rng(seed)
    for g in range(generations):
        with ts.Transaction() as txn:
            for i in range(per_generation):
                n = int(rng.integers(0, 60))
                kv.with_transaction(txn).write(
                    f"key{g}/{i:03d}/x", rng.integers(
                        0, 256, n, dtype=np.uint8).tobytes()).result()


def _check_against_tensorstore(root, kv, decompress=None):
    store = O.OcdbtStore(str(root), decompress)
    keys = sorted(k.decode() for k in kv.list().result())
    assert store.keys() == keys
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    return store


@pytest.mark.parametrize("compression", [None, {"id": "zstd", "level": 3}])
def test_store_equals_tensorstore(tmp_path, compression):
    kv = _open(tmp_path, compression)
    _fill(kv, 3, 40, seed=1)
    kv.delete_range(ts.KvStore.KeyRange("key1/010", "key1/020")).result()
    store = _check_against_tensorstore(tmp_path, kv)
    assert len(store.keys()) == 110
    # the plain decoder reads the same
    assert O.OcdbtStore(str(tmp_path), Z.decompress).keys() == store.keys()


def test_interior_nodes_and_indirect_values(tmp_path, monkeypatch):
    kv = _open(tmp_path, None)
    _fill(kv, 1, 200, seed=2)
    heights = []
    walk = O.OcdbtStore._walk

    def record(self, ref, height, prefix):
        heights.append(height)
        return walk(self, ref, height, prefix)

    monkeypatch.setattr(O.OcdbtStore, "_walk", record)
    store = _check_against_tensorstore(tmp_path, kv)
    # 200 keys in nodes of 300 bytes: interior levels above many leaves
    assert max(heights) >= 2 and heights.count(0) > 1
    # values over 16 bytes live in data files, the rest inline
    kinds = {type(store._index[k.encode()]) for k in store.keys()}
    assert kinds == {bytes, tuple}


def test_version_tree_nodes(tmp_path):
    kv = _open(tmp_path, {"id": "zstd", "level": 1}, arity_log2=2)
    for g in range(21):
        kv.write(f"k{g:02d}", b"v" * g).result()
    store = _check_against_tensorstore(tmp_path, kv)
    # 22 generations (the empty first one too), most of them in
    # version-tree nodes of 4 entries outside the manifest
    assert store.generations == list(range(1, 23))


@pytest.mark.parametrize("target", ["manifest", "node"])
def test_flipped_byte_fails_crc(tmp_path, target):
    kv = _open(tmp_path, None)
    _fill(kv, 1, 30, seed=3)
    if target == "manifest":
        path = tmp_path / "manifest.ocdbt"
        at = 20
    else:
        d = tmp_path / "d"
        path = d / sorted(os.listdir(d))[0]
        with open(path, "rb") as f:
            at = f.read().index(O.BTREE_MAGIC.to_bytes(4, "big")) + 16
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(O.OcdbtError, match="crc32c"):
        O.OcdbtStore(str(tmp_path))


def test_crc32c():
    assert O.crc32c(b"123456789") == 0xE3069283
    assert O.crc32c(b"") == 0


@pytest.mark.parametrize("kvstore", ["ocdbt", "file"])
@pytest.mark.parametrize("dtype", ["<f4", "<i4", "<i8", "|u1"])
def test_zarr_chunk_grid(tmp_path, kvstore, dtype):
    """Edge chunks, missing chunks (the fill value), a 0-d array."""
    base = {"driver": "file", "path": str(tmp_path)}
    if kvstore == "ocdbt":
        base = {"driver": "ocdbt", "base": base}
    rng = np.random.default_rng(4)
    want = rng.integers(0, 100, (7, 10)).astype(np.dtype(dtype))
    arr = ts.open({"driver": "zarr", "kvstore": base, "path": "a.b",
                   "metadata": {"chunks": [3, 4], "dtype": dtype,
                                "shape": [7, 10], "fill_value": 5,
                                "compressor": {"id": "zstd", "level": 3}},
                   "create": True}).result()
    arr[:6, :8] = want[:6, :8]
    want[6:, :] = 5
    want[:, 8:] = 5
    zero_d = ts.open({"driver": "zarr", "kvstore": base, "path": "s",
                      "metadata": {"chunks": [], "dtype": "<i8",
                                   "shape": [], "compressor": None},
                      "create": True}).result()
    zero_d[()] = 42
    store = (O.OcdbtStore(str(tmp_path)) if kvstore == "ocdbt"
             else OF._Files(str(tmp_path)))
    got = OF.read_array(store, "a.b")
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    s = OF.read_array(store, "s")
    assert s.shape == () and s.item() == 42
    np.testing.assert_array_equal(
        OF.read_array(store, "a.b", Z.decompress_into), want)
