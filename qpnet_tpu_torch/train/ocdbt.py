"""A read-only OCDBT key-value store: the on-disk b-tree that orbax's
default checkpoint layout keeps its arrays in (tensorstore's `ocdbt`
key-value store), read without tensorstore.

Layout, as tensorstore writes it (format version 0):

- Every manifest, b-tree node and version-tree node is a record: a 4-byte
  big-endian magic number (0x0cdb3a2a, 0x0cdb20de, 0x0cdb1234), its whole
  length as a little-endian u64, the format version and the compression
  (0 none, 1 zstd) as varints, the body (a zstd frame when compressed), and
  the crc32c (Castagnoli) of everything before it, little-endian.  Every
  record read is checked.
- `manifest.ocdbt` holds the config (uuid, manifest kind, value and node
  limits, version-tree arity, compression) and, for the single-file kind,
  a data-file table, the newest versions inline and references to
  version-tree nodes holding the older ones.  The newest generation's root
  is the store's content.
- A data-file table lists paths relative to the store's directory, each
  prefix-compressed against the one before (`d/<hash>`,
  `ocdbt.process_<i>/d/<hash>`).  A reference is (file id, offset, length).
- A b-tree node holds its height, its own data-file table and its entries,
  column by column: keys prefix-compressed against the previous key, then
  for a leaf each value's length, kind (inline or indirect), the indirect
  values' (file, offset) and the inline bytes; for an interior node each
  child's subtree common-prefix length, reference and statistics.  Keys
  under an interior entry drop that entry's subtree common prefix.

Node bodies go through the host C++ zstd decoder (`train/zstd_native.py`)
unless the caller passes another `decompress`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple, Union

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
_NO_ROOT = (1 << 64) - 1


class OcdbtError(ValueError):
    """An OCDBT record is malformed or fails its crc32c."""


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    c = 0xFFFFFFFF
    t = _CRC
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what} ends early")

    def varint(self) -> int:
        v = shift = 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint over 64 bits")

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u64(self) -> int:
        return int.from_bytes(self.raw(8), "little")

    def column(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} "
                             f"bytes after its end")


def read_record(buf: bytes, magic: int, what: str,
                decompress: Callable[[bytes], bytes]) -> bytes:
    """The body of a record (manifest, b-tree or version-tree node), checked
    against its magic number, length and crc32c."""
    if len(buf) < 4 + 8 + 2 + 4:
        raise OcdbtError(f"{what}: {len(buf)} bytes is too short")
    if int.from_bytes(buf[:4], "big") != magic:
        raise OcdbtError(f"{what}: magic {buf[:4].hex()} is not "
                         f"{magic:08x}")
    if int.from_bytes(buf[4:12], "little") != len(buf):
        raise OcdbtError(f"{what}: length field disagrees with the record")
    if crc32c(buf[:-4]) != int.from_bytes(buf[-4:], "little"):
        raise OcdbtError(f"{what}: crc32c mismatch")
    r = _Reader(buf[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = buf[r.pos:-4]
    if compression == 1:
        return decompress(body)
    if compression != 0:
        raise OcdbtError(f"{what}: compression {compression}")
    return body


def _data_files(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.column(max(n - 1, 0))
    suffix = r.column(n)
    base = r.column(n)
    paths: List[str] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{r.what}: data-file prefix past its path")
        path = prev[:prefix[i]] + r.raw(suffix[i])
        if base[i] > len(path):
            raise OcdbtError(f"{r.what}: data-file base path past its path")
        paths.append(path.decode())
        prev = path
    return paths


Ref = Tuple[str, int, int]     # (data file, offset, length)


def _refs(r: _Reader, files: List[str], n: int, lengths=None) -> List[Ref]:
    ids = r.column(n)
    offsets = r.column(n)
    lengths = r.column(n) if lengths is None else lengths
    for i in ids:
        if i >= len(files):
            raise OcdbtError(f"{r.what}: data file {i} of {len(files)}")
    return [(files[i], o, k) for i, o, k in zip(ids, offsets, lengths)]


def _version_leaves(r: _Reader, files: List[str]) -> List[dict]:
    n = r.varint()
    gens = r.column(n)
    heights = [r.u8() for _ in range(n)]
    ids = r.column(n)
    offsets = r.column(n)
    lengths = r.column(n)
    num_keys = r.column(n)
    r.column(n)                                 # tree bytes
    r.column(n)                                 # indirect value bytes
    [r.u64() for _ in range(n)]                 # commit times
    out = []
    for k in range(n):
        if offsets[k] == _NO_ROOT:
            root = None
        elif ids[k] >= len(files):
            raise OcdbtError(f"{r.what}: data file {ids[k]} of {len(files)}")
        else:
            root = (files[ids[k]], offsets[k], lengths[k])
        out.append({"generation": gens[k], "height": heights[k],
                    "root": root, "num_keys": num_keys[k]})
    return out


def _version_nodes(r: _Reader, files: List[str], height: Optional[int]
                   ) -> List[Tuple[int, Ref, int]]:
    """Interior version-tree entries: (generation, reference, height).
    The manifest stores each entry's height; a node implies its own less
    one."""
    n = r.varint()
    gens = r.column(n)
    refs = _refs(r, files, n)
    r.column(n)                                 # generations below
    [r.u64() for _ in range(n)]                 # commit times
    heights = [r.u8() for _ in range(n)] if height is None else [height] * n
    return list(zip(gens, refs, heights))


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.column(max(n - 1, 0))
    suffix = r.column(n)
    common = r.column(n) if interior else [0] * n
    keys: List[bytes] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{r.what}: key prefix past the previous key")
        prev = prev[:prefix[i]] + r.raw(suffix[i])
        keys.append(prev)
    for key, c in zip(keys, common):
        if c > len(key):
            raise OcdbtError(f"{r.what}: subtree prefix past its key")
    return keys, common


Value = Union[bytes, Ref]


class OcdbtStore:
    """The newest generation of the OCDBT store in directory `root`:
    `keys()` lists it, `read(key)` gives a value's bytes.  decompress: the
    zstd decoder for record bodies (default the host C++ one)."""

    def __init__(self, root: str,
                 decompress: Optional[Callable[[bytes], bytes]] = None):
        if decompress is None:
            from qpnet_tpu_torch.train import zstd_native
            decompress = zstd_native.decompress
        self.root = os.path.abspath(root)
        self._decompress = decompress
        self._files: Dict[str, bytes] = {}
        manifest = self._file("manifest.ocdbt")
        r = _Reader(read_record(manifest, MANIFEST_MAGIC, "manifest.ocdbt",
                                decompress), "manifest.ocdbt")
        r.raw(16)                                   # uuid
        kind = r.varint()
        r.varint()                                  # max inline value bytes
        r.varint()                                  # max decoded node bytes
        r.u8()                                      # version-tree arity log2
        compression = r.varint()
        if compression == 1:
            r.raw(4)                                # zstd level
        elif compression != 0:
            raise OcdbtError(f"manifest.ocdbt: compression {compression}")
        if kind != 0:
            raise OcdbtError("manifest.ocdbt: only the single-file manifest "
                             "kind is read (this one is numbered)")
        files = _data_files(r)
        versions = _version_leaves(r, files)
        pending = _version_nodes(r, files, None)
        r.end()
        while pending:
            gen, ref, height = pending.pop()
            body = self._record(ref, VERSION_MAGIC, "version-tree node")
            vr = _Reader(body, f"version-tree node {ref}")
            vr.u8()                                  # arity log2
            if vr.u8() != height:
                raise OcdbtError(f"{vr.what}: height disagrees with its "
                                 f"reference")
            vfiles = _data_files(vr)
            if height == 0:
                versions += _version_leaves(vr, vfiles)
            else:
                pending += _version_nodes(vr, vfiles, height - 1)
            vr.end()
        if not versions:
            raise OcdbtError("manifest.ocdbt lists no version")
        self.generations = sorted(v["generation"] for v in versions)
        newest = max(versions, key=lambda v: v["generation"])
        self._index: Dict[bytes, Value] = {}
        if newest["root"] is not None:
            self._walk(newest["root"], newest["height"], b"")
        if len(self._index) != newest["num_keys"]:
            raise OcdbtError(f"b-tree holds {len(self._index)} keys, its "
                             f"version says {newest['num_keys']}")

    def _file(self, path: str) -> bytes:
        if path not in self._files:
            parts = path.split("/")
            if os.path.isabs(path) or ".." in parts or "" in parts:
                raise OcdbtError(f"data file path {path!r} leaves the store")
            with open(os.path.join(self.root, *parts), "rb") as f:
                self._files[path] = f.read()
        return self._files[path]

    def _slice(self, ref: Ref) -> bytes:
        path, offset, length = ref
        data = self._file(path)
        if offset + length > len(data):
            raise OcdbtError(f"{ref} past the end of {path}")
        return data[offset:offset + length]

    def _record(self, ref: Ref, magic: int, what: str) -> bytes:
        return read_record(self._slice(ref), magic, f"{what} {ref}",
                           self._decompress)

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        r = _Reader(self._record(ref, BTREE_MAGIC, "b-tree node"),
                    f"b-tree node {ref}")
        if r.u8() != height:
            raise OcdbtError(f"{r.what}: height disagrees with its parent")
        files = _data_files(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            children = _refs(r, files, n)
            [r.column(n) for _ in range(3)]         # statistics
            r.end()
            for key, c, child in zip(keys, common, children):
                self._walk(child, height - 1, prefix + key[:c])
            return
        lengths = r.column(n)
        kinds = r.column(n)
        if any(k > 1 for k in kinds):
            raise OcdbtError(f"{r.what}: value kind {max(kinds)}")
        indirect = [i for i in range(n) if kinds[i] == 1]
        refs = iter(_refs(r, files, len(indirect),
                          [lengths[i] for i in indirect]))
        for key, length, kind in zip(keys, lengths, kinds):
            self._index[prefix + key] = (next(refs) if kind
                                         else r.raw(length))
        r.end()

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._index)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._index

    def read(self, key: str) -> bytes:
        value = self._index[key.encode()]
        return value if isinstance(value, bytes) else self._slice(value)
