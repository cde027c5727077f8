"""The part of the HDF5 file format that h5py writes by default, read and
written in plain Python and numpy, so the port needs no h5py.

The format is the HDF Group's *HDF5 File Format Specification*: a version 0
or 1 superblock, version 1 object headers (with continuation blocks),
groups as symbol tables (a version 1 B-tree of type 0 over symbol-table
nodes, `SNOD`, whose names live in a local heap), and datasets with a
dataspace, an integer or IEEE float datatype, a fill value and a version 3
data layout, contiguous or compact.  This is what h5py 3 writes with its
default `libver="earliest"`: `h5py.File(name, "a").create_dataset(path,
data=array)`.

Reading: `File(name)` opens a file, `File.find(path)` follows a path the
way h5py's `in` does, `File.read(dataset)` reads one dataset with one seek.
Anything outside that part of the format raises `ValueError` naming what
it met: a superblock of version 2 or 3 (`libver="latest"`), a version 2
object header (`OHDR`), link messages or dense groups, soft or external
links, chunked or virtual layouts, filters, external data files, shared
messages, and datatypes other than integers and IEEE floats (h5py's bool
enum, strings, compounds, ...).  Attributes do not change a dataset's data:
they are recorded (`Dataset.extras`, `Group.extras`), not read.

Writing: `write(name, datasets, groups=())` writes a whole file from a dict
of dataset paths to arrays, with the messages h5py writes for a contiguous
dataset, symbol-table groups nested to any depth and any number of children
a group (symbol-table nodes of up to 2 x 4 entries under B-tree nodes of up
to 2 x 16, as many levels as needed).  It writes a temporary file in the
same directory and renames it over the old one, so a reader never sees a
half-written file.

`list_datasets(name)` walks a file: {path without the leading slash:
array}, as h5py's `visititems` names them.
"""

from __future__ import annotations

import mmap
import os
import secrets
import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
LEAF_K, INTERNAL_K = 4, 16          # h5py's defaults: 2K entries a node
HEAP_FREE_NULL = 1                  # a local heap's "no free block"
DATASET_HEADER = 256                # h5py's message space of a dataset
# what the writer lays out (8-byte offsets and lengths)
GROUP_HEADER = 16 + 8 + 16          # prefix, one symbol-table message
BTREE_NODE = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
SNOD_NODE = 8 + 2 * LEAF_K * 40

# message types (the specification's IV.A.2)
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL = 0x0, 0x1, 0x2, 0x3, \
    0x4, 0x5
LINK, EXTERNAL, LAYOUT, BOGUS, GROUP_INFO, FILTERS = 0x6, 0x7, 0x8, 0x9, \
    0xA, 0xB
ATTRIBUTE, COMMENT, MTIME_OLD, CONTINUATION, SYMBOL_TABLE, MTIME = 0xC, \
    0xD, 0xE, 0x10, 0x11, 0x12
ATTRIBUTE_INFO, REFCOUNT = 0x15, 0x16
_SKIPPED = {NIL, FILL_OLD, MTIME_OLD, MTIME, REFCOUNT, BOGUS}
_REFUSED = {LINK_INFO: "a link info message (a new-style group)",
            LINK: "a link message (a new-style group)",
            GROUP_INFO: "a group info message (a new-style group)",
            EXTERNAL: "an external data file list",
            FILTERS: "a filter pipeline (compression or another filter)"}
_EXTRAS = {ATTRIBUTE: "attributes", ATTRIBUTE_INFO: "attributes (dense)",
           COMMENT: "an object comment"}
_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
            6: "compound", 7: "reference",
            8: "enumeration (h5py's bool is one)", 9: "variable-length",
            10: "array"}
# IEEE layouts by size: (exponent location, exponent size, mantissa size,
# bias); the mantissa sits at bit 0 and the sign at the top bit
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


class Dataset:
    """A dataset's header: shape, dtype, where its data lies (`addr`, or
    `compact` bytes), its fill value and what else the header holds."""

    def __init__(self, path, shape, dtype, addr, size, compact, fill,
                 extras):
        self.path, self.shape, self.dtype = path, shape, dtype
        self.addr, self.size, self.compact = addr, size, compact
        self.fill, self.extras = fill, extras


class Group:
    """A group's header: its symbol table's B-tree and local heap, and
    what else the header holds; `children` is read at first use."""

    def __init__(self, path, btree, heap, extras):
        self.path, self.btree, self.heap = path, btree, heap
        self.extras = extras
        self._children = None


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _uint(b: bytes, o: int, n: int) -> int:
    return int.from_bytes(b[o:o + n], "little")


class File:
    """An HDF5 file open for reading (a context manager)."""

    def __init__(self, name: str):
        self.name = name
        with open(name, "rb") as f:       # mapped: a few system calls a file
            size = os.fstat(f.fileno()).st_size
            if size < 8:
                raise OSError(f"{name}: not an HDF5 file ({size} bytes)")
            self._m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            self._superblock()
            self.root = self._object("/", self._root_header, self._root_cache)
            if not isinstance(self.root, Group):
                self._refuse("/", "a root object that is not a group")
        except BaseException:
            self._m.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self._m.close()

    # -- bytes ---------------------------------------------------------------

    def _refuse(self, path, what):
        raise ValueError(f"{self.name}: {path}: {what} is not supported "
                         f"(only the part of HDF5 that h5py writes by "
                         f"default: superblock 0/1, v1 object headers, "
                         f"symbol-table groups, contiguous or compact "
                         f"integer and float datasets)")

    def _at(self, addr: int, n: int) -> bytes:
        b = self._m[self.base + addr:self.base + addr + n]
        if len(b) != n:
            raise ValueError(f"{self.name}: truncated file ({n} bytes at "
                             f"{addr} wanted, {len(b)} there)")
        return b

    def _undef(self, v: int) -> bool:
        return v == (1 << (8 * self.O)) - 1

    # -- superblock ----------------------------------------------------------

    def _superblock(self):
        at = 0
        while self._m[at:at + 8] != SIGNATURE:  # after a user block: 512, ..
            at = 512 if at == 0 else 2 * at
            if at + 8 > len(self._m):
                raise OSError(f"{self.name}: not an HDF5 file (no HDF5 "
                              f"signature)")
        self.userblock = at
        self.base = 0
        b = self._at(at, 24)
        version = b[8]
        if version not in (0, 1):
            self._refuse("/", f"superblock version {version} (libver "
                              f"'latest' or a later format)")
        self.O, self.L = b[13], b[14]
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            raise ValueError(f"{self.name}: sizes of offsets and lengths "
                             f"{self.O}, {self.L}")
        self.leaf_k, self.internal_k = (_uint(b, 16, 2),
                                        _uint(b, 18, 2))
        at += 24 + (4 if version == 1 else 0)
        b = self._at(at, 4 * self.O + 2 * self.O + 24)
        self.base = _uint(b, 0, self.O)
        entry = b[4 * self.O:]
        self._root_header = _uint(entry, self.O, self.O)
        self._root_cache = _uint(entry, 2 * self.O, 4)

    # -- object headers ------------------------------------------------------

    def _messages(self, path, addr):
        """(type, flags, bytes) of every message of a v1 object header,
        continuation blocks followed."""
        head = self._at(addr, 16)
        if head[:4] == b"OHDR":
            self._refuse(path, "a version 2 object header (OHDR)")
        if head[0] != 1:
            raise ValueError(f"{self.name}: {path}: object header version "
                             f"{head[0]} at {addr}")
        left = _uint(head, 2, 2)
        chunks = [(addr + 16, _uint(head, 8, 4))]
        out = []
        while chunks and left:
            start, n = chunks.pop(0)
            b = self._at(start, n)
            p = 0
            while p + 8 <= n and left:
                kind, size, flags = (_uint(b, p, 2),
                                     _uint(b, p + 2, 2), b[p + 4])
                data = b[p + 8:p + 8 + size]
                p += 8 + size
                left -= 1
                if kind == CONTINUATION:
                    chunks.append((_uint(data, 0, self.O),
                                   _uint(data, self.O, self.L)))
                elif kind not in _SKIPPED:
                    out.append((kind, flags, data))
        if left:
            raise ValueError(f"{self.name}: {path}: object header at {addr} "
                             f"ends {left} messages short")
        return out

    def _object(self, path, addr, cache=0):
        """The group or dataset whose header is at `addr`; `cache` is its
        symbol-table entry's cache type (0 none, 1 a group's B-tree and
        heap, 2 a soft link)."""
        if cache == 2:
            self._refuse(path, "a soft link")
        msgs = {}
        extras = []
        for kind, flags, data in self._messages(path, addr):
            if flags & 0x02:
                self._refuse(path, f"a shared message (type {kind:#x}, a "
                                   f"committed datatype or a shared "
                                   f"dataspace)")
            if kind in _REFUSED:
                self._refuse(path, _REFUSED[kind])
            if kind in _EXTRAS:
                extras.append(_EXTRAS[kind])
            elif kind in (SYMBOL_TABLE, DATASPACE, DATATYPE, FILL, LAYOUT):
                msgs[kind] = data
            else:
                self._refuse(path, f"a header message of type {kind:#x}")
        if SYMBOL_TABLE in msgs:
            d = msgs[SYMBOL_TABLE]
            return Group(path, _uint(d, 0, self.O),
                         _uint(d, self.O, self.O), extras)
        if not all(k in msgs for k in (DATASPACE, DATATYPE, LAYOUT)):
            self._refuse(path, "an object that is neither a group nor a "
                               "dataset (a committed datatype?)")
        shape = self._dataspace(path, msgs[DATASPACE])
        dtype = self._datatype(path, msgs[DATATYPE])
        addr, size, compact = self._layout(path, msgs[LAYOUT])
        fill = self._fill(msgs.get(FILL), dtype)
        return Dataset(path, shape, dtype, addr, size, compact, fill, extras)

    def _dataspace(self, path, d):
        version, rank = d[0], d[1]
        if version == 1:
            p = 8
        elif version == 2:
            if d[3] == 2:
                self._refuse(path, "a null dataspace")
            p = 4
        else:
            self._refuse(path, f"dataspace version {version}")
        return tuple(_uint(d, p + i * self.L, self.L)
                     for i in range(rank))

    def _datatype(self, path, d):
        cls, bits = d[0] & 0x0F, d[1:4]
        size = _uint(d, 4, 4)
        if cls not in (0, 1):
            self._refuse(path, f"datatype class {cls} "
                               f"({_CLASSES.get(cls, 'unknown')})")
        order = ">" if bits[0] & 1 else "<"
        offset, precision = _uint(d, 8, 2), _uint(d, 10, 2)
        if cls == 0:
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                self._refuse(path, f"an integer of {size} bytes at bit "
                                   f"offset {offset}, precision {precision}")
            return np.dtype(f"{order}{'i' if bits[0] & 0x08 else 'u'}{size}")
        layout = (d[12], d[13], d[14], d[15], _uint(d, 16, 4))
        if (bits[0] & 0x40 or size not in _IEEE or offset
                or precision != 8 * size or bits[1] != 8 * size - 1
                or (bits[0] >> 4) & 3 != 2
                or layout != (_IEEE[size][0], _IEEE[size][1], 0,
                              _IEEE[size][2], _IEEE[size][3])):
            self._refuse(path, f"a float of {size} bytes that is not IEEE "
                               f"754 in the usual layout")
        return np.dtype(f"{order}f{size}")

    def _layout(self, path, d):
        version, cls = d[0], d[1]
        if version not in (3, 4):
            self._refuse(path, f"data layout version {version}")
        if cls == 0:
            n = _uint(d, 2, 2)
            return None, n, bytes(d[4:4 + n])
        if cls == 1:
            return (_uint(d, 2, self.O),
                    _uint(d, 2 + self.O, self.L), None)
        self._refuse(path, {2: "a chunked layout",
                            3: "a virtual layout"}.get(cls, f"layout {cls}"))

    def _fill(self, d, dtype):
        """The fill value's bytes where one is defined, else None."""
        if d is None:
            return None
        if d[0] in (1, 2):
            if d[0] == 2 and not d[3]:
                return None
            n, p = _uint(d, 4, 4), 8
        elif d[0] == 3 and d[1] & 0x20:
            n, p = _uint(d, 2, 4), 6
        else:
            return None
        return bytes(d[p:p + n]) if n == dtype.itemsize else None

    # -- groups --------------------------------------------------------------

    def _heap(self, path, addr):
        h = self._at(addr, 8 + 2 * self.L + self.O)
        if h[:4] != b"HEAP":
            raise ValueError(f"{self.name}: {path}: no local heap at {addr}")
        size = _uint(h, 8, self.L)
        return self._at(_uint(h, 8 + 2 * self.L, self.O), size)

    def _snods(self, path, addr, out):
        """The SNOD addresses under a group B-tree node, left to right."""
        n_head = 8 + 2 * self.O
        h = self._at(addr, n_head)
        if h[:4] != b"TREE" or h[4] != 0:
            raise ValueError(f"{self.name}: {path}: no group B-tree node at "
                             f"{addr}")
        level, used = h[5], _uint(h, 6, 2)
        if used > 2 * self.internal_k:
            raise ValueError(f"{self.name}: {path}: a B-tree node of {used} "
                             f"entries, K = {self.internal_k}")
        b = self._at(addr + n_head, used * (self.L + self.O) + self.L)
        for i in range(used):
            child = _uint(b, self.L + i * (self.L + self.O), self.O)
            if level:
                self._snods(path, child, out)
            else:
                out.append(child)

    def children(self, group: Group) -> dict:
        """{name: (object header address, entry cache type)} of a group,
        in the file's (byte-sorted) order."""
        if group._children is None:
            heap = self._heap(group.path, group.heap)
            snods = []
            self._snods(group.path, group.btree, snods)
            entry = 2 * self.O + 24
            kids = {}
            for a in snods:
                h = self._at(a, 8)
                if h[:4] != b"SNOD":
                    raise ValueError(f"{self.name}: {group.path}: no symbol "
                                     f"table node at {a}")
                n = _uint(h, 6, 2)
                if n > 2 * self.leaf_k:
                    raise ValueError(f"{self.name}: {group.path}: a symbol "
                                     f"table node of {n} entries, K = "
                                     f"{self.leaf_k}")
                b = self._at(a + 8, n * entry)
                for i in range(n):
                    e = b[i * entry:(i + 1) * entry]
                    o = _uint(e, 0, self.O)
                    name = heap[o:heap.index(b"\0", o)].decode("utf-8")
                    kids[name] = (_uint(e, self.O, self.O),
                                  _uint(e, 2 * self.O, 4))
            group._children = kids
        return group._children

    def child(self, group: Group, name: str):
        """The child object called `name`, or None."""
        hit = self.children(group).get(name)
        if hit is None:
            return None
        path = group.path.rstrip("/") + "/" + name
        return self._object(path, *hit)

    # -- paths ---------------------------------------------------------------

    def find(self, path: str, lookup: bool = False):
        """The object at `path`, or None where h5py's `path in file` is
        False: '' is nothing, slashes repeat freely, '.' stays in a group,
        and a path cannot go on through a dataset.  With lookup=True, as
        h5py's `file[path]` (HDF5's own traversal): a '.' after a dataset
        still names the dataset."""
        if not path:
            return None
        node = self.root
        for part in path.split("/"):
            if not part or (lookup and part == "."):
                continue
            if not isinstance(node, Group):
                return None
            if part == ".":
                continue
            node = self.child(node, part)
            if node is None:
                return None
        return node

    def walk(self, group=None):
        """Every (dataset or group) object under `group`, depth first in
        the file's order."""
        group = self.root if group is None else group
        for name in self.children(group):
            node = self.child(group, name)
            yield node
            if isinstance(node, Group):
                yield from self.walk(node)

    # -- data ----------------------------------------------------------------

    def read(self, ds: Dataset) -> np.ndarray:
        """A dataset's array (0-d for a scalar dataspace)."""
        count = int(np.prod(ds.shape, dtype=np.int64))
        nbytes = count * ds.dtype.itemsize
        if ds.compact is not None:
            if len(ds.compact) < nbytes:
                raise ValueError(f"{self.name}: {ds.path}: compact data of "
                                 f"{len(ds.compact)} bytes for {nbytes}")
            a = np.frombuffer(ds.compact, ds.dtype, count).copy()
        elif count == 0:
            a = np.empty(0, ds.dtype)
        elif self._undef(ds.addr):        # never written: the fill value
            a = (np.full(count, np.frombuffer(ds.fill, ds.dtype)[0])
                 if ds.fill is not None else np.zeros(count, ds.dtype))
        else:
            if ds.size < nbytes:
                raise ValueError(f"{self.name}: {ds.path}: {ds.size} bytes "
                                 f"stored for {nbytes}")
            at = self.base + ds.addr
            if at + nbytes > len(self._m):
                raise ValueError(f"{self.name}: {ds.path}: truncated data")
            a = np.frombuffer(self._m, ds.dtype, count, at).copy()
        return a.reshape(ds.shape)


def contents(f: File):
    """({path: array}, [group paths]) of a whole open file, paths
    absolute, for a writer that carries every object across: anything it
    could not carry (a user block, attributes, an object comment, or what
    `File` refuses) raises ValueError before anything is written."""
    sets, groups = {}, []
    if f.userblock:
        f._refuse("/", f"a user block of {f.userblock} bytes")
    for node in [f.root, *f.walk()]:
        if node.extras:
            f._refuse(node.path, " and ".join(sorted(set(node.extras))))
        if isinstance(node, Group):
            groups.append(node.path)
        else:
            sets[node.path] = f.read(node)
    return sets, groups


def list_datasets(name: str) -> dict:
    """{path without the leading slash: array} of every dataset, in the
    file's order (a scalar dataspace gives a numpy scalar, as h5py's
    `dataset[()]`)."""
    with File(name) as f:
        return {node.path[1:]: f.read(node)[()] for node in f.walk()
                if isinstance(node, Dataset)}


# --- the writer ------------------------------------------------------------

_UNDEF = (1 << 64) - 1


def check_dtype(dtype: np.dtype, path: str = "") -> None:
    """ValueError unless the writer stores `dtype`: integers of 1-8 bytes
    and IEEE floats of 2, 4 or 8 bytes, either byte order."""
    if not ((dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8))
            or (dtype.kind == "f" and dtype.itemsize in _IEEE)):
        raise ValueError(f"{path}: dtype {dtype} is not supported (integers "
                         f"of 1-8 bytes and floats of 2, 4 or 8 bytes only)")


def _msg(kind: int, data: bytes, flags: int = 0) -> bytes:
    data += bytes(_align8(len(data)) - len(data))
    return struct.pack("<HHB3x", kind, len(data), flags) + data


def _datatype(dtype: np.dtype) -> bytes:
    order = 1 if dtype.byteorder == ">" or (
        dtype.byteorder == "=" and not np.little_endian) else 0
    n = dtype.itemsize
    if dtype.kind in "iu":
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return struct.pack("<B3BIHH", 0x10, bits, 0, 0, n, 0, 8 * n)
    e_loc, e_size, m_size, bias = _IEEE[n]
    return struct.pack("<B3BIHHBBBBI", 0x11, 0x20 | order, 8 * n - 1, 0, n,
                       0, 8 * n, e_loc, e_size, 0, m_size, bias)


def _dataset_header(shape, dtype, addr: int, size: int) -> bytes:
    """h5py's messages for a contiguous dataset: dataspace (version 1, the
    maximum dimensions equal to the dimensions), datatype, fill value
    (version 2, allocated late, the default), layout (version 3), NIL up to
    DATASET_HEADER bytes."""
    rank = len(shape)
    space = struct.pack("<BBB5x", 1, rank, 1 if rank else 0) + struct.pack(
        f"<{2 * rank}Q", *shape, *shape)
    msgs = [_msg(DATASPACE, space), _msg(DATATYPE, _datatype(dtype), 1),
            _msg(FILL, struct.pack("<4BI", 2, 2, 2, 1, 0), 1),
            _msg(LAYOUT, struct.pack("<BBQQ", 3, 1, addr, size))]
    body = b"".join(msgs)
    if len(body) < DATASET_HEADER:
        msgs.append(_msg(NIL, bytes(DATASET_HEADER - len(body) - 8)))
        body = b"".join(msgs)
    return _header(len(msgs), body)


def _header(n_msgs: int, body: bytes) -> bytes:
    return struct.pack("<BBHII4x", 1, 0, n_msgs, 1, len(body)) + body


def _entry(name_off: int, header: int, cache=None) -> bytes:
    if cache is None:
        return struct.pack("<QQI4x16x", name_off, header, 0)
    return struct.pack("<QQI4xQQ", name_off, header, 1, *cache)


class _Node:
    """A group of the tree being written."""

    def __init__(self):
        self.kids = {}          # name (bytes) -> _Node or array


def _split(path: str):
    parts = [p for p in path.split("/") if p and p != "."]
    if not parts or path.endswith("/"):
        raise ValueError(f"{path!r}: a dataset needs a name")
    return [p.encode("utf-8") for p in parts]


def _tree(datasets: dict, groups) -> _Node:
    root = _Node()
    for path in list(groups) + list(datasets):
        is_set = path in datasets
        parts = _split(path) if is_set else [
            p.encode("utf-8") for p in path.split("/") if p and p != "."]
        node = root
        for i, part in enumerate(parts):
            last = i == len(parts) - 1
            have = node.kids.get(part)
            if last and is_set:
                if have is not None:
                    raise ValueError(f"{path}: given twice, or as a group "
                                     f"and a dataset")
                a = np.asarray(datasets[path], order="C")
                check_dtype(a.dtype, path)
                node.kids[part] = a
                break
            if have is None:
                have = node.kids[part] = _Node()
            elif not isinstance(have, _Node):
                raise TypeError(f"{path}: {part.decode()} is a dataset, "
                                f"not a group")
            node = have
    return root


class _Out:
    """The file image being laid out: space allocated, then filled."""

    def __init__(self):
        self.image = bytearray()

    def alloc(self, n: int) -> int:
        at = len(self.image)
        self.image += bytes(_align8(at + n) - at)
        return at

    def put(self, at: int, data) -> None:
        self.image[at:at + len(data)] = data


def _lay_group(out: _Out, node: _Node):
    """Lay out one group's B-tree, heap, symbol-table nodes and children;
    returns its (B-tree, heap) addresses."""
    names = sorted(node.kids)
    # the local heap: "" at offset 0, then every name NUL-terminated
    offs, seg = {}, bytearray(8)
    for nm in names:
        offs[nm] = len(seg)
        seg += nm + bytes(_align8(len(nm) + 1) - len(nm))
    # symbol-table nodes of up to 2 LEAF_K entries, B-tree levels above
    per = 2 * LEAF_K
    snods = [names[i:i + per] for i in range(0, len(names), per)]
    level = [(out.alloc(SNOD_NODE), s[-1]) for s in snods]
    # each level: [(address, last name, children [(address, last name)])]
    levels = []
    kids = level
    while True:
        nodes = [kids[i:i + 2 * INTERNAL_K]
                 for i in range(0, len(kids), 2 * INTERNAL_K)] or [[]]
        lay = [(out.alloc(BTREE_NODE), c[-1][1] if c else b"", c)
               for c in nodes]
        levels.append(lay)
        if len(lay) == 1:
            break
        kids = [(a, last) for a, last, _ in lay]
    root_tree = levels[-1][0][0]
    heap = out.alloc(32)
    seg_at = out.alloc(len(seg))
    out.put(heap, b"HEAP" + struct.pack("<B3xQQQ", 0, len(seg),
                                        HEAP_FREE_NULL, seg_at))
    out.put(seg_at, bytes(seg))
    for depth, lay in enumerate(levels):
        for j, (at, _, children) in enumerate(lay):
            left = lay[j - 1][0] if j else _UNDEF
            right = lay[j + 1][0] if j + 1 < len(lay) else _UNDEF
            # key 0: the last name left of this node ("" for the first)
            first = offs[lay[j - 1][1]] if j else 0
            keys = [first] + [offs[last] for _, last in children]
            body = bytearray(b"TREE" + struct.pack(
                "<BBHQQ", 0, depth, len(children), left, right))
            body += struct.pack("<Q", keys[0])
            for (child, _), k in zip(children, keys[1:]):
                body += struct.pack("<QQ", child, k)
            body += bytes(BTREE_NODE - len(body))
            out.put(at, bytes(body))
    # children: each object header, then a dataset's data or a subgroup
    entries = {}
    for nm in names:
        kid = node.kids[nm]
        if isinstance(kid, _Node):
            at = out.alloc(GROUP_HEADER)
            cache = _lay_group(out, kid)
            out.put(at, _header(1, _msg(SYMBOL_TABLE,
                                        struct.pack("<QQ", *cache))))
            entries[nm] = _entry(offs[nm], at, cache)
        else:
            hdr = len(_dataset_header(kid.shape, kid.dtype, 0, 0))
            at = out.alloc(hdr)
            if kid.nbytes:
                data = out.alloc(kid.nbytes)
                out.put(data, memoryview(kid.reshape(-1)).cast("B"))
            else:
                data = _UNDEF
            out.put(at, _dataset_header(kid.shape, kid.dtype, data,
                                        kid.nbytes))
            entries[nm] = _entry(offs[nm], at)
    for (at, _), s in zip(level, snods):
        body = b"SNOD" + struct.pack("<BxH", 1, len(s)) + b"".join(
            entries[nm] for nm in s)
        out.put(at, body + bytes(SNOD_NODE - len(body)))
    return root_tree, heap


def write(name: str, datasets: dict, groups=()) -> None:
    """Write a whole HDF5 file: every dataset of `datasets` ({path:
    array}) and the groups on their paths, plus the (possibly empty)
    groups named in `groups`.  Written to a temporary file in the same
    directory, then renamed over `name`."""
    root = _tree(datasets, groups)
    out = _Out()
    out.alloc(96)                                   # the superblock
    root_at = out.alloc(GROUP_HEADER)
    cache = _lay_group(out, root)
    out.put(root_at, _header(1, _msg(SYMBOL_TABLE,
                                     struct.pack("<QQ", *cache))))
    eof = len(out.image)
    out.put(0, SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                       LEAF_K, INTERNAL_K, 0)
            + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
            + _entry(0, root_at, cache))
    d = os.path.dirname(os.path.abspath(name))
    tmp = os.path.join(d, f".{os.path.basename(name)}.{secrets.token_hex(6)}"
                          f".tmp")
    try:
        with open(tmp, "xb") as f:
            f.write(out.image)
        os.replace(tmp, name)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
