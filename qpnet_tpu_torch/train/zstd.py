"""A zstd decoder in plain Python (RFC 8878), and a writer of zstd frames
made of raw blocks.

The decoder is the reference for the host C++ decoder `csrc/zstd_decode.cpp`
(`train/zstd_native.py`), which is what the checkpoint readers use: this one
takes about a second per 100 KB of entropy-coded input.  It reads every frame
the zstd library writes without a dictionary: raw, RLE and compressed blocks;
raw, RLE, Huffman and treeless literals in 1 or 4 streams, with Huffman
weights given directly or FSE-compressed; sequences whose FSE tables are
predefined, RLE, described or repeated from an earlier block of the frame;
the repeat offsets; skippable frames; and the optional XXH64 content
checksum.  Malformed input raises `ZstdError`.

`raw_frame_parts` writes a valid frame without compressing (raw blocks, the
content size in the header, no checksum): what the port's orbax writer puts
in its chunk files.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

MAGIC = 0xFD2FB528
SKIPPABLE_MASK, SKIPPABLE = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 1 << 17
_M64 = (1 << 64) - 1


class ZstdError(ValueError):
    """A zstd frame is malformed, truncated or fails its checksum."""


# --- XXH64 -----------------------------------------------------------------

_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the hash zstd's content checksum takes the low 32
    bits of)."""
    n, p = len(data), 0
    mv = memoryview(data)
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        while p + 32 <= n:
            for k in range(4):
                v[k] = _round(v[k], int.from_bytes(mv[p:p + 8], "little"))
                p += 8
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for k in range(4):
            h = ((h ^ _round(0, v[k])) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(mv[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(mv[p:p + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (mv[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# --- bit readers -------------------------------------------------------------

class _Forward:
    """Little-endian bits read from the front (FSE table descriptions)."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.start, self.end, self.bit = data, pos, end, 0

    def peek(self, n: int) -> int:
        """The next n bits; bits past the section read as zeros (the
        caller checks bytes_used)."""
        lo = self.start * 8 + self.bit
        first, last = lo >> 3, min((lo + n + 7) >> 3, self.end)
        v = int.from_bytes(self.data[first:last], "little") >> (lo & 7)
        return v & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.bit += n
        return v

    def bytes_used(self) -> int:
        used = (self.bit + 7) >> 3
        if self.start + used > self.end:
            raise ZstdError("FSE table description past its section")
        return used


class _Backward:
    """Bits read from the end of a stream towards its start, after the
    highest set bit of the last byte (the padding marker).  Reading past the
    start gives zeros and leaves `pos` negative: the callers check."""

    def __init__(self, data: bytes, start: int, end: int):
        if end <= start or data[end - 1] == 0:
            raise ZstdError("bitstream without its end marker")
        self.data, self.start = data, start
        self.pos = (end - 1 - start) * 8 + data[end - 1].bit_length() - 1

    def peek(self, n: int) -> int:
        lo = self.pos - n
        if n == 0:
            return 0
        if lo >= 0:
            b = self.start + (lo >> 3)
            e = self.start + ((self.pos + 7) >> 3)
            return (int.from_bytes(self.data[b:e], "little")
                    >> (lo & 7)) & ((1 << n) - 1)
        if self.pos <= 0:
            return 0
        e = self.start + ((self.pos + 7) >> 3)
        v = int.from_bytes(self.data[self.start:e], "little")
        return (v & ((1 << self.pos) - 1)) << (-lo)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos -= n
        return v


# --- FSE ---------------------------------------------------------------------

def _read_fse_counts(data: bytes, pos: int, end: int, max_symbol: int,
                     max_log: int) -> Tuple[List[int], int, int]:
    """An FSE table description at data[pos:]: (normalized counts, accuracy
    log, bytes used)."""
    bits = _Forward(data, pos, end)
    log = bits.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} over {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description has too many symbols")
        mx = (2 * threshold - 1) - remaining
        low = bits.peek(nbits - 1) & (threshold - 1)
        if low < mx:
            val = low
            bits.read(nbits - 1)
        else:
            val = bits.read(nbits) & (2 * threshold - 1)
            if val >= threshold:
                val -= mx
        count = val - 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:
                rep = bits.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol + 1:
                raise ZstdError("FSE zero run past the last symbol")
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ZstdError("FSE counts do not sum to the table size")
    return counts, log, bits.bytes_used()


def _fse_table(counts: Sequence[int], log: int):
    """Decoding table: lists (symbol, bits, base) indexed by state."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("FSE table spread did not come back to 0")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        s = symbol[u]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        nbits[u] = nb
        base[u] = (x << nb) - size
    return symbol, nbits, base, log


def _rle_table(sym: int):
    return [sym], [0], [0], 0


_LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
               2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1)
_ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1)
_OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, -1, -1, -1, -1, -1)
_PREDEFINED = {"ll": (_LL_DEFAULT, 6), "of": (_OF_DEFAULT, 5),
               "ml": (_ML_DEFAULT, 6)}
_MAX = {"ll": (35, 9), "of": (31, 8), "ml": (52, 9)}

_LL_BASE = (list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                               256, 512, 1024, 2048, 4096, 8192, 16384,
                               32768, 65536])
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13,
                       14, 15, 16]
_ML_BASE = ([c + 3 for c in range(32)]
            + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
               1027, 2051, 4099, 8195, 16387, 32771, 65539])
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]


# --- Huffman -----------------------------------------------------------------

def _huffman_weights(data: bytes, pos: int, end: int) -> Tuple[List[int], int]:
    """The Huffman tree description at data[pos:]: (weights of all but the
    last symbol, bytes used)."""
    if pos >= end:
        raise ZstdError("Huffman tree description missing")
    head = data[pos]
    if head >= 128:
        n = head - 127
        used = 1 + (n + 1) // 2
        if pos + used > end:
            raise ZstdError("Huffman weights past the literals section")
        w = []
        for i in range(n):
            b = data[pos + 1 + i // 2]
            w.append(b >> 4 if i % 2 == 0 else b & 15)
        return w, used
    if pos + 1 + head > end:
        raise ZstdError("Huffman weights past the literals section")
    counts, log, used = _read_fse_counts(data, pos + 1, pos + 1 + head, 255,
                                         6)
    sym, nb, base, _ = _fse_table(counts, log)
    bits = _Backward(data, pos + 1 + used, pos + 1 + head)
    s1, s2 = bits.read(log), bits.read(log)
    w: List[int] = []
    while True:
        if len(w) > 254:
            raise ZstdError("too many Huffman weights")
        w.append(sym[s1])
        s1 = base[s1] + bits.read(nb[s1])
        if bits.pos < 0:
            w.append(sym[s2])
            break
        w.append(sym[s2])
        s2 = base[s2] + bits.read(nb[s2])
        if bits.pos < 0:
            w.append(sym[s1])
            break
    return w, 1 + head


def _huffman_table(weights: List[int]):
    """(symbols, lengths, max bits) indexed by the next max-bits bits."""
    if not weights or max(weights) > 11:
        raise ZstdError("bad Huffman weights")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman weights do not complete a power of 2")
    if max_bits > 11:
        raise ZstdError("Huffman code longer than 11 bits")
    weights = weights + [rest.bit_length()]
    size = 1 << max_bits
    syms, lens = [0] * size, [0] * size
    pos = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                syms[pos:pos + n] = [s] * n
                lens[pos:pos + n] = [max_bits + 1 - w] * n
                pos += n
    return syms, lens, max_bits


def _huffman_stream(data: bytes, start: int, end: int, table, n: int,
                    out: bytearray) -> None:
    syms, lens, mb = table
    bits = _Backward(data, start, end)
    for _ in range(n):
        k = bits.peek(mb)
        out.append(syms[k])
        bits.pos -= lens[k]
    if bits.pos != 0:
        raise ZstdError("Huffman stream not consumed exactly")


# --- frames ------------------------------------------------------------------

class _Frame:
    """What a frame's blocks share: the tables and the repeat offsets."""

    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(data: bytes, pos: int, end: int, fr: _Frame
              ) -> Tuple[bytes, int]:
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        hsize = (1, 2, 1, 3)[fmt]
        if pos + hsize > end:
            raise ZstdError("literals header past the block")
        h = int.from_bytes(data[pos:pos + hsize], "little")
        size = h >> 3 if hsize == 1 else h >> 4
        pos += hsize
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals past the block")
            return bytes(data[pos:pos + size]), pos + size
        if pos >= end:
            raise ZstdError("RLE literals past the block")
        return bytes([data[pos]]) * size, pos + 1
    hsize, nb, streams = ((3, 10, 1), (3, 10, 4), (4, 14, 4),
                          (5, 18, 4))[fmt]
    if pos + hsize > end:
        raise ZstdError("literals header past the block")
    h = int.from_bytes(data[pos:pos + hsize], "little")
    regen = (h >> 4) & ((1 << nb) - 1)
    csize = (h >> (4 + nb)) & ((1 << nb) - 1)
    pos += hsize
    stop = pos + csize
    if stop > end:
        raise ZstdError("compressed literals past the block")
    if kind == 2:
        weights, used = _huffman_weights(data, pos, stop)
        fr.huffman = _huffman_table(weights)
        pos += used
    elif fr.huffman is None:
        raise ZstdError("treeless literals without an earlier table")
    out = bytearray()
    if streams == 1:
        _huffman_stream(data, pos, stop, fr.huffman, regen, out)
    else:
        if pos + 6 > stop:
            raise ZstdError("literals jump table past the section")
        s1, s2, s3 = (int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2],
                                     "little") for i in range(3))
        seg = (regen + 3) // 4
        if 3 * seg > regen:
            raise ZstdError("4 literal streams for under 4 bytes a stream")
        p = pos + 6
        bounds = [p, p + s1, p + s1 + s2, p + s1 + s2 + s3, stop]
        if bounds[3] > stop:
            raise ZstdError("literals jump table past the section")
        for i in range(4):
            _huffman_stream(data, bounds[i], bounds[i + 1], fr.huffman,
                            seg if i < 3 else regen - 3 * seg, out)
    return bytes(out), stop


def _sequence_table(data: bytes, pos: int, end: int, mode: int, name: str,
                    fr: _Frame):
    if mode == 0:
        counts, log = _PREDEFINED[name]
        fr.tables[name] = _fse_table(counts, log)
        return pos
    if mode == 1:
        if pos >= end:
            raise ZstdError("RLE symbol past the block")
        if data[pos] > _MAX[name][0]:
            raise ZstdError(f"RLE {name} symbol {data[pos]} out of range")
        fr.tables[name] = _rle_table(data[pos])
        return pos + 1
    if mode == 2:
        max_symbol, max_log = _MAX[name]
        counts, log, used = _read_fse_counts(data, pos, end, max_symbol,
                                             max_log)
        fr.tables[name] = _fse_table(counts, log)
        return pos + used
    if fr.tables[name] is None:
        raise ZstdError(f"repeat {name} table without an earlier one")
    return pos


def _block(data: bytes, pos: int, end: int, fr: _Frame,
           out: bytearray, frame_start: int) -> None:
    lits, pos = _literals(data, pos, end, fr)
    if pos >= end:
        raise ZstdError("sequences section missing")
    b0 = data[pos]
    if b0 == 0:
        nseq, pos = 0, pos + 1
    elif b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != end:
            raise ZstdError("bytes after an empty sequences section")
        out += lits
        return
    if pos >= end:
        raise ZstdError("sequence modes past the block")
    modes = data[pos]
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    pos += 1
    pos = _sequence_table(data, pos, end, modes >> 6, "ll", fr)
    pos = _sequence_table(data, pos, end, (modes >> 4) & 3, "of", fr)
    pos = _sequence_table(data, pos, end, (modes >> 2) & 3, "ml", fr)
    (lsym, lnb, lbase, llog) = fr.tables["ll"]
    (osym, onb, obase, olog) = fr.tables["of"]
    (msym, mnb, mbase, mlog) = fr.tables["ml"]
    bits = _Backward(data, pos, end)
    ls, os_, ms = bits.read(llog), bits.read(olog), bits.read(mlog)
    reps = fr.reps
    lit = 0
    for i in range(nseq):
        ocode, mcode, lcode = osym[os_], msym[ms], lsym[ls]
        if ocode > 31:
            raise ZstdError(f"offset code {ocode} over 31")
        oval = (1 << ocode) + bits.read(ocode)
        mlen = _ML_BASE[mcode] + bits.read(_ML_BITS[mcode])
        llen = _LL_BASE[lcode] + bits.read(_LL_BITS[lcode])
        if oval > 3:
            off = oval - 3
            reps[:] = [off, reps[0], reps[1]]
        else:
            idx = oval + (llen == 0)
            if idx == 1:
                off = reps[0]
            elif idx == 2:
                off = reps[1]
                reps[:] = [off, reps[0], reps[2]]
            else:
                off = reps[2] if idx == 3 else reps[0] - 1
                reps[:] = [off, reps[0], reps[1]]
        if i + 1 < nseq:
            ls = lbase[ls] + bits.read(lnb[ls])
            ms = mbase[ms] + bits.read(mnb[ms])
            os_ = obase[os_] + bits.read(onb[os_])
        if bits.pos < 0:
            raise ZstdError("sequences bitstream overrun")
        if lit + llen > len(lits):
            raise ZstdError("sequence takes more literals than there are")
        out += lits[lit:lit + llen]
        lit += llen
        start = len(out) - off
        if off == 0 or start < frame_start:
            raise ZstdError(f"match offset {off} before the frame's start")
        if off >= mlen:
            out += out[start:start + mlen]
        else:
            out += (out[start:] * (mlen // off + 1))[:mlen]
    if bits.pos != 0:
        raise ZstdError("sequences bitstream not consumed exactly")
    out += lits[lit:]


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    n = len(data)
    if pos >= n:
        raise ZstdError("truncated frame header")
    fhd = data[pos]
    pos += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    if not single:
        pos += 1
    dsize = (0, 1, 2, 4)[dict_flag]
    if pos + dsize > n:
        raise ZstdError("truncated frame header")
    if dsize and int.from_bytes(data[pos:pos + dsize], "little"):
        raise ZstdError("frame needs a dictionary")
    pos += dsize
    fsize = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fsize > n:
        raise ZstdError("truncated frame header")
    content: Optional[int] = None
    if fsize:
        content = int.from_bytes(data[pos:pos + fsize], "little")
        content += 256 if fsize == 2 else 0
    pos += fsize
    start = len(out)
    fr = _Frame()
    while True:
        if pos + 3 > n:
            raise ZstdError("truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 1:
            if pos >= n:
                raise ZstdError("truncated RLE block")
            if size > BLOCK_MAX:
                raise ZstdError("block over 128 KB")
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            if pos + size > n:
                raise ZstdError("truncated block")
            if kind == 0:
                if size > BLOCK_MAX:
                    raise ZstdError("block over 128 KB")
                out += data[pos:pos + size]
            elif kind == 2:
                if size == 0 or size > BLOCK_MAX:
                    raise ZstdError("compressed block of a bad size")
                before = len(out)
                _block(data, pos, pos + size, fr, out, start)
                if len(out) - before > BLOCK_MAX:
                    raise ZstdError("block decodes to over 128 KB")
            else:
                raise ZstdError("reserved block type")
            pos += size
        if last:
            break
    if content is not None and len(out) - start != content:
        raise ZstdError(f"frame decodes to {len(out) - start} bytes, its "
                        f"header says {content}")
    if checksum:
        if pos + 4 > n:
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def decompress(data: bytes) -> bytes:
    """Decode one or more concatenated zstd frames (skippable frames are
    skipped)."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    if not data:
        raise ZstdError("empty input")
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic == MAGIC:
            pos = _frame(data, pos + 4, out)
        elif magic & SKIPPABLE_MASK == SKIPPABLE:
            if pos + 8 > len(data):
                raise ZstdError("truncated skippable frame")
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            if pos > len(data):
                raise ZstdError("truncated skippable frame")
        else:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
    return bytes(out)


def decompress_into(data, out) -> int:
    """decompress(data) written into the uint8 array `out`; returns its
    length (the signature of the host decoder's `decompress_into`)."""
    d = decompress(data)
    if len(d) > out.nbytes:
        raise ValueError(f"zstd frames decode to over {out.nbytes} bytes")
    out[:len(d)] = memoryview(d)
    return len(d)


def content_size(data: bytes) -> Optional[int]:
    """The first frame's content size from its header, or None where the
    header does not say (or the first frame is a skippable one)."""
    magic = int.from_bytes(data[:4], "little")
    if len(data) >= 8 and magic & SKIPPABLE_MASK == SKIPPABLE:
        return None
    if len(data) < 6 or magic != MAGIC:
        raise ZstdError("not a zstd frame")
    fhd = data[4]
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3]
    fsize = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if not fsize:
        return None
    if pos + fsize > len(data):
        raise ZstdError("truncated frame header")
    return (int.from_bytes(data[pos:pos + fsize], "little")
            + (256 if fsize == 2 else 0))


def raw_frame_parts(payload) -> List[bytes]:
    """The pieces of a frame holding `payload` (bytes-like) in raw blocks:
    the header with an 8-byte content size, then each block's 3-byte
    header followed by its slice of the payload (as memoryviews)."""
    mv = memoryview(payload).cast("B")
    n = len(mv)
    # single segment (the window is the content), 8-byte content size
    parts = [MAGIC.to_bytes(4, "little") + bytes([0xE0])
             + n.to_bytes(8, "little")]
    pos = 0
    while True:
        size = min(BLOCK_MAX, n - pos)
        last = pos + size == n
        parts.append(((size << 3) | int(last)).to_bytes(3, "little"))
        parts.append(mv[pos:pos + size])
        pos += size
        if last:
            return parts
