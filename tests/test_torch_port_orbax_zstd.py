"""The port's zstd decoders: the plain one (`train/zstd.py`) against the
zstandard library's decompression, and the host C++ one
(`csrc/zstd_decode.cpp`, `train/zstd_native.py`) against the plain one,
bit for bit, on frames zstandard writes at levels 1, 3 and 19, with and
without the content checksum, in one block and in several; the raw-block
writer read back by zstandard; malformed frames raise in both decoders.
"""

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from qpnet_tpu_torch.train import zstd as Z
from qpnet_tpu_torch.train import zstd_native as N

LEVELS = (1, 3, 19)


def _inputs():
    rng = np.random.default_rng(0)
    base = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    runs = [base]
    for _ in range(30):
        runs.append(b"\x07" * int(rng.integers(1, 4)))
        runs.append(base[:int(rng.integers(8, 64))])
    with open(Z.__file__, "rb") as f:
        text = f.read()
    return {
        # weights: Huffman-coded literals, few matches
        "f32": (rng.standard_normal(12_000) * 0.05).astype(np.float32)
        .tobytes(),
        "zeros": bytes(60_000),
        "text": text,
        # a block of one literal byte value between matches
        "runs": b"".join(runs),
        "one": b"a",
        "empty": b"",
    }


INPUTS = _inputs()


def _multi_block(data: bytes, level: int, step: int = 3000) -> bytes:
    """One frame whose blocks end every `step` bytes (tables and repeat
    offsets carried across them)."""
    co = zstandard.ZstdCompressor(level=level).compressobj()
    parts = [co.compress(data[i:i + step])
             + co.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
             for i in range(0, len(data), step)]
    return b"".join(parts) + co.flush()


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("checksum", [False, True])
def test_decoders_equal_zstandard(name, level, checksum):
    data = INPUTS[name]
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum).compress(data)
    assert Z.decompress(frame) == data
    assert N.decompress(frame) == data
    assert Z.content_size(frame) == len(data)
    out = np.empty(len(data), np.uint8)
    assert N.decompress_into(frame, out) == len(data)
    assert out.tobytes() == data


@pytest.mark.parametrize("name", ["f32", "text", "runs", "zeros"])
@pytest.mark.parametrize("level", LEVELS)
def test_frames_of_several_blocks(name, level):
    data = INPUTS[name]
    frame = _multi_block(data, level)
    assert Z.decompress(frame) == data
    assert N.decompress(frame) == data
    # a frame without a content size: the native buffer grows
    assert Z.content_size(frame) is None
    assert N.decompress(frame) == Z.decompress(frame)


def test_concatenated_and_skippable_frames():
    a, b = INPUTS["text"], INPUTS["f32"]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"12345"
    data = (zstandard.ZstdCompressor(level=3).compress(a) + skip
            + zstandard.ZstdCompressor(level=1).compress(b))
    assert Z.decompress(data) == a + b
    assert N.decompress(data) == a + b
    assert Z.decompress(skip + data) == N.decompress(skip + data) == a + b


@settings(max_examples=150, deadline=None)
@given(st.binary(max_size=3000), st.sampled_from(LEVELS),
       st.booleans())
def test_drawn_byte_strings(data, level, checksum):
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum).compress(data * 3)
    assert Z.decompress(frame) == data * 3
    assert N.decompress(frame) == data * 3


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 17), (1 << 17) + 1,
                               300_001])
def test_raw_frame_reads_back(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    frame = b"".join(Z.raw_frame_parts(data))
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert Z.decompress(frame) == data
    assert N.decompress(frame) == data
    assert Z.content_size(frame) == n


def test_xxh64():
    assert Z.xxh64(b"") == 0xEF46DB3751D8E999
    assert Z.xxh64(b"a") == 0xD24EC4F1A98C6E5B


def _raises(frame):
    for decode in (Z.decompress, N.decompress):
        with pytest.raises(Z.ZstdError):
            decode(frame)


def test_bad_checksum_raises():
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(INPUTS["text"]))
    frame[-1] ^= 0x40
    _raises(bytes(frame))


@pytest.mark.parametrize("where", [0, 5, "middle", "truncate"])
def test_corrupted_frame_raises(where):
    frame = bytearray(zstandard.ZstdCompressor(level=3).compress(
        INPUTS["text"]))
    if where == "truncate":
        frame = frame[:len(frame) // 2]
    elif where == "middle":
        frame[len(frame) // 2] ^= 0x55
    else:
        frame[where] ^= 0x08    # magic; frame header's reserved bit
    _raises(bytes(frame))


def test_native_buffer_too_small():
    frame = zstandard.ZstdCompressor(level=1).compress(INPUTS["text"])
    with pytest.raises(ValueError, match="decode to over"):
        N.decompress_into(frame, np.empty(100, np.uint8))
