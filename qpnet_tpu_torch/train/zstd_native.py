"""ctypes binding to the host C++ zstd decoder (`csrc/zstd_decode.cpp`), the
decoder the checkpoint readers use; `train/zstd.py` is its plain reference.

The library builds at first use with the host compiler (`ops/_build.py`)
into the build directory.  There is no fallback: where it cannot build or
load, the call raises with the compiler's error.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from qpnet_tpu_torch.train.zstd import ZstdError, content_size

_lock = threading.Lock()
_LIB = None


def _load() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            from qpnet_tpu_torch.ops import _build
            lib = _build.load("zstd_decode")
            lib.qpzstd_decompress.restype = ctypes.c_int64
            lib.qpzstd_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64]
            lib.qpzstd_last_error.restype = ctypes.c_char_p
            lib.qpzstd_last_error.argtypes = []
            _LIB = lib
        return _LIB


def _decode(src: np.ndarray, out: np.ndarray) -> int:
    """Bytes written into `out`, or -2 when it is too small."""
    lib = _load()
    n = lib.qpzstd_decompress(src.ctypes.data, src.size, out.ctypes.data,
                              out.nbytes)
    if n == -1:
        raise ZstdError(lib.qpzstd_last_error().decode())
    return int(n)


def decompress_into(data, out: np.ndarray) -> int:
    """Decode the frames in `data` (bytes-like) into the contiguous array
    `out`; returns the bytes written.  Raises ZstdError on malformed input
    and ValueError when `out` is too small."""
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("decompress_into needs a writeable C-contiguous "
                         "array")
    n = _decode(np.frombuffer(data, np.uint8), out)
    if n == -2:
        raise ValueError(f"zstd frames decode to over {out.nbytes} bytes")
    return n


def decompress(data, size: Optional[int] = None) -> bytes:
    """Decode the frames in `data`.  size: the decoded size where the caller
    knows it; else the first frame's header says, or the buffer grows."""
    src = np.frombuffer(data, np.uint8)
    if size is None:
        size = content_size(src[:18].tobytes())
    cap = max(size if size is not None else 4 * src.size, 1)
    while True:
        out = np.empty(cap, np.uint8)
        n = _decode(src, out)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 2
