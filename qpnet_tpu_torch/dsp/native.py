"""ctypes binding to the port's host DSP core (`csrc/qpdsp.cpp`), the
counterpart of `qpnet_tpu/dsp/native.py`.

The library builds at first use with the host C++ compiler
(`ops/_build.py`) into the build directory.  There is no fallback: where it
cannot build, the call raises with the compiler's error.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np

_lock = threading.Lock()
_LIB = None

_f64p = ctypes.POINTER(ctypes.c_double)


def _load() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            from qpnet_tpu_torch.ops import _build
            lib = _build.load("qpdsp")
            lib.qpdsp_mlsa_state_size.restype = ctypes.c_int64
            lib.qpdsp_mlsa_state_size.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.qpdsp_mlsa_filter_state.restype = ctypes.c_int
            lib.qpdsp_mlsa_filter_state.argtypes = [
                _f64p, ctypes.c_int64, _f64p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_double, ctypes.c_int, ctypes.c_int, _f64p,
                ctypes.POINTER(ctypes.c_int64), _f64p]
            lib.qpdsp_fir_state.restype = None
            lib.qpdsp_fir_state.argtypes = [_f64p, ctypes.c_int64, _f64p,
                                            ctypes.c_int, _f64p, _f64p]
            _LIB = lib
        return _LIB


def _as_c(a: np.ndarray):
    return a.ctypes.data_as(_f64p)


def mlsa_state_size(order: int, pd: int = 4) -> int:
    """Doubles of one MLSA filter's state: two exp-filter stages of
    (stage inputs (pd,), basis outputs (pd, order))."""
    return int(_load().qpdsp_mlsa_state_size(int(order), int(pd)))


def mlsa_filter_state(x: np.ndarray, b_frames: np.ndarray, alpha: float,
                      hopsize: int, pd: int, state: np.ndarray,
                      counter: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Filter `x` from the filter state `state` (float64, mlsa_state_size
    doubles) after `counter` samples: (y, new state, new counter).  The
    inputs are not modified."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float64)
    b = np.ascontiguousarray(np.atleast_2d(b_frames), np.float64)
    st = np.array(state, np.float64, copy=True, order="C")
    if st.shape != (mlsa_state_size(b.shape[1] - 1, pd),):
        raise ValueError(f"MLSA state of shape {st.shape} for order "
                         f"{b.shape[1] - 1}, pd {pd}")
    ctr = ctypes.c_int64(int(counter))
    out = np.empty_like(x)
    rc = lib.qpdsp_mlsa_filter_state(
        _as_c(x), x.shape[0], _as_c(b), b.shape[0], b.shape[1],
        float(alpha), int(hopsize), int(pd), _as_c(st), ctypes.byref(ctr),
        _as_c(out))
    if rc != 0:
        raise RuntimeError(f"qpdsp_mlsa_filter_state failed (rc={rc})")
    return out, st, int(ctr.value)


def fir_state(x: np.ndarray, taps: np.ndarray, hist: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Causal FIR of `x` after the input history `hist` (the len(taps) - 1
    samples before x, oldest first; zeros at a signal's start):
    (y, the history after x).  The inputs are not modified."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float64)
    taps = np.ascontiguousarray(taps, np.float64)
    h = np.array(hist, np.float64, copy=True, order="C")
    if taps.ndim != 1 or taps.shape[0] < 1 or h.shape != (taps.shape[0] - 1,):
        raise ValueError(f"FIR history of shape {h.shape} for "
                         f"{taps.shape[0]} taps")
    out = np.empty_like(x)
    lib.qpdsp_fir_state(_as_c(x), x.shape[0], _as_c(taps), taps.shape[0],
                        _as_c(h), _as_c(out))
    return out, h


def fir(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Causal FIR: lfilter(taps, 1, x) in float64."""
    return fir_state(x, taps, np.zeros(len(taps) - 1))[0]
