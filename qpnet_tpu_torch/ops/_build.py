"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on first use into
`<build dir>/lib<name>-<hash>.so`, a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds).  The build directory is
`$QPNET_KERNEL_CACHE` when that is set, else `<checkout>/build/kernels`.
The hash covers the source, the flags and `nvcc --version`, so an edited
source or another toolkit rebuilds and an unchanged pair loads from the
earlier build.  Since the toolkit's version is part of the key, loading a
library, even one built before, needs nvcc.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_loaded = {}
_nvcc_versions = {}


def build_dir() -> Path:
    """$QPNET_KERNEL_CACHE, or build/kernels in the checkout."""
    return Path(os.environ.get("QPNET_KERNEL_CACHE") or DEFAULT_BUILD_DIR)


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.access(path, os.X_OK):
            return path
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "only where the CUDA toolkit is installed")
    return nvcc


def nvcc_version(nvcc: str) -> str:
    """`nvcc --version`'s output, read once per nvcc per process."""
    if nvcc not in _nvcc_versions:
        _nvcc_versions[nvcc] = subprocess.run(
            [nvcc, "--version"], capture_output=True, text=True,
            check=True).stdout
    return _nvcc_versions[nvcc]


def library_path(lib: str, src: bytes) -> Path:
    """The library `lib` of the CUDA source `src` for these flags and this
    toolkit."""
    key = src + " ".join(NVCC_FLAGS).encode() + nvcc_version(find_nvcc()).encode()
    return build_dir() / f"lib{lib}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build_source(lib: str, src: bytes, verbose: bool = False) -> Path:
    """Compile the CUDA source `src` into the library `lib` unless it is
    already built; returns the library's path.  verbose=True also prints
    ptxas's register and spill report."""
    out = library_path(lib, src)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        cu, so = os.path.join(tmp, f"{lib}.cu"), os.path.join(tmp, "lib.so")
        with open(cu, "wb") as f:
            f.write(src)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", so, cu]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {lib}.cu:\n{res.stderr}")
        if verbose:
            print(res.stderr, end="")
        os.replace(so, out)
    return out


def build(name: str, verbose: bool = False) -> Path:
    """Build csrc/<name>.cu (see build_source)."""
    return build_source(name, (CSRC / f"{name}.cu").read_bytes(), verbose)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
