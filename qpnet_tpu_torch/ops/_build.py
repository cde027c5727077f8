"""Build the port's native sources and load them with ctypes.

Each CUDA source `csrc/<name>.cu` compiles with nvcc on first use into
`<build dir>/lib<name>-<hash>.so`, a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds).  The host source
`csrc/<name>.cpp` (the DSP core) compiles the same way with the host C++
compiler (`$CXX`, else `c++` or `g++`), which is all it needs, so it builds
and loads where there is no CUDA toolkit.  The build directory is
`$QPNET_KERNEL_CACHE` when that is set, else `<checkout>/build/kernels`.
The hash covers the source, the flags and the compiler's `--version`, so an
edited source or another compiler rebuilds and an unchanged pair loads from
the earlier build.  Since the compiler's version is part of the key,
loading a library, even one built before, needs its compiler.  Nothing here
runs at import time.
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
# no -march=native: a library built on one host may be loaded on another
HOST_CXX_FLAGS = ("-std=c++17", "-O3", "-ffp-contract=off", "-shared",
                  "-fPIC")

_lock = threading.Lock()
_loaded = {}
_nvcc_versions = {}
_cxx_versions = {}


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


def _version(compiler: str, seen: dict) -> str:
    if compiler not in seen:
        seen[compiler] = subprocess.run(
            [compiler, "--version"], capture_output=True, text=True,
            check=True).stdout
    return seen[compiler]


def nvcc_version(nvcc: str) -> str:
    """`nvcc --version`'s output, read once per nvcc per process."""
    return _version(nvcc, _nvcc_versions)


def cxx_version(cxx: str) -> str:
    """`<host compiler> --version`'s output, read once per compiler per
    process."""
    return _version(cxx, _cxx_versions)


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else c++, else g++."""
    for cand in (os.environ.get("CXX", ""), "c++", "g++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no host C++ compiler ($CXX, c++ or g++) found: the "
                       "port's DSP core builds with one")


def library_path(lib: str, src: bytes) -> Path:
    """The library `lib` of the CUDA source `src` for these flags and this
    toolkit."""
    key = src + " ".join(NVCC_FLAGS).encode() + nvcc_version(find_nvcc()).encode()
    return build_dir() / f"lib{lib}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def host_library_path(lib: str, src: bytes) -> Path:
    """The library `lib` of the host C++ source `src` for these flags and
    this compiler."""
    key = (src + " ".join(HOST_CXX_FLAGS).encode()
           + cxx_version(find_cxx()).encode())
    return build_dir() / f"lib{lib}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _compile(out: Path, src: bytes, name: str, cmd, verbose: bool) -> Path:
    """Compile `src` (written as `name`) with `cmd(source, library)` into
    `out` unless it is already there; returns `out`."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        path, so = os.path.join(tmp, name), os.path.join(tmp, "lib.so")
        with open(path, "wb") as f:
            f.write(src)
        args = cmd(path, so)
        res = subprocess.run(args, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(args[0])} failed on "
                               f"{name}:\n{res.stderr}")
        if verbose:
            print(res.stderr, end="")
        os.replace(so, out)
    return out


def build_source(lib: str, src: bytes, verbose: bool = False) -> Path:
    """Compile the CUDA source `src` into the library `lib` unless it is
    already built; returns the library's path.  verbose=True also prints
    ptxas's register and spill report."""
    return _compile(
        library_path(lib, src), src, f"{lib}.cu",
        lambda cu, so: [find_nvcc(), *(["-Xptxas=-v"] if verbose else []),
                        *NVCC_FLAGS, "-o", so, cu], verbose)


def build_host_source(lib: str, src: bytes) -> Path:
    """Compile the host C++ source `src` into the library `lib` unless it
    is already built; returns the library's path."""
    return _compile(
        host_library_path(lib, src), src, f"{lib}.cpp",
        lambda cpp, so: [find_cxx(), *HOST_CXX_FLAGS, "-o", so, cpp], False)


def build(name: str, verbose: bool = False) -> Path:
    """Build csrc/<name>.cu (see build_source)."""
    return build_source(name, (CSRC / f"{name}.cu").read_bytes(), verbose)


def build_host(name: str) -> Path:
    """Build csrc/<name>.cpp with the host compiler (see
    build_host_source)."""
    return build_host_source(name, (CSRC / f"{name}.cpp").read_bytes())


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, or csrc/<name>.cpp with
    the host compiler where there is no .cu, once per process."""
    with _lock:
        if name not in _loaded:
            lib = (build(name) if (CSRC / f"{name}.cu").exists()
                   else build_host(name))
            _loaded[name] = ctypes.CDLL(str(lib))
        return _loaded[name]
