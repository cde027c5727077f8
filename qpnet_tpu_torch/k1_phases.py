"""Where a K1 step's time goes on the card, below the profiler's view.

    python -m qpnet_tpu_torch.k1_phases [--network Rd10Rr3Ed4Er1]
                                        [--quantize w8a8] [--batch 7]

Under programmatic dependent launch every kernel of a step starts while the
one before it runs and waits for it on the card, so torch.profiler's kernel
times overlap and do not say where a step's time goes.  This builds two
variants of csrc/gen_kernel.cu beside the shipped one (into build/kernels/;
the port never loads them):
  empty   the product kernels return right after their grid-dependency
          wait: the cost of the chain of 2L+4 dependent kernels per step
          with no work in them;
  phases  the shipped kernel, with thread 0 of the first and the last block
          of one gate and one out launch (layer 5, step 3) stamping
          %globaltimer at each phase.
It prints the us/step of the shipped kernel and of `empty` (2 frames,
sampling, CUDA events), then each block's phase times in us from its
start.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import subprocess

import torch

from qpnet_tpu_torch import bench
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models.qpnet import init_params
from qpnet_tpu_torch.ops import _build
from qpnet_tpu_torch.ops import gen_kernel as K

PHASES = ["start", "issued", "waited", "weights", "rows", "quantized",
          "products", "reduced", "barrier", "epilogue"]
_MARK = """
__device__ unsigned long long g_phase[2][2][16];
__device__ __forceinline__ void mark(int P, int l, int step, int i) {
  if (P < 2 && l == 5 && step == 3 && threadIdx.x == 0
      && (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1)) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    g_phase[P][blockIdx.x == 0 ? 0 : 1][i] = t;
  }
}
"""
# (text in prod_kernel, phase index, mark before or after it)
_AT = [
    ("  const Ctx& cx = *ctx;\n  const int t = cx.frame * up + step;\n"
     "  const int t_abs = t + cx.step_offset;\n  const unsigned char* wbase;",
     0, "before"),
    ("  grid_wait();\n  grid_release();\n  if (P == kGate && adaptive)", 1,
     "before"),
    ("  const int g = lane >> 2, qd = lane & 3;", 2, "before"),
    ("    // products: warp w takes", 5, "before"),
    ("#pragma unroll\n    for (int nt = 0; nt < kMaxBT / 8; ++nt) {\n"
     "      if (nt < nbt) {\n        const int n = nt * 8 + qd * 2;", 6,
     "before"),
    ("    cl.sync();\n    if (rank == 0) {", 7, "before"),
    ("    if (rank == 0) {  // ranks in order", 8, "before"),
    ("    if (b0 + BT < B) cl.sync();", 9, "before"),
]


def _variant(name: str, src: str) -> ctypes.CDLL:
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libgen_kernel_{name}-{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = out.with_suffix(".cu")
        cu.write_text(src)
        res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(out), str(cu)], capture_output=True,
                             text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n"
                               f"{res.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.qp_generate.argtypes = K._ARGTYPES
    lib.qp_generate.restype = ctypes.c_int
    return lib


def variants() -> dict:
    src = (_build.CSRC / "gen_kernel.cu").read_text()
    body = "  const int g = lane >> 2, qd = lane & 3;"
    assert src.count(body) == 1
    empty = src.replace(body, "  if (B > 0) return;\n" + body)
    phases = src.replace("// Partial sums: f32", _MARK + "// Partial sums: f32")
    for text, i, where in _AT:
        assert phases.count(text) == 1, text
        m = f"  mark(P, l, step, {i});\n"
        phases = phases.replace(text, m + text if where == "before"
                                else text + m)
    # the weights are the first cp.async group, the rows the second
    wait = ("    cp_async_commit();\n    cp_async_wait_all();\n"
            "    __syncthreads();\n")
    assert phases.count(wait) == 1
    phases = phases.replace(wait, "    cp_async_commit();\n    asm volatile("
                            "\"cp.async.wait_group 1;\" ::: \"memory\");\n"
                            "    mark(P, l, step, 3);\n    cp_async_wait_all();\n"
                            "    __syncthreads();\n    mark(P, l, step, 4);\n")
    phases += ('\nextern "C" int qp_phases(unsigned long long* out) {\n'
               "  return (int)cudaMemcpyFromSymbol(out, g_phase, "
               "sizeof(g_phase));\n}\n")
    return {"empty": _variant("empty", empty),
            "phases": _variant("phases", phases)}


@contextlib.contextmanager
def _using(lib):
    """Route `gen_kernel.generate` through `lib` for the block's length."""
    saved = K._lib
    K._lib = lambda: lib
    try:
        yield
    finally:
        K._lib = saved


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--network", default="Rd10Rr3Ed4Er1",
                   choices=["default", "Rd10Rr3Ed4Er1"])
    p.add_argument("--quantize", default="none", choices=["none", "w8a8"])
    p.add_argument("--batch", type=int, default=7)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_phases: needs a CUDA device")
    cfg = ModelConfig.from_network_name(a.network)
    params = init_params(0, cfg, device="cuda")
    libs = variants()
    args, maxd = bench.kernel_inputs(params, cfg, a.batch, 2, seed=3,
                                     quantize=a.quantize)
    n = 2 * cfg.upsampling_factor
    kw = dict(B=a.batch, maxd=maxd, n_steps=n, mode="sampling",
              quantize=a.quantize)
    ms = {"shipped": bench.step_ms(args, kw)}
    with _using(libs["empty"]):
        ms["empty"] = bench.step_ms(args, kw)
    print(f"{a.network} {a.quantize} B={a.batch}: us/step " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in ms.items()) + f" | {bench.card()}")
    with _using(libs["phases"]):
        K.generate(*args, **kw)
        torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 64)()
    if libs["phases"].qp_phases(buf) != 0:
        raise RuntimeError("could not read the phase stamps")
    for P, name in enumerate(("gate", "out")):
        for blk, which in enumerate(("first", "last")):
            row = buf[(P * 2 + blk) * 16:(P * 2 + blk) * 16 + len(PHASES)]
            print(f"  {name} {which} block, us from its start: " + ", ".join(
                f"{ph} {(t - row[0]) / 1e3:.2f}"
                for ph, t in zip(PHASES, row) if t))


if __name__ == "__main__":
    main()
