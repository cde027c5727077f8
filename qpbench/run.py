"""Run one cell of the port's benchmark once and print its result line.

    python -m qpbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Needs as many CUDA devices as the cell asks
for; exits non-zero without a result otherwise, when the program is
missing, or when JAX or the JAX package was loaded.  The last line of
standard output is one JSON object: correct, attempted, failed, metrics
(end-to-end with --trace 0, per-layer with --trace 1), device, with
--trace 1 breakdown, and last the checks that decided `correct`, each
value beside its limit (also the last lines of standard error).
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _caches(root) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(root, "build")
    os.environ["QPNET_KERNEL_CACHE"] = os.path.join(build, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(build, "inductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from qpbench import harness
    _caches(str(harness.ROOT))
    bench = harness.benchmark()
    w, _ = harness.cell(bench, a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print(f"qpbench: cell {a.workload} needs {w['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           torch.device("cuda"), t_start=T_START)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"qpbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    traced = bool(a.trace)
    line = harness.result_line(
        run, harness.read_metrics(harness.ROOT, bench, a.workload, run,
                                  traced),
        harness.device_info(run, traced, int(w["chips"])), traced)
    print(line, flush=True)
    print(harness.info_line(run), file=sys.stderr)
    print(harness.check_lines(run), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
