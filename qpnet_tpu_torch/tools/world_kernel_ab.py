"""W1-W3 of `csrc/world_kernel.cu` against other versions of that source,
timed on one card in one call.

Two designs of a kernel are compared only within one call, on one card:
its power limit and its host differ from call to call.  This tool builds
the checkout's `world_kernel.cu` and each source given with --other (the
same plain C entry points, e.g. an earlier commit's file written out with
`git show <commit>:qpnet_tpu_torch/csrc/world_kernel.cu`), records the
inputs that W1 (pooling) and W2 (the Viterbi) get in a device harvest pass
and W3 (DIO's contour walks) in a device DIO pass over chip_smoke.py phase
15's synthetic utterances (`dsp/world/gates.py::voiced_utterance`, seed
15, `world_kernel_cases.PASS_SECONDS`, 40-400 Hz, 5 ms), and gives W3
also the inputs that phase holds past W3's shared memory
(`world_kernel_cases.FIX_CONTOUR_LONG`).  Every version launches through
the wrappers of `ops/world_kernel.py` (`world_kernel.launching`).  It
holds every version's output to the plain version bit for bit, and prints
each version's device ms per call (`world_kernel_cases.device_ms`, as
phase 15 times them), taken in turns: this, the others, the others again,
this.  It exits 1 if any version differs from the plain version.

usage: python -m qpnet_tpu_torch.tools.world_kernel_ab --other A.cu
         [--other B.cu ...] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

FS = 22050
NAMES = ("pool", "viterbi", "fix_contour")


def pass_inputs(dev):
    """{(kernel, seconds): wrapper arguments}, contiguous, recorded from a
    device harvest and a device DIO pass over each utterance of
    PASS_SECONDS."""
    from qpnet_tpu_torch.dsp.world import device_f0 as DF
    from qpnet_tpu_torch.dsp.world import gates
    from qpnet_tpu_torch.ops import world_kernel_cases as CASES
    rng = np.random.default_rng(15)
    found = {}
    for secs in CASES.PASS_SECONDS:
        x = gates.voiced_utterance(rng, secs, FS)
        kw = dict(n_valid=len(x), f0_floor=40.0, f0_ceil=400.0,
                  frame_period=5.0, device=dev)
        with CASES.recording() as calls:
            DF.device_harvest(x, FS, **kw)
            DF.device_dio(x, FS, **kw)
        for name, args in calls:
            if name in NAMES:
                found[(name, secs)] = tuple(
                    a.contiguous() if torch.is_tensor(a) else a
                    for a in args)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", required=True,
                    help="another world_kernel.cu to build and time")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("world_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from qpnet_tpu_torch.bench import card
    from qpnet_tpu_torch.ops import world_kernel as WK
    from qpnet_tpu_torch.ops import world_kernel_cases as CASES
    dev = torch.device("cuda")
    libs = {"this": WK.load()}
    for i, path in enumerate(args.other):
        libs[Path(path).name] = WK.load(Path(path).read_bytes(),
                                        f"world_kernel_ab_{i}")
    inputs = pass_inputs(dev)
    for seed, F, C in CASES.FIX_CONTOUR_LONG:
        inputs[("fix_contour", f"{F}x{C} edge")] = tuple(
            torch.from_numpy(a).to(dev)
            for a in CASES.fix_contour_edge_inputs(seed, F, C)) + (
                CASES.ALLOWED_RANGE,)
    order = list(libs) + list(libs)[1:] + ["this"]
    rows, bad = [], 0
    for (name, what), a in sorted(inputs.items(), key=str):
        want = getattr(WK, name + "_reference")(*a)
        kernel = getattr(WK, name)
        row = {"kernel": name, "input": what,
               "shape": [list(t.shape) for t in a if torch.is_tensor(t)]}
        for lab, lib in libs.items():
            with WK.launching(lib):
                got = kernel(*a)
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            row[f"{lab} bit-equal"] = same
            bad += not same
        for lab in order:
            with WK.launching(libs[lab]):
                ms = CASES.device_ms(lambda: kernel(*a))
            row.setdefault(f"{lab} ms", []).append(ms)
        rows.append(row)
        print(f"{name} {what} {row['shape']}: " + "; ".join(
            f"{lab} " + " / ".join(f"{v:.4f}" for v in row[f"{lab} ms"])
            + ("" if row[f"{lab} bit-equal"] else " (DIFFERS)")
            for lab in libs) + f" ms | {card()}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card(), "rows": rows}, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
