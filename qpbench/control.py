"""Readings that set a cell's limits: the program's compared numbers over
seeds, the control's (the reference at the precision below the
configuration's), and the planted faults', in one process on the card.

    python -m qpbench.control --workload <cell> --seeds <n> [<n> ...] \
        --seconds <s> [--fault state_unchanged|drop_half|alter_tokens]

Prints one JSON line a seed: the checks' values, the control's readings
put through the same checks in the program's place (`control_correct`,
which has to be false), and the fault's name.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

from qpbench import faults, harness
from qpbench.run import _caches


def readings(name, seed, seconds, device, fault=None, **kw):
    bench = harness.benchmark(kw.get("root", harness.ROOT))
    w, _ = harness.cell(bench, name)
    tr = harness.traffic(kw.get("root", harness.ROOT), w["traffic"])
    tr.update(kw.get("traffic_override") or {})
    cfg = dict(kw.get("cfg_override") or {})
    plant = contextlib.nullcontext()
    if fault:
        base = harness.load_json(
            kw.get("root", harness.ROOT)
            / next(c["file"] for c in bench["configs"]
                   if c["name"] == w["config"]))
        plant = faults.plant(tr["runner"], fault, {**base, **cfg},
                             kw.pop("chunk_frames", None))
    kw.pop("chunk_frames", None)
    with plant:
        run = harness.run_cell(name, seed, seconds, False, device,
                               control=fault is None, **kw)
    out = {"workload": name, "seed": seed, "fault": fault,
           "correct": run.correct, "failed": run.failed,
           "checks": {k: c.value for k, c in run.checks.items()}}
    for k in ("control_logit_gap", "control"):
        if k in run.counts:
            out[k] = run.counts[k]
    ctl = control_run(run)
    if ctl is not None:
        out["control_correct"] = ctl.correct
    return out, run


def control_run(run):
    """The run with the control's readings in the program's place: each
    check the control reads holds the control's number against the same
    limit.  None where the control was not read."""
    if "control_logit_gap" in run.counts:
        values = {"greedy_logit_gap": run.counts["control_logit_gap"]}
    elif "control" in run.counts:
        values = run.counts["control"]
    else:
        return None
    return dataclasses.replace(run, checks={
        k: harness.Check(v, run.checks[k].limit) for k, v in values.items()})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default=None)
    a = p.parse_args(argv)
    _caches(str(harness.ROOT))
    import torch
    if not torch.cuda.is_available():
        print("qpbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in a.seeds:
        out, _ = readings(a.workload, seed, a.seconds, torch.device("cuda"),
                          a.fault)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
