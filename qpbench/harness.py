"""The benchmark's data-driven core.

A cell of BENCHMARK.json names a configuration and a traffic mix.  The
configuration's file (its `file` in BENCHMARK.json) holds the model's
sizes; the traffic mix is `qpbench/traffic/<traffic>.json`, whose
`runner` names the general runner that reads it
(`qpbench/runners/<runner>.py`, `run(ctx) -> Run`); each metric of the cell
is read from the finished run by `qpbench/metrics/<metric name>.py`
(`read(run)`, None where it finds nothing to read).  A later cell,
configuration, mix or metric is a new file and a new entry: nothing here
names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

ROOT = Path(__file__).resolve().parent.parent

# top-level module names that may not be loaded in a run: JAX, and the JAX
# package the port was made from (compared whole: the port's own name
# begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "qpnet_tpu")


@dataclass
class Check:
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Run:
    """What a runner hands back: the window, its counts, and the checks."""
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    counts: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    trace: Any = None
    cfg: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c.ok for c in self.checks.values())


@dataclass
class Context:
    """What a runner is given."""
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    phase: Any = None
    control: bool = False    # also read the control (qpbench.control)


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str):
    """(workload, configuration entry) of the cell `name`."""
    for w in bench["workloads"]:
        if w["name"] == name:
            for c in bench["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise KeyError(f"cell {name}: no configuration {w['config']}")
    raise KeyError(f"no cell named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic(root: Path, name: str) -> dict:
    return load_json(root / "qpbench" / "traffic" / f"{name}.json")


def runner(name: str):
    return importlib.import_module(f"qpbench.runners.{name}")


def metrics_of(bench: dict, name: str, traced: bool):
    """The cell's metric entries: end-to-end without a trace, per-layer
    with one."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(root: Path, metric: str):
    """`read` of qpbench/metrics/<metric>.py."""
    path = root / "qpbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "qpbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def read_metrics(root: Path, bench: dict, name: str, run: Run,
                 traced: bool) -> dict:
    out = {}
    for m in metrics_of(bench, name, traced):
        v = reader(root, m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_info(run: Run, traced: bool, chips: int) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if traced and run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def result_line(run: Run, metrics: dict, device: dict,
                traced: bool) -> str:
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if traced and run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": c.value, "limit": c.limit}
                     for k, c in run.checks.items()}
    return json.dumps(out)


def info_line(run: Run) -> str:
    """The run's scalar counts and window, for the log."""
    counts = {k: v for k, v in run.counts.items()
              if isinstance(v, (int, float, str))}
    return "info " + json.dumps({"window_s": run.window_s,
                                 "setup_s": run.setup_s, **counts})


def check_lines(run: Run) -> str:
    return "\n".join(f"check {k}: {c.value!r} limit {c.limit!r} "
                     f"{'ok' if c.ok else 'FAILED'}"
                     for k, c in run.checks.items())


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT, t_start: Optional[float] = None,
             control: bool = False, cfg_override=None,
             traffic_override=None) -> Run:
    """One run of the cell on `device` (the CLI passes the card; tests a
    CPU device and a small configuration)."""
    from qpbench.trace import Phases
    bench = benchmark(root)
    w, c = cell(bench, name)
    cfg = load_json(root / c["file"])
    cfg.update(cfg_override or {})
    tr = traffic(root, w["traffic"])
    tr.update(traffic_override or {})
    ctx = Context(cfg=cfg, traffic=tr, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=device,
                  t_start=time.monotonic() if t_start is None else t_start,
                  phase=Phases(), control=control)
    run = runner(tr["runner"]).run(ctx)
    run.cfg, run.traffic = cfg, tr
    return run
