"""Profiling and step-timing hooks, ported from `qpnet_tpu/utils/profiler.py`:

  * `trace(logdir)` records a `torch.profiler` trace (host ops and, on a
    card, its CUDA kernels) and writes it to `logdir` as a Chrome trace;
  * `annotate(name)` names a span of that trace;
  * `StepTimer` keeps rolling host-side per-step times with an ETA;
  * `device_memory_stats()` snapshots each CUDA device's memory.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, with_python: bool = False):
    """Record a torch.profiler trace of the block into
    `logdir/trace-<pid>-<ns>.json`; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, with_stack=with_python) as prof:
        yield prof
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logging.info("profiler trace written to %s", path)


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling per-step timing with ETA, reported every `interval` steps."""

    def __init__(self, total_steps: int, interval: int = 100,
                 name: str = "train"):
        self.total = total_steps
        self.interval = interval
        self.name = name
        self._t0: Optional[float] = None
        self._acc = 0.0
        self._count = 0
        self.history = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._acc += time.perf_counter() - self._t0
        self._count += 1
        if self._count % self.interval == 0:
            sec = self._acc / self.interval
            eta = int((self.total - self._count) * sec)
            logging.info("[%s] step %d/%d: %.3f sec/step, ETA "
                         "%02d:%02d:%02d", self.name, self._count,
                         self.total, sec,
                         eta // 3600, (eta % 3600) // 60, eta % 60)
            self.history.append(sec)
            self._acc = 0.0
        return False


def device_memory_stats() -> dict:
    """Per-device memory snapshot in bytes, with the JAX package's keys:
    {"cuda:<i>": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}}
    from PyTorch's caching allocator (tensors allocated, and their peak
    since the last `torch.cuda.reset_peak_memory_stats`) and the device's
    total memory.  A host without CUDA has no device memory to report:
    {"cpu": {}}."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory),
        }
    return out
