"""Device trace of a stretch of the measured window, from torch.profiler.

A stretch runs the profiler (host and card activity) over a part of the
window, started and stopped on the thread that launches the work, while
the card is idle and no other thread launches: around one whole decode
call; between training steps; in the serve cell while the service's
scheduler is held between two feeds (`runners/serve.py::paused`).
torch.profiler synchronizes the card when it stops, and a start or stop
while K1's CUDA graphs ran or another thread launched hung runs on the
card.  The card's activity is traced process-wide.  The stretch's ends are
the wall clock at the profiler's start and stop (or where the caller says),
placed on the trace's own time base (its `baseTimeNanoseconds`).  The
trace is written and read after the window has closed.  The harness's own
phases (`Phases`) name what the host was doing in each idle gap, beside
the CUDA runtime call open during it.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime",)


class Phases:
    """What the harness's host thread is doing: (perf_counter s, name)."""

    def __init__(self):
        self.marks = [(time.perf_counter(), "setup")]

    def __call__(self, name: str) -> None:
        self.marks.append((time.perf_counter(), name))

    def at(self, t: float) -> str:
        name = self.marks[0][1]
        for when, what in self.marks:
            if when > t:
                break
            name = what
        return name


def short_name(name: str) -> str:
    """A kernel's name without return type, arguments and namespaces."""
    k = name.replace("(anonymous namespace)::", "").replace(
        "__nv_bfloat16", "bf16")
    if k.startswith("void "):
        k = k[5:]
    return k.split("(")[0].strip() or "(unnamed)"


def _activities():
    """Host and card activity; the host's alone on a machine without a
    card (the CPU tests), which gives no device events."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class Stretch:
    """torch.profiler from `open()` to `close()`, on one thread."""

    def __init__(self):
        self._ctx = self._prof = None
        self.ns = []
        self.perf_at_start = None

    def open(self) -> None:
        from torch.profiler import profile
        self._ctx = profile(activities=_activities())
        self._prof = self._ctx.__enter__()
        self.perf_at_start = time.perf_counter()
        self.ns = [time.time_ns()]

    def close(self, end_ns: int = None) -> None:
        """Stop; the stretch ends at end_ns (time.time_ns()), or now."""
        self.ns.append(end_ns or time.time_ns())
        self._ctx.__exit__(None, None, None)

    @property
    def closed(self) -> bool:
        return len(self.ns) == 2

    def read(self, phases: Phases = None) -> "Trace":
        """The stretch's events (after the window): a Trace, or None."""
        if self._prof is None or not self.closed:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self._prof = None
        base = trace.get("baseTimeNanoseconds", 0)
        return Trace(trace.get("traceEvents", []),
                     [(t - base) / 1e3 for t in self.ns],
                     self.perf_at_start, phases)


def _union(spans):
    """Merged [(a, b)] of sorted spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one stretch, times in seconds from its start."""

    def __init__(self, events, ends_us, perf_at_start, phases=None):
        """ends_us: the stretch's start and stop on the events' time base
        (microseconds)."""
        t0, t1 = ends_us
        self.window_s = (t1 - t0) / 1e6
        self.device, self.runtime = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = (float(e["ts"]) - t0) / 1e6
            b = a + float(e["dur"]) / 1e6
            a, b = max(a, 0.0), min(b, self.window_s)
            if b <= a:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((e.get("name", ""), a, b))
            elif cat in RUNTIME_CATS:
                self.runtime.append((e.get("name", ""), a, b))
        self.busy = _union((a, b) for _, a, b in self.device)
        self.busy_s = sum(b - a for a, b in self.busy)
        self.perf_at_start = perf_at_start
        self.phases = phases

    def named(self, pred):
        """Device events whose name satisfies pred: [(name, a, b)]."""
        return [ev for ev in self.device if pred(ev[0])]

    @staticmethod
    def busy_of(events) -> float:
        return sum(b - a for a, b in _union((a, b) for _, a, b in events))

    def idle_share(self):
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def gaps(self):
        """[(seconds, start)] of the stretch's idle gaps."""
        edges = [0.0] + [x for ab in self.busy for x in ab] + [self.window_s]
        return [(b - a, a) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def label(self, a: float, b: float) -> str:
        """The harness's phase and the longest CUDA runtime call open over
        [a, b]."""
        best, api = 0.0, "no CUDA call"
        for name, x, y in self.runtime:
            o = min(b, y) - max(a, x)
            if o > best:
                best, api = o, name
        phase = "?"
        if self.phases is not None and self.perf_at_start is not None:
            phase = self.phases.at(self.perf_at_start + (a + b) / 2)
        return f"{phase}: {api}"

    def breakdown(self, top: int = 10) -> dict:
        by = {}
        for name, a, b in self.device:
            k = short_name(name)
            by[k] = by.get(k, 0.0) + (b - a)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), reverse=True)[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.label(a, a + s), s] for s, a in gaps]}
