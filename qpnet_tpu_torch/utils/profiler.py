"""The port's tracing: spans and counters recorded inside the program, and a
torch.profiler trace that shows them beside the card's kernels.

  * `span(name, rid=None, parent=None, **attrs)` times a block (a context
    manager); `begin(...)` / `end(...)` time a span that starts on one
    thread and ends on another.  A span's parent is `parent` where given
    (an open span), else the innermost `span` block open on its thread
    when it began; the spans of one request share a `rid` (`new_rid()`),
    whatever thread records them;
  * `count(name, n=1)` adds to a process-wide counter;
  * `spans()` and `counters()` read them; `clear()` and `reset_counters()`
    empty them;
  * `trace(logdir)` records a torch.profiler trace of a block (host ops
    and, on a card, its CUDA kernels) and writes it, with the spans recorded
    in the block, as a Chrome trace.

Spans are always recorded, into a ring of the last `RING` records; each
record dropped from it adds to the counter `trace.dropped`.  The clock is
`time.perf_counter_ns()` (CLOCK_MONOTONIC on Linux, which
`time.monotonic()` reads too).  A reader that knows `perf_counter()` at a
profiler's start places a span on that trace's time axis at
`t0_ns / 1e9 - perf_at_start` seconds from the start.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time

RING = 65536

# one finished span: times in perf_counter_ns; thread, the native id of the
# thread that ended it
Span = collections.namedtuple(
    "Span", "name t0_ns t1_ns span_id parent_id rid thread attrs")

_lock = threading.Lock()
_ring: "collections.deque[tuple]" = collections.deque()  # Span's fields
_counters: dict = {}
_ids = itertools.count(1)
_local = threading.local()


def _thread() -> threading.local:
    """This thread's open blocks (`stack`) and native id (`tid`, read once:
    it is a system call)."""
    if not hasattr(_local, "stack"):
        _local.stack = []
        _local.tid = threading.get_native_id()
    return _local


class Open:
    """A span begun and not yet ended.  As a context manager it is the
    parent of the spans its thread begins inside the block."""

    __slots__ = ("name", "t0_ns", "span_id", "parent_id", "rid", "attrs",
                 "done")

    def __init__(self, name: str, rid, attrs: dict,
                 parent: "Open" = None):
        stack = _thread().stack
        self.name, self.rid, self.attrs = name, rid, attrs
        self.span_id = next(_ids)
        if parent is None and stack:
            parent = stack[-1]
        self.parent_id = None if parent is None else parent.span_id
        self.done = False
        self.t0_ns = time.perf_counter_ns()

    def __enter__(self) -> "Open":
        _local.stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _local.stack.pop()
        end(self)
        return False


def span(name: str, rid=None, parent: Open = None, **attrs) -> Open:
    """`with span(...) as s:` records the block; `s.attrs` may be filled
    in inside it."""
    return Open(name, rid, attrs, parent)


def begin(name: str, rid=None, parent: Open = None, **attrs) -> Open:
    """Start a span that `end` records, on this thread or another."""
    return Open(name, rid, attrs, parent)


def end(s: Open, **attrs) -> None:
    """Record `s` as ending now, with `attrs` added; once only."""
    t1 = time.perf_counter_ns()
    if s.done:
        return
    s.done = True
    s.attrs.update(attrs)
    rec = (s.name, s.t0_ns, t1, s.span_id, s.parent_id, s.rid,
           _thread().tid, s.attrs)
    with _lock:
        if len(_ring) >= RING:
            _ring.popleft()
            _counters["trace.dropped"] = _counters.get("trace.dropped",
                                                       0) + 1
        _ring.append(rec)


def new_rid() -> int:
    """An id for the spans of one request."""
    return next(_ids)


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def spans() -> list:
    """The ring's spans, in the order they ended."""
    with _lock:
        recorded = list(_ring)
    return [Span(*r) for r in recorded]


def counters() -> dict:
    with _lock:
        return dict(_counters)


def reset_counters(prefix: str = "") -> None:
    """Zero the counters whose names start with `prefix`."""
    with _lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]


def clear() -> None:
    """Drop every span and counter."""
    with _lock:
        _ring.clear()
        _counters.clear()


def _chrome_events(recorded, perf0_ns: int, wall0_ns: int, base_ns: int,
                   pid: int) -> list:
    """Spans as Chrome trace `X` events on a trace whose times are
    microseconds from `base_ns` (wall clock ns), given the perf_counter and
    the wall clock read together (`perf0_ns`, `wall0_ns`)."""
    off = wall0_ns - perf0_ns - base_ns
    return [{"ph": "X", "cat": "qpnet_span", "name": s.name, "pid": pid,
             "tid": s.thread, "ts": (s.t0_ns + off) / 1e3,
             "dur": (s.t1_ns - s.t0_ns) / 1e3,
             "args": {"span_id": s.span_id, "parent_id": s.parent_id,
                      "rid": s.rid, **{k: v if isinstance(
                          v, (int, float, str, bool, type(None))) else str(v)
                          for k, v in s.attrs.items()}}}
            for s in recorded]


@contextlib.contextmanager
def trace(logdir: str, with_python: bool = False):
    """Record a torch.profiler trace of the block into
    `logdir/trace-<pid>-<ns>.json`, with the spans that began in the block
    on the trace's own time base; yields the profiler.  The profiler starts
    and stops with the card idle: switched while kernels or graphs run, it
    can hang the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, with_stack=with_python) as prof:
        perf0, wall0 = time.perf_counter_ns(), time.time_ns()
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc.setdefault("traceEvents", []).extend(_chrome_events(
        [s for s in spans() if s.t0_ns >= perf0], perf0, wall0,
        doc.get("baseTimeNanoseconds", 0), os.getpid()))
    with open(path, "w") as f:
        json.dump(doc, f)
    logging.info("profiler trace written to %s", path)
