"""The program's own spans (`qpnet_tpu_torch.utils.profiler`), read after a
run by the per-layer metrics that time the program's layers from inside.

Spans carry `time.perf_counter_ns()` times; a traced stretch stores
`perf_counter()` at the profiler's start (`trace.Stretch.perf_at_start`),
so a span lies at `t0_ns / 1e9 - perf_at_start` seconds on the stretch's
axis.  A program that records no spans gives None here, and each metric
that reads them then finds nothing.
"""

from __future__ import annotations


def recorded():
    """The program's spans, or None where it records none."""
    try:
        from qpnet_tpu_torch.utils import profiler
        return profiler.spans()
    except (ImportError, AttributeError):
        return None


def ms(s) -> float:
    return (s.t1_ns - s.t0_ns) / 1e6


def named(spans, name: str):
    return [s for s in spans if s.name == name]


def children(spans, parent, name: str):
    return [s for s in spans
            if s.parent_id == parent.span_id and s.name == name]


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def serve_window(spans, run):
    """The serve window on the program's clock, [a, b) ns, or None.  The
    load sends each client's first stream one reply delay after the
    window's start, on the traffic's fixed schedule (`corpus.schedule`), so
    the window starts the shortest of those delays before the earliest
    serve.queue start (prewarm submits nothing); the connection and the
    read of the features before `submit` leave it about a millisecond
    late."""
    starts = [s.t0_ns for s in named(spans, "serve.queue")]
    tr = run.traffic
    if not starts or run.window_s <= 0 or "reply_delay_s" not in tr:
        return None
    from qpbench import corpus
    lead = min(corpus.schedule(run.cfg, tr, c, 0)[1]
               for c in range(tr["clients"]))
    a = min(starts) - lead * 1e9
    return a, a + run.window_s * 1e9


def window_requests(spans, w):
    """The serve.queue spans of the requests submitted in the window and
    taken into a group."""
    return [s for s in named(spans, "serve.queue")
            if w[0] <= s.t0_ns < w[1] and "group" in s.attrs]


def stretch(run):
    """The traced stretch on the program's clock, [a, b] ns, or None."""
    tr = run.trace
    if tr is None or getattr(tr, "perf_at_start", None) is None:
        return None
    a = tr.perf_at_start * 1e9
    return a, a + tr.window_s * 1e9


def stretch_call(spans, run):
    """The decode.call that began inside the traced stretch (one whole
    call), or None."""
    st = stretch(run)
    if st is None:
        return None
    calls = [s for s in named(spans, "decode.call")
             if st[0] <= s.t0_ns <= st[1]]
    return calls[0] if len(calls) == 1 else None


def window_calls(spans, run):
    """The window's decode.call spans outside the traced stretch: the
    runner's warm-up makes one call a mode before the window."""
    warm = len(set(run.traffic.get("modes", ())))
    calls = sorted(named(spans, "decode.call"), key=lambda s: s.t0_ns)
    st = stretch(run)
    return [s for s in calls[warm:]
            if st is None or s.t1_ns <= st[0] or s.t0_ns >= st[1]]


def train_steps(spans, run):
    """The window's train.step spans: iteration in [setup_steps,
    setup_steps + train_steps), less those overlapping the stretch."""
    n = run.counts.get("train_steps")
    first = run.traffic.get("setup_steps")
    if not n or first is None:
        return []
    st = stretch(run)
    return [s for s in named(spans, "train.step")
            if first <= s.attrs.get("iteration", -1) < first + n
            and (st is None or s.t1_ns <= st[0] or s.t0_ns >= st[1])]
