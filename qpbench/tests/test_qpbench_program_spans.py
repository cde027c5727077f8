"""The per-layer metrics that read the program's own spans
(`qpbench/program_spans.py`): each on a hand-made run and span list, with a
hand-made device trace where it reads one, to its exact value; None where
the spans are missing or the program records none; and on tiny CPU runs of
the cells, where the program records them."""

import pytest

from qpbench import harness
from qpbench import program_spans as P
from qpbench.harness import Run
from qpbench.tests import tiny
from qpbench.trace import Trace
from qpnet_tpu_torch.utils import profiler

SERVE = ("serve.queue_wait_p90_ms", "serve.first_feed_ms",
         "serve.scheduler_idle", "serve.gather_ms", "serve.first_write_ms",
         "serve.group_size")
DECODE = ("decode.prep_ms", "decode.idle_in_prep")
TRAIN = ("train.host_ms", "train.batch_window_ms")
NS = 1_000_000_000


def read(name, run):
    return harness.reader(harness.ROOT, name)(run)


class Spans:
    """A span list built by hand: times in seconds on the program's
    clock."""

    def __init__(self):
        self.list = []

    def add(self, name, t0, t1, parent=None, rid=None, **attrs):
        s = profiler.Span(name, int(round(t0 * NS)), int(round(t1 * NS)),
                          len(self.list) + 1,
                          None if parent is None else parent.span_id, rid,
                          1, attrs)
        self.list.append(s)
        return s


@pytest.fixture
def given(monkeypatch):
    def use(spans):
        monkeypatch.setattr(P, "recorded", lambda: spans)
    return use


def serve_run(window_s=45.0):
    """A run whose load sends every client's first stream 0.5 s after the
    window's start."""
    return Run(window_s=window_s, cfg={"upsampling_factor": 10},
               traffic={"clients": 3, "seconds": [0.5, 1.0],
                        "reply_delay_s": [0.5, 0.5], "schedule_seed": 1})


def serve_spans():
    sp = Spans()
    # the window: 45 s from 0.5 s, the first queue start less 0.5 s
    for rid, (t0, wait, group) in enumerate(
            [(1.0, 0.1, 0), (2.0, 0.2, 1), (3.0, 0.3, 1), (50.0, 0.4, 3)]):
        sp.add("serve.queue", t0, t0 + wait, rid=rid, group=group)
        sp.add("serve.write", t0 + 5.0, t0 + 5.0 + 0.002 * (rid + 1),
               rid=rid, first=True)
        sp.add("serve.write", t0 + 6.0, t0 + 6.5, rid=rid, first=False)
    sp.add("serve.queue", 4.0, 9.0, rid=9, cancelled=True)
    for t0, t1, streams, first, group in [(1.2, 3.2, 1, 0.5, 0),
                                          (3.5, 10.0, 3, 1.0, 1),
                                          (40.0, 47.0, 2, 2.0, 2)]:
        g = sp.add("serve.group", t0, t1, group=group, streams=streams,
                   bucket=4, built=False)
        sp.add("serve.feed", t0 + 0.01, t0 + 0.01 + first, g, index=0,
               frames=50)
        sp.add("serve.feed", t0 + 0.02 + first, t0 + 0.03 + first, g,
               index=1, frames=50)
    for t0, dur, streams in [(1.1, 0.05, 1), (3.3, 0.02, 3), (39.9, 0.03, 2),
                             (20.0, 0.5, 0), (46.0, 0.5, 1)]:
        sp.add("serve.gather", t0, t0 + dur, streams=streams)
    return sp.list


def test_serve_metrics_read_their_exact_values(given):
    given(serve_spans())
    run = serve_run()
    # waits 100, 200, 300 ms in the window (400 after it, the cancelled
    # one never queued to a group): nearest rank 3 of 3
    assert read("serve.queue_wait_p90_ms", run) == pytest.approx(300.0)
    # first feeds of the groups starting in [0.5, 45.5): 0.5, 1.0, 2.0 s
    assert read("serve.first_feed_ms", run) == pytest.approx(3500 / 3)
    # groups cover 2.0 + 6.5 + 5.5 s of 45
    assert read("serve.scheduler_idle", run) == pytest.approx(
        100 * (1 - 14.0 / 45))
    # gathers of a group starting in the window: 50, 20, 30 ms (none
    # dispatched at 20 s, one after the window)
    assert read("serve.gather_ms", run) == pytest.approx(100 / 3)
    # first writes of the window's three requests: 2, 4, 6 ms
    assert read("serve.first_write_ms", run) == pytest.approx(4.0)
    # the third group ends past the window
    assert read("serve.group_size", run) == pytest.approx(2.0)


def test_the_serve_window_opens_the_loads_first_delay_before_a_request():
    """On the cell's own schedule the first stream leaves 1.046875 s into
    the window: the shortest of 32 reply delays spread over [1, 4] s."""
    cfg = harness.load_json(harness.ROOT / "qpbench" / "configs" /
                            "qpnet_default.json")
    tr = harness.traffic(harness.ROOT, "serve_c32")
    sp = Spans()
    sp.add("serve.queue", 12.0, 13.0, group=0)
    sp.add("serve.queue", 11.5, 13.0, group=0)
    a, b = P.serve_window(sp.list, Run(window_s=45.0, cfg=cfg, traffic=tr))
    assert a == pytest.approx((11.5 - 1.046875) * NS)
    assert b - a == pytest.approx(45.0 * NS)


def test_scheduler_idle_counts_overlapping_groups_once(given):
    sp = Spans()
    sp.add("serve.queue", 0.0, 0.1, group=0)
    sp.add("serve.group", 1.0, 3.0, streams=1)
    sp.add("serve.group", 2.0, 4.0, streams=1)      # a second device's
    given(sp.list)
    # the window [-0.5, 9.5) s
    assert read("serve.scheduler_idle", serve_run(window_s=10.0)) == \
        pytest.approx(70.0)


def decode_run():
    # a stretch of 1 s from perf_counter 100 s: kernels over [0.1, 0.3] and
    # [0.5, 0.9] s, so idle [0, 0.1], [0.3, 0.5], [0.9, 1.0]
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": a * 1e6,
               "dur": (b - a) * 1e6} for a, b in [(0.1, 0.3), (0.5, 0.9)]]
    run = Run(window_s=30.0, traffic={"modes": ["argmax", "sampling",
                                                "argmax"]})
    run.trace = Trace(events, (0.0, 1e6), 100.0)
    sp = Spans()
    for t0 in (40.0, 41.0):                         # warm-up: one a mode
        warm = sp.add("decode.call", t0, t0 + 0.5)
        sp.add("decode.prep", t0, t0 + 0.4, warm)
    early = sp.add("decode.call", 50.0, 51.0)       # before the stretch
    sp.add("decode.prep", 50.0, 50.5, early)
    call = sp.add("decode.call", 100.01, 100.95)
    sp.add("decode.pack", 100.02, 100.1, call)
    sp.add("decode.prep", 100.02, 100.4, call)
    sp.add("k1.generate", 100.4, 100.5, call)
    late = sp.add("decode.call", 102.0, 103.0)      # after it
    sp.add("decode.prep", 102.0, 102.3, late)
    return run, sp.list


def test_decode_metrics_read_their_exact_values(given):
    run, spans = decode_run()
    given(spans)
    # the window's calls outside the stretch: 500 and 300 ms
    assert read("decode.prep_ms", run) == pytest.approx(400.0)
    # prep [0.02, 0.4] s holds 0.08 + 0.1 s of the 0.4 s idle
    assert read("decode.idle_in_prep", run) == pytest.approx(45.0)


def train_run():
    run = Run(window_s=11.65)
    run.counts["train_steps"] = 4
    run.traffic["setup_steps"] = 3
    run.trace = Trace([], (0.0, 1e6), 20.0)          # stretch [20, 21] s
    sp = Spans()
    for it, t0, host in [(2, 9.0, 0.5), (3, 10.0, 0.04), (4, 10.15, 0.05),
                         (5, 20.1, 0.06), (6, 21.5, 0.09), (7, 22.0, 0.5)]:
        s = sp.add("train.step", t0, t0 + 0.15, iteration=it)
        sp.add("train.next_batch", t0, t0 + 0.001, s)
        sp.add("train.step_fn", t0 + 0.002, t0 + 0.002 + host, s)
    for end, dur in [(9.5, 0.5), (10.05, 0.002), (10.2, 0.004),
                     (20.5, 0.1), (21.6, 0.006), (30.0, 0.5)]:
        sp.add("batch.window", end - dur, end)
    return run, sp.list


def test_train_metrics_read_their_exact_values(given):
    run, spans = train_run()
    given(spans)
    # iterations 3, 4 and 6: 5 is in the stretch, 2 before the window, 7
    # after it
    assert read("train.host_ms", run) == pytest.approx(60.0)
    # windows ending in [10.0, 21.65] s outside the stretch: 2, 4, 6 ms
    assert read("train.batch_window_ms", run) == pytest.approx(4.0)


@pytest.mark.parametrize("name", SERVE + DECODE + TRAIN)
def test_no_spans_read_nothing(given, name):
    run, _ = {**{n: decode_run() for n in DECODE},
              **{n: train_run() for n in TRAIN}}.get(
        name, (serve_run(), None))
    for spans in (None, [], [s for s in serve_spans() + decode_run()[1]
                             + train_run()[1] if s.name == "k1.generate"]):
        given(spans)
        assert read(name, run) is None


def test_a_program_without_the_registry_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiler, "spans")
    assert P.recorded() is None
    for name in SERVE + DECODE + TRAIN:
        assert read(name, Run(window_s=45.0)) is None


@pytest.mark.parametrize("name,metrics", [
    ("default.decode.b20", ("decode.prep_ms",)),
    ("default.train.f32", TRAIN),
    ("default.serve.c32", SERVE[:-1])])
def test_traced_cpu_runs_read_the_programs_spans(name, metrics):
    """The CPU has no device events: decode.idle_in_prep finds nothing.
    A tiny serve window of 1 s need not hold a whole group, which
    serve.group_size counts alone."""
    profiler.clear()
    run = tiny.run(name, trace=True, seconds=1.0)
    per = harness.read_metrics(harness.ROOT, harness.benchmark(), name, run,
                               True)
    for m in metrics:
        assert per[m]["value"] >= 0, m
    assert per.get("serve.group_size", {"value": 1})["value"] >= 1
    assert "decode.idle_in_prep" not in per
