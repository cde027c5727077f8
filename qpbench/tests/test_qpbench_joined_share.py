"""serve.joined_share, the share of the window's streams that joined a
running session: on hand-made spans to its exact value, None without
spans or on spans that carry no `joined` (a program that admits no stream
into a running session); and on a tiny traced CPU serve run with
staggered arrivals, where it and every other serve metric that reads the
program's spans read a number."""

import pytest

from qpbench import harness
from qpbench.tests import tiny
from qpbench.tests.test_qpbench_program_spans import (SERVE, Spans, read,
                                                      serve_run)
from qpnet_tpu_torch.utils import profiler


def queue_spans(joined):
    sp = Spans()
    # the window opens 0.5 s before the first queue start (1.0 s)
    for rid, (t0, j) in enumerate(zip([1.0, 2.0, 3.0, 4.0, 50.0], joined)):
        attrs = {"group": rid} if j is None else {"group": rid, "joined": j}
        sp.add("serve.queue", t0, t0 + 0.1, rid=rid, **attrs)
    sp.add("serve.queue", 5.0, 6.0, rid=9, cancelled=True)
    return sp.list


@pytest.fixture
def given(monkeypatch):
    from qpbench import program_spans as P

    def use(spans):
        monkeypatch.setattr(P, "recorded", lambda: spans)
    return use


def test_joined_share_reads_the_windows_requests(given):
    # the fifth request lies past the window, the cancelled one never
    # reached a session: 3 of the 4 in the window joined
    given(queue_spans([False, True, True, True, False]))
    assert read("serve.joined_share", serve_run()) == pytest.approx(75.0)
    given(queue_spans([False, False, False, False, True]))
    assert read("serve.joined_share", serve_run()) == pytest.approx(0.0)


@pytest.mark.parametrize("spans", [None, [], "unmarked"])
def test_joined_share_reads_nothing_without_joined_spans(given, spans):
    given(queue_spans([None] * 5) if spans == "unmarked" else spans)
    assert read("serve.joined_share", serve_run()) is None


def test_traced_cpu_serve_run_with_staggered_arrivals_reads_every_metric():
    """Four conversations, turns 0.05-0.2 s apart: streams join running
    sessions, and every serve metric of the program's spans reads."""
    profiler.clear()
    name = "default.serve.c32"
    run = tiny.run(name, trace=True, seconds=3.0)
    assert run.correct
    per = harness.read_metrics(harness.ROOT, harness.benchmark(), name, run,
                               True)
    for m in SERVE + ("serve.joined_share",):
        assert per[m]["value"] >= 0, m
    assert per["serve.joined_share"]["value"] > 0
    assert profiler.counters()["serve.joined"] > 0
