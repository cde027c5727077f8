"""The port's tracing (`qpnet_tpu_torch/utils/profiler.py`) on the CPU: the
registry's spans, parents, request ids, ring and counters; the Chrome
trace that `trace()` writes with the spans on its own time base; and the
spans that the service, the decode entry and the training loop record at
their layer boundaries, at a tiny width."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from qpnet_tpu_torch import serve as tserve
from qpnet_tpu_torch.config import ModelConfig, TrainConfig
from qpnet_tpu_torch.data import batcher as TB
from qpnet_tpu_torch.models import generate as TG
from qpnet_tpu_torch.models import qpnet as TQ
from qpnet_tpu_torch.ops import gen_kernel as K
from qpnet_tpu_torch.ops import train_kernel as TK
from qpnet_tpu_torch.ops import world_kernel as WK
from qpnet_tpu_torch.train import trainer as TT
from qpnet_tpu_torch.utils import profiler

from torch_port_threads import one_thread  # noqa: F401

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=1,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=10)


@pytest.fixture(autouse=True)
def empty_registry():
    profiler.clear()
    yield
    profiler.clear()


def by_name(recorded, name):
    return [s for s in recorded if s.name == name]


def children(recorded, parent):
    return [s for s in recorded if s.parent_id == parent.span_id]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_spans_nest_on_their_thread_and_begin_names_no_child():
    with profiler.span("outer", k=1) as outer:
        with profiler.span("inner") as inner:
            loose = profiler.begin("loose", rid=7)
            with profiler.span("leaf"):
                pass
        outer.attrs["late"] = True
    profiler.end(loose, n=3)
    profiler.end(loose)                              # once only
    rec = {s.name: s for s in profiler.spans()}
    assert list(rec) == ["leaf", "inner", "outer", "loose"]
    assert rec["outer"].parent_id is None
    assert rec["inner"].parent_id == outer.span_id
    # a span begun by hand is no block: the leaf's parent is still inner
    assert rec["loose"].parent_id == inner.span_id
    assert rec["leaf"].parent_id == inner.span_id
    assert rec["loose"].rid == 7 and rec["loose"].attrs == {"n": 3}
    assert rec["outer"].attrs == {"k": 1, "late": True}
    for s in rec.values():
        assert s.t1_ns >= s.t0_ns
        assert s.thread == threading.get_native_id()
    assert rec["outer"].t0_ns <= rec["inner"].t0_ns <= rec["leaf"].t0_ns
    assert rec["leaf"].t1_ns <= rec["inner"].t1_ns <= rec["outer"].t1_ns


def test_a_span_given_its_parent_takes_it_over_the_open_block():
    loose = profiler.begin("loose")
    with profiler.span("outer") as outer:
        with profiler.span("adopted", parent=loose) as adopted:
            with profiler.span("leaf"):
                pass
        late = profiler.begin("late", parent=loose, k=2)
    profiler.end(late)
    profiler.end(loose)
    rec = {s.name: s for s in profiler.spans()}
    assert rec["adopted"].parent_id == loose.span_id
    assert rec["leaf"].parent_id == adopted.span_id
    assert rec["late"].parent_id == loose.span_id
    assert rec["late"].attrs == {"k": 2}
    assert rec["outer"].parent_id is None and outer.span_id != loose.span_id


def test_a_request_id_joins_spans_across_threads():
    rid = profiler.new_rid()
    queued = profiler.begin("queue", rid=rid)

    def worker():
        profiler.end(queued)
        with profiler.span("work", rid=rid):
            pass

    with profiler.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    rec = {s.name: s for s in profiler.spans()}
    assert rec["queue"].rid == rec["work"].rid == rid
    # the worker's span has no parent on its own thread
    assert rec["work"].parent_id is None and rec["queue"].parent_id is None
    assert rec["work"].thread == rec["queue"].thread != rec["main"].thread
    assert profiler.new_rid() != rid


def test_the_ring_drops_its_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiler, "RING", 8)
    for i in range(11):
        with profiler.span("s", i=i):
            pass
    kept = profiler.spans()
    assert [s.attrs["i"] for s in kept] == list(range(3, 11))
    assert profiler.counters()["trace.dropped"] == 3


def test_counters_and_the_kernel_wrappers_reads_of_them():
    profiler.count("a.x")
    profiler.count("a.x", 4)
    profiler.count("b")
    assert profiler.counters() == {"a.x": 5, "b": 1}
    profiler.reset_counters("a.")
    assert profiler.counters() == {"b": 1}
    profiler.count("k1.launch.bf16", 2)
    profiler.count("k1.launch.w8a8")
    profiler.count("k2.fwd", 3)
    profiler.count("k2.bwd", 4)
    profiler.count("world.viterbi", 5)
    assert (K.launch_count, K.w8a8_launch_count) == (2, 1)
    assert (TK.fwd_launch_count, TK.bwd_launch_count) == (3, 4)
    assert WK.launch_count("viterbi") == 5 and WK.launch_count("pool") == 0
    K.reset_launch_count()
    TK.reset_launch_counts()
    WK.reset_launch_count()
    assert profiler.counters() == {"b": 1}
    assert K.launch_count == TK.fwd_launch_count == 0
    with pytest.raises(AttributeError):
        K.no_such_counter


def test_threads_lose_no_span_and_no_count():
    """More threads than cores, switching often: every span and count of
    every thread is there."""
    n_threads = 4 * (os.cpu_count() or 2)
    n_each = min(300, profiler.RING // n_threads)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n_each):
                with profiler.span("w", k=k):
                    profiler.count("n")
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    rec = by_name(profiler.spans(), "w")
    assert profiler.counters()["n"] == n_threads * n_each
    assert len(rec) == n_threads * n_each
    assert len({s.span_id for s in rec}) == len(rec)
    assert all(s.parent_id is None for s in rec)


def test_trace_writes_the_spans_on_the_traces_own_base(tmp_path):
    with profiler.trace(str(tmp_path / "tr")):
        with profiler.span("outer", n=2):
            time.sleep(0.01)
            with torch.profiler.record_function("inner"):
                time.sleep(0.01)
            time.sleep(0.01)
    (name,) = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / name) as f:
        events = json.load(f)["traceEvents"]
    (inner,) = [e for e in events if e.get("name") == "inner"]
    (outer,) = [e for e in events if e.get("cat") == "qpnet_span"]
    assert outer["name"] == "outer" and outer["ph"] == "X"
    assert outer["args"]["n"] == 2 and outer["args"]["parent_id"] is None
    assert outer["pid"] == inner["pid"] and outer["tid"] == inner["tid"]
    # on one axis: the span holds the op, 10 ms on each side
    before = float(inner["ts"]) - float(outer["ts"])
    after = (float(outer["ts"]) + float(outer["dur"])
             - float(inner["ts"]) - float(inner["dur"]))
    assert 8e3 < before < 30e3 and 8e3 < after < 30e3


# ---------------------------------------------------------------------------
# the layers' spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(**TINY)
    return cfg, TQ.init_params(3, cfg, device="cpu")


def test_service_spans_form_each_requests_tree(tiny):
    """Three TCP streams in one group of a bucket prewarm() missed."""
    cfg, params = tiny
    svc = tserve.StreamingService(params, cfg, max_streams=3, maxd=4,
                                  gather_window_s=30.0, gather_quiet_s=30.0,
                                  min_chunk_samples=40, mode="argmax",
                                  devices=["cpu"])
    svc.prewarm([1])
    srv = tserve.serve_tcp(svc, "127.0.0.1", 0)
    rng = np.random.default_rng(1)
    lens = [6, 11, 17]
    got = {}

    def client(i):
        h = rng.normal(size=(lens[i], cfg.n_aux)).astype(np.float32)
        d = np.full(lens[i], 2.0, np.float32)
        got[i] = np.concatenate(list(tserve.request_stream(
            srv.server_address, h, d)))

    try:
        profiler.clear()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert tserve.request_stats(srv.server_address)["ok"]
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    up = cfg.upsampling_factor
    assert sorted(len(v) for v in got.values()) == [F * up for F in lens]
    rec = profiler.spans()
    (group,) = by_name(rec, "serve.group")
    assert group.attrs == {"group": 0, "streams": 3, "bucket": 4,
                           "built": True}
    (gather,) = by_name(rec, "serve.gather")
    assert gather.attrs == {"group": 0, "streams": 3}
    assert gather.t1_ns <= group.t0_ns
    (build,) = by_name(children(rec, group), "serve.session_build")
    assert build.attrs == {"bucket": 4}
    assert profiler.counters()["serve.session_builds"] == 1
    feeds = by_name(children(rec, group), "serve.feed")
    # 40-sample chunks of 4 frames: ceil(17 / 4) feeds
    assert [f.attrs for f in feeds] == [{"index": k, "frames": 4}
                                        for k in range(5)]
    for k, feed in enumerate(feeds):
        names = [s.name for s in sorted(children(rec, feed),
                                        key=lambda s: s.t0_ns)]
        assert names == (["gen.prime"] if k == 0 else []) + [
            "gen.upload", "k1.generate", "gen.copy_back"]
    queues = by_name(rec, "serve.queue")       # the probe queues nothing
    assert len({q.rid for q in queues}) == 3 and None not in \
        {q.rid for q in queues}
    n_writes = []
    for queue in queues:
        mine = [s for s in rec if s.rid == queue.rid]
        assert queue.attrs == {"group": 0, "joined": False} and \
            queue.parent_id is None
        assert queue.t1_ns <= feeds[0].t0_ns
        writes = sorted(by_name(mine, "serve.write"), key=lambda s: s.t0_ns)
        n_writes.append(len(writes))
        assert [w.attrs["first"] for w in writes] == \
            [True] + [False] * (len(writes) - 1)
        assert writes[0].t0_ns >= feeds[0].t1_ns
        assert {s.name for s in mine} == {"serve.queue", "serve.write"}
    assert sorted(n_writes) == [-(-F // 4) for F in lens]


def test_decode_entry_spans_prep_chunks_and_copy_back(tiny, monkeypatch):
    cfg, params = tiny
    monkeypatch.setattr(TG, "DECODE_CHUNK_FRAMES", 10)
    B, F = 2, 23
    rng = np.random.default_rng(2)
    h = rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32)
    d = np.full((B, F * 10), 2.0, np.float32)
    x = np.full((B, 1), cfg.n_quantize // 2, np.int32)
    n = [F * 10 - 1, F * 10 - 31]
    out = TG.batch_fast_generate(params, cfg, x, h, n, d, mode="argmax",
                                 engine="pallas", device="cpu")
    assert [len(o) for o in out] == n
    rec = profiler.spans()
    (call,) = by_name(rec, "decode.call")
    assert call.parent_id is None
    assert call.attrs == {"B": 2, "n_steps": n[0], "engine": "pallas",
                          "quantize": "none"}
    inside = sorted(children(rec, call), key=lambda s: s.t0_ns)
    # 229 steps round up to 300 (10-frame buckets): chunks of 10 frames
    assert [s.name for s in inside] == ["decode.prep"] + \
        ["k1.generate"] * 3 + ["decode.copy_back"]
    assert [s.attrs["n_steps"] for s in inside[1:4]] == [100] * 3
    prep = inside[0]
    assert [s.name for s in sorted(children(rec, prep),
                                   key=lambda s: s.t0_ns)] == [
        "decode.pack", "decode.prime", "decode.host_prep"]
    assert prep.t1_ns <= inside[1].t0_ns
    profiler.clear()
    # the scan engine records the call alone
    TG.batch_fast_generate(params, cfg, x, h, n, d, mode="argmax",
                           engine="xla", compute_dtype=torch.float32,
                           device="cpu")
    assert [(s.name, s.attrs["engine"]) for s in profiler.spans()] == [
        ("decode.call", "xla")]


def test_train_loop_spans_its_steps_and_the_batchers_windows(tiny,
                                                             tmp_path):
    cfg, _ = tiny
    rng = np.random.default_rng(0)
    utts = []
    for _ in range(3):
        n = 100 * int(rng.integers(8, 12))
        h = rng.normal(size=(n // 10, cfg.n_aux)).astype(np.float32)
        h[:, 1] = rng.uniform(60, 120)
        x = 0.3 * np.sin(np.arange(n) * 0.3) + 0.05 * rng.normal(size=n)
        utts.append((1000, x.astype(np.float32), h))
    batches = TB.background(2)(TB.window_batches)(
        TB.utterance_stream(utts, lambda u: u, seed=0), cfg,
        batch_length=200, batch_size=1, max_length=300)
    tcfg = TrainConfig(lr=2e-3, iters=3, checkpoint_interval=2, intervals=3,
                       batch_length=200, max_length=300, seed=2,
                       fixed_engine="auto")
    TT.train_loop(cfg, tcfg, batches, str(tmp_path), device="cpu")
    rec = profiler.spans()
    steps = sorted(by_name(rec, "train.step"), key=lambda s: s.t0_ns)
    assert [s.attrs for s in steps] == [{"iteration": i} for i in range(3)]
    want = {0: [], 1: ["train.save"], 2: ["train.log"]}
    for i, step in enumerate(steps):
        assert step.parent_id is None
        names = [s.name for s in sorted(children(rec, step),
                                        key=lambda s: s.t0_ns)]
        assert names == ["train.next_batch", "train.to_device",
                         "train.step_fn"] + want[i]
    (save,) = by_name(rec, "train.save")
    assert save.attrs == {"iteration": 2}
    windows = by_name(rec, "batch.window")
    # at least the 3 batches taken, on the prefetch thread
    assert len(windows) >= 3
    assert all(w.thread != steps[0].thread for w in windows)
    assert all(w.parent_id is None for w in windows)
    assert all(w.t1_ns >= w.t0_ns for w in windows)
