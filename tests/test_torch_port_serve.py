"""PyTorch port vs the JAX package: the streaming generator and the serving
stack on the CPU (the generation kernel's plain twin).

The port's `StreamingGenerator` must equal JAX's `StreamingGenerator(
interpret=True)` in argmax and sampling mode, and its chunked, variable-chunk
and w8a8 feeds must equal one-shot runs.  `StreamingService` keeps the JAX
service's behaviours (grouping, trimming, validation, cancellation,
back-pressure, stats, a device pool, prewarm), and the TCP protocol is the
JAX package's byte for byte: each package's client talks to the other's
server with equal PCM."""

import json
import socket
import struct
import threading
import time

import jax
import numpy as np
import pytest

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.models import generate as JG
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu import serve as jserve
from qpnet_tpu_torch import serve as tserve
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.data.stats import Scaler
from qpnet_tpu_torch.models import generate as TG
from qpnet_tpu_torch.models import qpnet as TQ
from qpnet_tpu_torch.ops import decode_mu_law

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=2,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=5)
MAXD, CHUNK = 4, 40          # chunk of 8 frames


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg = JaxConfig(**TINY), ModelConfig(**TINY)
    pj = jax_init_params(jax.random.PRNGKey(0), cfg_j)
    pt = TQ.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return cfg_j, pj, cfg, pt


def session(cfg, params, B, **kw):
    kw.setdefault("mode", "argmax")
    return TG.StreamingGenerator(params, cfg, B, maxd=MAXD,
                                 min_chunk_samples=CHUNK, device="cpu", **kw)


def pcm(mu, cfg):
    return np.clip(decode_mu_law(mu, cfg.n_quantize) * 32768, -32768,
                   32767).astype(np.int16)


# ---------------------------------------------------------------------------
# StreamingGenerator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_streams(model):
    """JAX's interpret-mode sessions, B=2, two feeds (1 and 3 frames), in
    argmax and sampling mode."""
    cfg_j, pj, _, _ = model
    rng = np.random.default_rng(0)
    h = rng.normal(size=(2, 4, cfg_j.n_aux)).astype(np.float32)
    d = rng.uniform(1.0, 3.5, (2, 4)).astype(np.float32)
    out = {}
    for mode in ("argmax", "sampling"):
        s = JG.StreamingGenerator(pj, cfg_j, 2, maxd=MAXD, mode=mode,
                                  min_chunk_samples=CHUNK, interpret=True)
        out[mode] = [s.feed(h[:, :1], d[:, :1]), s.feed(h[:, 1:], d[:, 1:])]
    return h, d, out


@pytest.mark.parametrize("mode", ["argmax", "sampling"])
def test_streaming_generator_matches_jax(model, jax_streams, mode):
    _, _, cfg, pt = model
    h, d, want = jax_streams
    sess = session(cfg, pt, 2, mode=mode)
    assert (sess.chunk, sess.chunk_frames) == (40, 8)
    got = [sess.feed(h[:, :1], d[:, :1]), sess.feed(h[:, 1:], d[:, 1:])]
    for g, w in zip(got, want[mode]):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("quantize", ["none", "w8a8"])
def test_chunked_and_variable_feeds_match_one_shot(model, quantize):
    """Nominal chunks and an irregular whole-frame schedule both equal the
    one-shot kernel path on the same conditioning and seed history."""
    _, _, cfg, pt = model
    rng = np.random.default_rng(1)
    B, F = 2, 13
    up = cfg.upsampling_factor
    h = rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32)
    d = rng.uniform(1.0, 3.5, (B, F)).astype(np.float32)
    x_seed = np.full((B, cfg.receptive_field(MAXD) + 1), cfg.n_quantize // 2,
                     np.int32)
    one_shot = TG._pallas_path(pt, cfg, x_seed, h, np.repeat(d, up, axis=1),
                               F * up, MAXD, seed=100, mode="sampling",
                               const_seed=True, device="cpu",
                               quantize=quantize)
    for schedule in ((8, 5), (1, 4, 2, 6)):
        sess = session(cfg, pt, B, mode="sampling", quantize=quantize)
        got, start = [], 0
        for L in schedule:
            got.append(sess.feed(h[:, start:start + L], d[:, start:start + L]))
            start += L
        np.testing.assert_array_equal(np.concatenate(got, axis=1), one_shot)


def test_reset_restarts_the_stream(model):
    _, _, cfg, pt = model
    rng = np.random.default_rng(2)
    h = rng.normal(size=(1, 3, cfg.n_aux)).astype(np.float32)
    d = np.full((1, 3), 2.0, np.float32)
    sess = session(cfg, pt, 1, mode="sampling", seed=5)
    first = sess.feed(h, d)
    sess.feed(h, d)
    sess.reset(seed=5)
    np.testing.assert_array_equal(sess.feed(h, d), first)
    sess.reset(seed=6)
    assert not np.array_equal(sess.feed(h, d), first)


def test_feed_validation(model):
    _, _, cfg, pt = model
    sess = session(cfg, pt, 2)
    with pytest.raises(ValueError, match="h_frames"):
        sess.feed(np.zeros((2, 0, cfg.n_aux)), np.zeros((2, 0)))
    with pytest.raises(ValueError, match="d_frames"):
        sess.feed(np.zeros((2, 3, cfg.n_aux)), np.ones((2, 4)))
    with pytest.raises(ValueError, match="maxd"):
        sess.feed(np.zeros((2, 3, cfg.n_aux)), np.full((2, 3), 9.0))
    with pytest.raises(ValueError, match="unknown quantize"):
        session(cfg, pt, 1, quantize="int4")
    # int8_weights streams with bf16 weights, as the JAX package's session
    # does: the "none" session's samples, bit for bit
    h = np.random.default_rng(3).normal(size=(1, 2, cfg.n_aux))
    d = np.full((1, 2), 2.0, np.float32)
    np.testing.assert_array_equal(
        session(cfg, pt, 1, quantize="int8_weights").feed(h, d),
        session(cfg, pt, 1).feed(h, d))


# ---------------------------------------------------------------------------
# StreamingService
# ---------------------------------------------------------------------------

def make_service(cfg, params, **kw):
    kw.setdefault("maxd", MAXD)
    kw.setdefault("mode", "argmax")
    kw.setdefault("min_chunk_samples", CHUNK)
    kw.setdefault("gather_window_s", 0.2)
    kw.setdefault("devices", ["cpu"])
    return tserve.StreamingService(params, cfg, **kw)


def _wait_for(pred, timeout=30.0, step=0.05):
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            return False
        time.sleep(step)
    return True


def test_full_group_matches_direct_generator(model):
    _, _, cfg, pt = model
    rng = np.random.default_rng(3)
    F = 10
    h = rng.normal(size=(4, F, cfg.n_aux)).astype(np.float32)
    d = rng.uniform(1.0, 3.5, (4, F)).astype(np.float32)
    svc = make_service(cfg, pt, max_streams=4)
    try:
        got = [hd.samples() for hd in
               [svc.submit(h[i], d[i]) for i in range(4)]]
    finally:
        svc.close()
    # the schedule: one nominal chunk of 8 frames, then 8 more (2 real and
    # 6 repeat-last padding)
    pad = np.concatenate([h, np.repeat(h[:, -1:], 6, 1)], 1)
    dpad = np.concatenate([d, np.repeat(d[:, -1:], 6, 1)], 1)
    sess = session(cfg, pt, 4)
    want = np.concatenate([sess.feed(pad[:, :8], dpad[:, :8]),
                           sess.feed(pad[:, 8:], dpad[:, 8:])], 1)
    for i in range(4):
        assert got[i].shape == (F * cfg.upsampling_factor,)
        np.testing.assert_array_equal(got[i], want[i, :got[i].shape[0]])
    assert svc.stats == {"groups": 1, "feeds": 2, "streams_done": 4,
                         "streams_cancelled": 0}


def test_ragged_lengths_trimmed_per_stream(model):
    _, _, cfg, pt = model
    rng = np.random.default_rng(4)
    up = cfg.upsampling_factor
    svc = make_service(cfg, pt, max_streams=4)
    try:
        lengths = [6, 8, 19]
        handles = [svc.submit(rng.normal(size=(F, cfg.n_aux)),
                              np.full(F, 2.0, np.float32)) for F in lengths]
        for F, hd in zip(lengths, handles):
            out = hd.samples()
            assert out.shape == (F * up,) and out.dtype == np.int32
            assert (out >= 0).all() and (out < cfg.n_quantize).all()
        # a group of three runs as a session of four (power-of-two bucket)
        assert sorted(svc._sessions[0]) == [4]
    finally:
        svc.close()


def test_submit_validation(model):
    _, _, cfg, pt = model
    svc = make_service(cfg, pt)
    try:
        with pytest.raises(ValueError, match="must be"):
            svc.submit(np.zeros((5, cfg.n_aux + 1)), np.full(5, 2.0))
        with pytest.raises(ValueError, match="exceeds"):
            svc.submit(np.zeros((5, cfg.n_aux)), np.full(5, 99.0))
        with pytest.raises(ValueError, match="empty"):
            svc.submit(np.zeros((0, cfg.n_aux)), np.zeros(0))
        with pytest.raises(ValueError, match="d must be"):
            svc.submit(np.zeros((5, cfg.n_aux)), np.full(4, 2.0))
        with pytest.raises(RuntimeError, match="frontend"):
            svc.submit_raw(np.zeros((5, cfg.n_aux)))
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(np.zeros((5, cfg.n_aux)), np.full(5, 2.0))


def test_cancel_mid_stream_stops_group_early(model):
    _, _, cfg, pt = model
    rng = np.random.default_rng(5)
    F = 6 * 8
    h = rng.normal(size=(F, cfg.n_aux)).astype(np.float32)
    d = rng.uniform(1.0, 3.5, F).astype(np.float32)
    svc_ref = make_service(cfg, pt, max_streams=1)
    try:
        full = svc_ref.submit(h, d).samples()
        assert svc_ref.stats["feeds"] == 6
    finally:
        svc_ref.close()
    svc = make_service(cfg, pt, max_streams=1)
    try:
        hd = svc.submit(h, d)
        first = next(hd.chunks())
        hd.cancel()
    finally:
        svc.close()
    np.testing.assert_array_equal(first, full[: len(first)])
    assert svc.stats["feeds"] < 6
    assert svc.stats["streams_cancelled"] == 1
    assert svc.stats["streams_done"] == 0


def test_cancel_pending_request_never_reaches_a_kernel(model):
    _, _, cfg, pt = model
    h = np.zeros((4, cfg.n_aux), np.float32)
    d = np.full(4, 2.0, np.float32)
    svc = make_service(cfg, pt, max_streams=2, gather_window_s=1.0)
    try:
        doomed = svc.submit(h, d)
        doomed.cancel()
        assert list(doomed.chunks()) == []
        assert svc.submit(h, d).samples().shape == (4 * cfg.upsampling_factor,)
        assert _wait_for(lambda: svc.stats["streams_done"] == 1)
        assert svc.stats["streams_cancelled"] == 1
    finally:
        svc.close()


def test_cancel_unblocks_a_blocked_reader(model):
    _, _, cfg, pt = model
    svc = make_service(cfg, pt, max_streams=2, gather_window_s=5.0)
    try:
        hd = svc.submit(np.zeros((2, cfg.n_aux)), np.full(2, 2.0))
        got = []
        t = threading.Thread(target=lambda: got.extend(hd.chunks()))
        t.start()
        time.sleep(0.1)
        hd.cancel()
        t.join(timeout=10)
        assert not t.is_alive() and got == []
    finally:
        svc.close()


def test_max_pending_backpressure(model):
    _, _, cfg, pt = model
    h = np.zeros((2, cfg.n_aux), np.float32)
    d = np.full(2, 2.0, np.float32)
    svc = make_service(cfg, pt, max_streams=4, gather_window_s=5.0,
                       max_pending=2)
    try:
        a = svc.submit(h, d)
        b = svc.submit(h, d)
        with pytest.raises(RuntimeError, match="overloaded"):
            svc.submit(h, d)
    finally:
        svc.close()
    # the queued pair still completes on the close's drain
    assert a.samples().shape == b.samples().shape == (2 * 5,)


def test_device_pool_spreads_groups(model):
    """Two CPU devices, one scheduler each: two full groups, each equal to a
    direct B=2 session, whichever device served it."""
    _, _, cfg, pt = model
    rng = np.random.default_rng(6)
    h = rng.normal(size=(4, 8, cfg.n_aux)).astype(np.float32)
    d = rng.uniform(1.0, 3.5, (4, 8)).astype(np.float32)
    svc = make_service(cfg, pt, max_streams=2, devices=["cpu", "cpu"])
    try:
        assert len(svc._threads) == 2
        got = [hd.samples() for hd in
               [svc.submit(h[i], d[i]) for i in range(4)]]
    finally:
        svc.close()
    for pair in ((0, 1), (2, 3)):
        want = session(cfg, pt, 2).feed(h[list(pair)], d[list(pair)])
        for j, i in enumerate(pair):
            np.testing.assert_array_equal(got[i], want[j])


def test_prewarm_builds_sessions_and_output_is_unchanged(model):
    _, _, cfg, pt = model
    rng = np.random.default_rng(7)
    h = rng.normal(size=(7, cfg.n_aux)).astype(np.float32)
    d = np.full(7, 2.0, np.float32)
    svc_cold = make_service(cfg, pt, max_streams=2)
    try:
        want = svc_cold.submit(h, d).samples()
    finally:
        svc_cold.close()
    svc = make_service(cfg, pt, max_streams=2, first_chunk_samples=10)
    try:
        svc.prewarm([1, 2])
        assert sorted(svc._sessions[0]) == [1, 2]
        chunks = list(svc.submit(h, d).chunks())
    finally:
        svc.close()
    assert chunks[0].shape == (10,)              # the short first chunk
    np.testing.assert_array_equal(np.concatenate(chunks), want)


def test_stats_and_idle_dispatch(model):
    """A lone request dispatches once arrivals go quiet, not after the
    gather window; the stats probe reports the counters, and not-ok once
    the service is closed."""
    _, _, cfg, pt = model
    svc = make_service(cfg, pt, max_streams=4, gather_window_s=30.0,
                       gather_quiet_s=0.05)
    srv = tserve.serve_tcp(svc, port=0)
    try:
        st = tserve.request_stats(srv.server_address)
        assert st == {"ok": True, "pending": 0, "devices": 1,
                      "max_streams": 4, "groups": 0, "feeds": 0,
                      "streams_done": 0, "streams_cancelled": 0}
        t0 = time.monotonic()
        svc.submit(np.zeros((4, cfg.n_aux)), np.full(4, 2.0)).samples()
        assert time.monotonic() - t0 < 10.0
        st = tserve.request_stats(srv.server_address)
        assert st["streams_done"] == 1 and st["groups"] == 1
    finally:
        srv.shutdown()
        svc.close()
    srv2 = tserve.serve_tcp(svc, port=0)
    try:
        assert tserve.request_stats(srv2.server_address)["ok"] is False
    finally:
        srv2.shutdown()
    svc2 = make_service(cfg, pt, gather_window_s=1.0)
    svc2.close()
    assert svc2.gather_quiet_s == pytest.approx(0.1)


def test_tcp_disconnect_cancels_stream(model):
    _, _, cfg, pt = model
    F = 8 * 8
    rng = np.random.default_rng(8)
    h = rng.normal(size=(F, cfg.n_aux)).astype("<f4")
    d = np.full(F, 2.5, "<f4")
    svc = make_service(cfg, pt, max_streams=1)
    srv = tserve.serve_tcp(svc, port=0)
    try:
        with socket.create_connection(srv.server_address) as s:
            s.sendall(json.dumps({"frames": F}).encode() + b"\n"
                      + h.tobytes() + d.tobytes())
            buf = s.makefile("rb")
            n = struct.unpack("<I", buf.read(4))[0]
            buf.read(2 * n)
            buf.close()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
        assert _wait_for(lambda: svc.stats["streams_cancelled"] == 1)
        assert svc.stats["streams_done"] == 0
    finally:
        srv.shutdown()
        svc.close()


def test_service_defaults_to_cuda(model):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    _, _, cfg, pt = model
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.StreamingService(pt, cfg)


# ---------------------------------------------------------------------------
# StreamingService: streams join a running session at feed boundaries
# ---------------------------------------------------------------------------

def stream(rng, cfg, F):
    return (rng.normal(size=(F, cfg.n_aux)).astype(np.float32),
            rng.uniform(1.0, 3.5, F).astype(np.float32))


def padded(h, d, start, L):
    """L frames of a stream from `start`, repeat-last padding past its
    end (the service's block for one row)."""
    sl = slice(start, start + L)
    hs, ds = h[sl], d[sl]
    n = L - len(hs)
    return (np.concatenate([hs, np.repeat(hs[-1:], n, 0)]),
            np.concatenate([ds, np.repeat(ds[-1:], n)]))


def block(cfg, B, rows, start, L):
    """A feed of B rows, each of `rows` {row: (h, d)} from `start`, the
    others zero."""
    hb = np.zeros((B, L, cfg.n_aux), np.float32)
    db = np.ones((B, L), np.float32)
    for i, (h, d) in rows.items():
        hb[i], db[i] = padded(h, d, start, L)
    return hb, db


def fresh_row(cfg, pt, B, row, h, d, L=8):
    """A stream from offset 0 in `row` of a fresh session of bucket B, in
    nominal feeds, trimmed to its length."""
    sess = session(cfg, pt, B)
    out = [sess.feed(*block(cfg, B, {row: (h, d)}, s, L))[row]
           for s in range(0, h.shape[0], L)]
    return np.concatenate(out)[: h.shape[0] * cfg.upsampling_factor]


def hook_feed(sess, at, fn):
    """Call fn() just before the session's feed number `at` (from 1): the
    scheduler then finds what fn submits or cancels at the boundary after
    that feed.  Returns the list of the h blocks the session is fed."""
    seen, feed = [], sess.feed

    def hooked(h, d):
        seen.append(np.array(h))
        if len(seen) == at:
            fn()
        return feed(h, d)

    sess.feed = hooked
    return seen


def copy_row(src, dst, row_src, row_dst):
    """By hand: the state of one row of a running session into a row of
    another, with its step and seed (zero state where dst has none)."""
    if dst._state is None:
        dst._state = tuple(t.new_zeros((t.shape[0], dst.B) + t.shape[2:])
                           for t in src._state)
    for s, t in zip(src._state, dst._state):
        t[:, row_dst] = s[:, row_src]
    dst._offset, dst.seed = src._offset, src.seed


def joined_lone_stream(cfg, pt):
    """A lone stream A (5 feeds) in a bucket-1 session; C (12 frames) is
    submitted during A's second feed and joins at the boundary after it,
    moving A to the bucket-2 session."""
    from qpnet_tpu_torch.utils import profiler
    rng = np.random.default_rng(12)
    (ha, da), (hc, dc) = stream(rng, cfg, 40), stream(rng, cfg, 12)
    profiler.reset_counters("serve.")
    svc = make_service(cfg, pt, max_streams=4)
    try:
        svc.prewarm([1, 2])
        got = {}
        hook_feed(svc._sessions[0][1], 2,
                  lambda: got.setdefault("C", svc.submit(hc, dc)))
        a = svc.submit(ha, da).samples()
        c = got["C"].samples()
    finally:
        svc.close()
    return (ha, da, a), (hc, dc, c), dict(svc.stats), profiler.counters()


def test_a_stream_joins_a_running_session_at_a_feed_boundary(model):
    """C joins at the boundary after A's second feed, primed in row 1 of
    the bucket-2 session at step 80: its samples equal C from offset 0 in
    row 1 of a fresh bucket-2 session (the rings rolled to the step), and
    A's, moved to bucket 2 and back to 1 once C ends, equal A alone."""
    _, _, cfg, pt = model
    (ha, da, a), (hc, dc, c), stats, counters = joined_lone_stream(cfg, pt)
    np.testing.assert_array_equal(c, fresh_row(cfg, pt, 2, 1, hc, dc))
    np.testing.assert_array_equal(a, fresh_row(cfg, pt, 1, 0, ha, da))
    assert counters["serve.joined"] == 1
    assert counters["serve.bucket_moves"] == 2
    assert stats == {"groups": 2, "feeds": 5, "streams_done": 2,
                     "streams_cancelled": 0}
    assert stats["feeds"] < 5 + 2            # the two groups back to back


def test_rows_move_up_and_down_between_buckets(model):
    """A alone in bucket 1; B1 and B2 join after its first feed (3 rows:
    up to bucket 4); once B1 ends, 2 rows stay in bucket 4 (bucket 2 is not
    built); once B2 ends, A moves down to bucket 1.  A equals a run built
    by hand: its state copied row to row between fresh sessions."""
    from qpnet_tpu_torch.utils import profiler
    _, _, cfg, pt = model
    rng = np.random.default_rng(13)
    (ha, da), (h1, d1), (h2, d2) = (stream(rng, cfg, F) for F in (48, 8, 10))
    profiler.reset_counters("serve.")
    svc = make_service(cfg, pt, max_streams=4)
    try:
        svc.prewarm([1, 4])
        got = {}
        hook_feed(svc._sessions[0][1], 1, lambda: got.update(
            b1=svc.submit(h1, d1), b2=svc.submit(h2, d2)))
        a = svc.submit(ha, da).samples()
        b1, b2 = got["b1"].samples(), got["b2"].samples()
    finally:
        svc.close()
    assert sorted(svc._sessions[0]) == [1, 4]
    counters = profiler.counters()
    assert counters["serve.bucket_moves"] == 2
    assert counters["serve.joined"] == 2
    assert "serve.session_builds" not in counters
    assert svc.stats["feeds"] == 6
    s1, s4, s1b = session(cfg, pt, 1), session(cfg, pt, 4), session(cfg, pt, 1)
    want = [s1.feed(*block(cfg, 1, {0: (ha, da)}, 0, 8))[0]]
    copy_row(s1, s4, 0, 0)
    want += [s4.feed(*block(cfg, 4, {0: (ha, da)}, f, 8))[0]
             for f in (8, 16)]
    copy_row(s4, s1b, 0, 0)
    want += [s1b.feed(*block(cfg, 1, {0: (ha, da)}, f, 8))[0]
             for f in (24, 32, 40)]
    np.testing.assert_array_equal(a, np.concatenate(want))
    np.testing.assert_array_equal(b1, fresh_row(cfg, pt, 4, 1, h1, d1))
    np.testing.assert_array_equal(b2, fresh_row(cfg, pt, 4, 2, h2, d2))


def test_a_cancelled_row_is_freed_and_reused(model):
    """A and X form one bucket-2 group; X is cancelled during the second
    feed and C submitted: at the boundary X's row 1 is freed and C takes
    it, with no bucket move."""
    from qpnet_tpu_torch.utils import profiler
    _, _, cfg, pt = model
    rng = np.random.default_rng(14)
    (ha, da), (hx, dx), (hc, dc) = (stream(rng, cfg, F)
                                    for F in (40, 40, 12))
    profiler.reset_counters("serve.")
    svc = make_service(cfg, pt, max_streams=2)
    try:
        svc.prewarm([2])
        got = {}

        def cancel_and_submit():
            got["X"].cancel()
            got["C"] = svc.submit(hc, dc)

        seen = hook_feed(svc._sessions[0][2], 2, cancel_and_submit)
        a = svc.submit(ha, da)
        got["X"] = svc.submit(hx, dx)
        a = a.samples()
        c = got["C"].samples()
        x = list(got["X"].chunks())
    finally:
        svc.close()
    assert x == []
    np.testing.assert_array_equal(seen[2][1], padded(hc, dc, 0, 8)[0])
    np.testing.assert_array_equal(seen[4][1], np.zeros((8, cfg.n_aux)))
    np.testing.assert_array_equal(c, fresh_row(cfg, pt, 2, 1, hc, dc))
    np.testing.assert_array_equal(a, fresh_row(cfg, pt, 2, 0, ha, da))
    assert svc.stats == {"groups": 2, "feeds": 5, "streams_done": 2,
                         "streams_cancelled": 1}
    assert profiler.counters()["serve.joined"] == 1
    assert "serve.bucket_moves" not in profiler.counters()


def test_each_cohort_has_its_span_tree(model):
    """The run of the joining test: a serve.group a cohort, its serve.queue
    ending with its group index and `joined`, its serve.gather, and the
    serve.feed with index 0 that first carries it under its serve.group."""
    from qpnet_tpu_torch.utils import profiler
    _, _, cfg, pt = model
    profiler.clear()
    joined_lone_stream(cfg, pt)
    rec = profiler.spans()
    groups = sorted((s for s in rec if s.name == "serve.group"),
                    key=lambda s: s.t0_ns)
    assert [g.attrs for g in groups] == [
        {"group": 0, "streams": 1, "bucket": 1, "built": False},
        {"group": 1, "streams": 1, "bucket": 2, "built": False}]
    queues = sorted((s for s in rec if s.name == "serve.queue"),
                    key=lambda s: s.t0_ns)
    assert [q.attrs for q in queues] == [{"group": 0, "joined": False},
                                         {"group": 1, "joined": True}]
    gathers = sorted((s for s in rec if s.name == "serve.gather"),
                     key=lambda s: s.t0_ns)
    assert [s.attrs for s in gathers] == [{"group": 0, "streams": 1},
                                          {"group": 1, "streams": 1}]
    feeds = [s for s in rec if s.name == "serve.feed"]
    assert len(feeds) == 5
    for g, q in zip(groups, queues):
        (first,) = [f for f in feeds if f.parent_id == g.span_id
                    and f.attrs["index"] == 0]
        assert q.t1_ns <= g.t0_ns <= first.t0_ns
        assert first.t1_ns <= g.t1_ns
        names = {s.name for s in rec if s.parent_id == first.span_id}
        assert "gen.prime" in names and "k1.generate" in names
    # C's cohort starts in the middle of A's: spans of cohorts overlap
    assert groups[0].t0_ns < groups[1].t0_ns < groups[1].t1_ns \
        <= groups[0].t1_ns
    profiler.clear()


def test_staggered_streams_over_two_devices_each_equal_a_lone_run(model):
    """Four clients send four streams each, at staggered times, to two
    scheduler threads that share the queue and join streams into their
    running sessions (thread switches forced often): each stream equals
    its lone run, and the counters add up."""
    import sys
    from qpnet_tpu_torch.utils import profiler
    _, _, cfg, pt = model
    rng = np.random.default_rng(15)
    streams = [stream(rng, cfg, int(F)) for F in rng.integers(3, 20, 16)]
    waits = rng.uniform(0.0, 0.05, 16)
    want = [fresh_row(cfg, pt, 1, 0, h, d) for h, d in streams]
    profiler.reset_counters("serve.")
    svc = make_service(cfg, pt, max_streams=3, devices=["cpu", "cpu"],
                       gather_window_s=0.02)
    got = [None] * 16
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        svc.prewarm([1, 2, 4])

        def client(c):
            for k in range(c, 16, 4):
                time.sleep(waits[k])
                got[k] = svc.submit(*streams[k]).samples()

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        svc.close()
    for k in range(16):
        np.testing.assert_array_equal(got[k], want[k])
    assert svc.stats["streams_done"] == 16
    assert svc.stats["streams_cancelled"] == 0
    # a cohort a dispatch or a boundary, each of one stream at least
    assert svc.stats["groups"] <= 16
    assert profiler.counters().get("serve.joined", 0) < 16


@pytest.mark.parametrize("offset", [0, 7, 80, 1234])
def test_rings_rolled_to_a_step_equal_rings_primed_there(model, offset):
    """`_roll_rings` moves rings primed for step 0 to step `offset` as
    `_prime_ring_buffers` primes them for a first step at t0 = offset, on a
    history that is not constant (where the roll is no identity)."""
    import torch
    _, _, cfg, pt = model
    B = 2
    rf = cfg.receptive_field(MAXD)
    g = torch.Generator().manual_seed(offset)
    x_seed = torch.randint(0, cfg.n_quantize, (B, rf + 1), generator=g)
    h0_up = torch.randn((B, cfg.n_aux), generator=g)

    def primed(t0):
        bufsF, bufsA = TG._prime_ring_buffers(pt, cfg, x_seed, h0_up, MAXD,
                                              t0=t0)
        return (torch.cat([b.transpose(0, 1) for b in bufsF]),
                torch.cat([b.transpose(0, 1) for b in bufsA]))

    (f0, a0), (fo, ao) = primed(0), primed(offset)
    sizesA = [MAXD * d + 1 for d in cfg.dilationsA]
    assert torch.equal(TG._roll_rings(f0, cfg.dilationsF, offset), fo)
    assert torch.equal(TG._roll_rings(a0, sizesA, offset), ao)
    if offset:
        assert not torch.equal(a0, ao)


def test_prime_and_move_rows_need_a_running_session(model):
    _, _, cfg, pt = model
    sess = session(cfg, pt, 2)
    with pytest.raises(RuntimeError, match="running session"):
        sess.prime_rows([0], np.zeros((1, cfg.n_aux), np.float32))
    with pytest.raises(RuntimeError, match="running session"):
        sess.move_rows(session(cfg, pt, 1), [0])
    sess.feed(np.zeros((2, 1, cfg.n_aux)), np.ones((2, 1)))
    with pytest.raises(ValueError, match="do not fit"):
        sess.move_rows(session(cfg, pt, 1), [0, 1])


# ---------------------------------------------------------------------------
# the wire protocol, across packages
# ---------------------------------------------------------------------------

def test_wire_constants_equal_jax():
    assert tserve._ERR_SENTINEL == jserve._ERR_SENTINEL == 0xFFFFFFFF
    assert tserve._MAX_WIRE_FRAMES == jserve._MAX_WIRE_FRAMES
    assert tserve._MAX_WIRE_LINE == jserve._MAX_WIRE_LINE


def test_jax_client_against_port_server(model):
    """JAX's request_stream and request_stats against the port's server:
    standardized and raw requests, the error sentinel, and hostile frame
    counts and lines."""
    from qpnet_tpu_torch.bin.qpnet_serve import make_frontend

    _, _, cfg, pt = model
    rng = np.random.default_rng(9)
    scaler = Scaler.from_stats(rng.normal(size=cfg.n_aux),
                               rng.uniform(0.5, 2.0, cfg.n_aux))

    class A:  # the argparse surface make_frontend reads
        f0_dim_index, f0_factor, fs = 1, 1.0, 1000

    frontend = make_frontend(scaler, A, ModelConfig(dense_factor=4))
    svc = make_service(cfg, pt, frontend=frontend)
    srv = tserve.serve_tcp(svc, port=0)
    addr = srv.server_address
    try:
        F = 12
        h = rng.normal(size=(F, cfg.n_aux)).astype(np.float32)
        d = np.full(F, 2.0, np.float32)
        got = np.concatenate(list(jserve.request_stream(addr, h, d)))
        assert got.dtype == np.int16 and got.shape == (F * 5,)
        np.testing.assert_array_equal(got, pcm(svc.submit(h, d).samples(),
                                               cfg))
        feats = np.abs(rng.normal(size=(F, cfg.n_aux))) + 0.1
        feats[:, 1] = rng.uniform(80.0, 200.0, F)    # d = fs/(f0*4) < 4
        got = np.concatenate(list(jserve.request_stream(addr, feats)))
        np.testing.assert_array_equal(
            got, pcm(svc.submit(*frontend(feats)).samples(), cfg))
        with pytest.raises(RuntimeError, match="exceeds"):
            list(jserve.request_stream(addr, h, np.full(F, 99.0, np.float32)))
        st = jserve.request_stats(addr)
        assert st["ok"] is True and st["streams_done"] == 4
        for bad_f in (-1, 0, 2 ** 31):
            with socket.create_connection(addr) as s:
                s.sendall(json.dumps({"frames": bad_f}).encode() + b"\n")
                rf = s.makefile("rb")
                assert struct.unpack("<I", rf.read(4))[0] == 0xFFFFFFFF
                assert b"frames" in rf.readline()
        with socket.create_connection(addr) as s:
            s.sendall(b"x" * (tserve._MAX_WIRE_LINE + 4096))
            rf = s.makefile("rb")
            assert struct.unpack("<I", rf.read(4))[0] == 0xFFFFFFFF
            assert b"exceeds" in rf.readline()
    finally:
        srv.shutdown()
        svc.close()


def test_port_client_against_jax_server_equal_pcm(model):
    """The port's request_stream and request_stats against JAX's server
    (interpret mode): the same PCM as the port's own server gives."""
    cfg_j, pj, cfg, pt = model
    rng = np.random.default_rng(10)
    F = 6
    h = rng.normal(size=(F, cfg.n_aux)).astype(np.float32)
    d = rng.uniform(1.0, 3.5, F).astype(np.float32)
    jsvc = jserve.StreamingService(pj, cfg_j, maxd=MAXD, mode="argmax",
                                   min_chunk_samples=CHUNK,
                                   gather_window_s=0.05, interpret=True)
    jsrv = jserve.serve_tcp(jsvc, port=0)
    try:
        from_jax = np.concatenate(list(tserve.request_stream(
            jsrv.server_address, h, d)))
        st = tserve.request_stats(jsrv.server_address)
        assert st["ok"] is True and st["streams_done"] == 1
        with pytest.raises(RuntimeError, match="exceeds"):
            list(tserve.request_stream(jsrv.server_address, h,
                                       np.full(F, 99.0, np.float32)))
    finally:
        jsrv.shutdown()
        jsvc.close()
    svc = make_service(cfg, pt, gather_window_s=0.05)
    srv = tserve.serve_tcp(svc, port=0)
    try:
        from_port = np.concatenate(list(tserve.request_stream(
            srv.server_address, h, d)))
    finally:
        srv.shutdown()
        svc.close()
    assert from_jax.dtype == from_port.dtype == np.int16
    np.testing.assert_array_equal(from_port, from_jax)


def test_qpnet_serve_cli_round_trip(model, tmp_path):
    """The serve CLI on the CPU from files the JAX package wrote: a raw-mode
    round trip through the server process's wiring equals the frontend plus
    the library."""
    from qpnet_tpu.config import RunConfig as JaxRunConfig
    from qpnet_tpu.data.h5io import write_hdf5
    from qpnet_tpu.train.checkpoint import save_final
    from qpnet_tpu_torch.bin import qpnet_serve

    cfg_j, pj, cfg, pt = model
    save_final(str(tmp_path), pj)
    conf = str(tmp_path / "model.conf")
    JaxRunConfig(model=cfg_j, fs=1000).save(conf)
    stats = str(tmp_path / "stats.h5")
    write_hdf5(stats, "/world/mean", np.zeros(cfg.n_aux))
    write_hdf5(stats, "/world/scale", np.ones(cfg.n_aux))
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    argv = ["--config", conf, "--stats", stats,
            "--checkpoint", str(tmp_path / "checkpoint-final.pkl"),
            "--host", "127.0.0.1", "--port", str(port), "--fs", "1000",
            "--maxd", "4", "--max_streams", "2", "--chunk_samples", "40",
            "--mode", "argmax", "--gather_window_ms", "20", "--device",
            "cpu", "--verbose", "0"]
    threading.Thread(target=qpnet_serve.main, daemon=True,
                     args=(argv,)).start()
    F = 9
    feats = np.abs(np.random.default_rng(11).normal(size=(F, cfg.n_aux)))
    feats[:, 1] = 60.0                             # d = 1000 / 480 < 4
    deadline = time.time() + 30
    while True:
        try:
            got = np.concatenate(list(tserve.request_stream(
                ("127.0.0.1", port), feats)))
            break
        except ConnectionRefusedError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)
    args = qpnet_serve.get_arguments(argv)
    unit = Scaler.from_stats(np.zeros(cfg.n_aux), np.ones(cfg.n_aux))
    svc = make_service(cfg, pt, frontend=qpnet_serve.make_frontend(
        unit, args, cfg))
    try:
        want = pcm(svc.submit_raw(feats).samples(), cfg)
    finally:
        svc.close()
    np.testing.assert_array_equal(got, want)
    # --noise_shaping is served (tests/test_torch_port_feature_cli.py):
    # the CLI builds one restoration filter per stream, none without it
    from qpnet_tpu_torch.dsp.emphasis import StreamingEmphasizer
    assert qpnet_serve.make_postfilter_factory(args, "world") is None
    factory = qpnet_serve.make_postfilter_factory(
        qpnet_serve.get_arguments(argv + ["--noise_shaping"]), "world")
    a, b = factory(), factory()
    assert isinstance(a, StreamingEmphasizer) and a is not b
