"""Streaming synthesis serving: batch concurrent requests into one kernel,
ported from `qpnet_tpu/serve.py`.

  * `StreamingService.submit(h, d)` enqueues one utterance's conditioning
    (frame-rate aux features and dilation factors, the contract of
    `bin/qpnet_decode`) and returns a `StreamHandle` whose `chunks()`
    iterator yields mu-law sample chunks as the card generates them;
  * a scheduler thread per device keeps one running session: an idle
    device gathers co-batchable requests — dispatching as soon as arrivals
    go quiet (`gather_quiet_s`), the group is full, or the oldest request
    has waited `gather_window_s` — and starts a `StreamingGenerator`
    session of the group's power-of-two bucket (so each device keeps
    O(log max_streams) sessions); at each feed boundary of a running
    session the rows whose stream is complete or cancelled are freed, and
    every pending request joins in a free row, up to `max_streams` rows,
    primed at the session's step; the rows move to another bucket where
    their count needs one.  Each row feeds its own stream from its own
    frame, padded past its end by repeating its last frame, and each
    stream's output is trimmed to its own length;
  * `serve_tcp()` exposes the service over a length-prefixed TCP protocol
    (one connection per utterance, int16 PCM chunks back), byte for byte
    the JAX package's, so either package's client talks to either server.

The synthesis is `StreamingGenerator`'s: on a CUDA device, the generation
kernel (bf16 or w8a8); on a CPU device, its plain twin.

Spans (`utils.profiler`), those of one stream tagged with its handle's
`rid`: serve.queue from `submit` to its cohort (`joined`: into a running
session) and a serve.write a chunk on its connection's thread; the
scheduler's serve.gather (its idle device holding a request, or a take at
a boundary), a serve.group a cohort (the streams that enter at one
dispatch or one boundary, to the end of the last of them) with
serve.session_build, and a serve.feed a feed.  Counters: serve.joined
(streams that joined a running session), serve.bucket_moves,
serve.session_builds.
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import socketserver
import struct
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models.generate import (StreamingGenerator,
                                             check_streaming_quantize)
from qpnet_tpu_torch.models.qpnet import resolve_device
from qpnet_tpu_torch.ops.mulaw import decode_mu_law
from qpnet_tpu_torch.utils import profiler


class StreamHandle:
    """Per-request output stream: an iterator of (n,) int32 mu-law chunks.
    `rid` tags the request's spans in `utils.profiler`."""

    def __init__(self, n_samples: int, rid: int):
        self.n_samples = n_samples
        self.rid = rid
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue()
        self.error: Optional[Exception] = None
        self._cancelled = threading.Event()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self):
        """Abandon the stream (e.g. the client disconnected).  The scheduler
        stops emitting chunks for it and frees its row at the next feed
        boundary; once no row is live and none is pending, the session's
        kernel loop stops.  Safe from any thread, idempotent, and valid at
        any stage (pending requests are dropped before they are grouped)."""
        self._cancelled.set()
        self._q.put(None)                            # unblock a reader

    def chunks(self):
        while True:
            if self.cancelled:
                return
            item = self._q.get()
            if item is None:
                if self.error is not None:
                    raise self.error
                return
            yield item

    def samples(self) -> np.ndarray:
        """Block until done, return the full utterance."""
        return np.concatenate(list(self.chunks()))


class _Request:
    def __init__(self, h: np.ndarray, d: np.ndarray, up: int, rid: int):
        self.h = np.asarray(h, np.float32)          # (F, n_aux)
        self.d = np.asarray(d, np.float32)          # (F,)
        self.handle = StreamHandle(self.h.shape[0] * up, rid)
        self.queued: Optional[profiler.Open] = None  # span serve.queue
        self.t_arrival = 0.0                        # perf_counter seconds
        self.frame = 0                              # frames fed so far
        self.cohort: Optional["_Cohort"] = None     # while it streams


class StreamingService:
    """Batched streaming synthesis over one model.

    max_streams: most streams (rows) one session serves.  gather_window_s:
    the cap on how long any request waits for co-batchable traffic; an idle
    device dispatches once arrivals stop for gather_quiet_s (default
    window / 10).  maxd: dilation-factor bucket of the sessions; submit()
    rejects conditioning above it.  devices: torch devices to spread groups
    over, each with its own scheduler thread and sessions (default: the
    first CUDA device; a CPU device runs the kernel's plain twin).
    max_pending: submit() raises once this many requests are queued (None:
    unbounded).  postfilter_factory: returns a per-stream stateful filter
    with a `.process(float_wav_chunk)` method, which the TCP handler applies
    after mu-law decoding and before the int16 PCM (e.g.
    dsp.emphasis.StreamingEmphasizer, the recipe's noise-restoration
    filter, applied while streaming).
    """

    def __init__(self, params, cfg: ModelConfig, max_streams: int = 64,
                 maxd: int = 32, gather_window_s: float = 0.05,
                 gather_quiet_s: Optional[float] = None,
                 mode: str = "sampling", seed: int = 100,
                 min_chunk_samples: int = 5500,
                 first_chunk_samples: int = 0, quantize: str = "none",
                 frontend: Optional[Callable[
                     [np.ndarray], Tuple[np.ndarray, np.ndarray]]] = None,
                 devices: Optional[List] = None,
                 max_pending: Optional[int] = None,
                 postfilter_factory: Optional[Callable[[], object]] = None):
        check_streaming_quantize(quantize)
        self.params, self.cfg = params, cfg
        self.frontend = frontend
        self.postfilter_factory = postfilter_factory
        self.quantize = quantize
        self.max_streams = max_streams
        self.maxd, self.mode, self.seed = maxd, mode, seed
        self.gather_window_s = gather_window_s
        self.gather_quiet_s = (gather_quiet_s if gather_quiet_s is not None
                               else gather_window_s / 10.0)
        self._last_arrival = 0.0
        self.min_chunk_samples = min_chunk_samples
        # > 0: each group's first chunk is this short (rounded up to whole
        # frames), which brings the first audio forward
        self.first_chunk_samples = first_chunk_samples
        self.max_pending = max_pending
        self._pending: List[_Request] = []
        self._cv = threading.Condition()
        self._closed = False
        self._groups = 0
        # kernel feeds run / streams fully served / streams cancelled
        self.stats = {"groups": 0, "feeds": 0, "streams_done": 0,
                      "streams_cancelled": 0}
        # one scheduler thread per device, each with its own sessions (B
        # bucket -> session), kept on the service so prewarm() can build
        # them before traffic arrives
        self._devices = [resolve_device(d) for d in (devices or ["cuda"])]
        self._sessions: List[dict] = [{} for _ in self._devices]
        self._threads = [
            threading.Thread(target=self._scheduler, args=(dev, sess_map),
                             daemon=True)
            for dev, sess_map in zip(self._devices, self._sessions)]
        for t in self._threads:
            t.start()

    def _make_session(self, B: int, device) -> StreamingGenerator:
        return StreamingGenerator(
            self.params, self.cfg, B=B, maxd=self.maxd, seed=self.seed,
            mode=self.mode, min_chunk_samples=self.min_chunk_samples,
            quantize=self.quantize, device=device)

    def prewarm(self, buckets: Optional[List[int]] = None):
        """Build the sessions for the given group sizes before traffic
        arrives: weight packing, the CUDA library's build and load, and one
        feed of each chunk length the schedule uses.  Each size is rounded
        up to its power-of-two session bucket (default: `max_streams`).
        Runs on the calling thread, once per device."""
        up = self.cfg.upsampling_factor
        sizes = sorted({1 << (max(1, b) - 1).bit_length()
                        for b in (buckets or [self.max_streams])})
        for sess_map, device in zip(self._sessions, self._devices):
            for B in sizes:
                if B in sess_map:
                    continue
                sess = self._make_session(B, device)
                shapes = [sess.chunk_frames]
                if self.first_chunk_samples > 0:
                    shapes.insert(0, max(1, -(-self.first_chunk_samples
                                              // up)))
                for F in shapes:
                    sess.feed(np.zeros((B, F, self.cfg.n_aux), np.float32),
                              np.ones((B, F), np.float32))
                sess_map[B] = sess

    def submit(self, h: np.ndarray, d: np.ndarray) -> StreamHandle:
        """h: (F, n_aux) standardized aux frames; d: (F,) dilation factors
        (already F0-scaled as in qpnet_decode).  Returns the output handle
        at once.  Raises RuntimeError when the service is closed or
        `max_pending` requests are already queued.  The handle's `rid` tags
        the request's spans; its wait in the queue is the span serve.queue."""
        h = np.asarray(h, np.float32)
        d = np.asarray(d, np.float32)
        if h.ndim != 2 or h.shape[1] != self.cfg.n_aux:
            raise ValueError(f"h must be (F, {self.cfg.n_aux}), "
                             f"got {h.shape}")
        if h.shape[0] == 0:
            raise ValueError("empty conditioning (0 frames)")
        if d.shape != (h.shape[0],):
            raise ValueError(f"d must be ({h.shape[0]},), got {d.shape}")
        if float(d.max(initial=0.0)) > self.maxd:
            raise ValueError(f"dilation factor {float(d.max()):.1f} exceeds "
                             f"the service maxd={self.maxd}")
        req = _Request(h, d, self.cfg.upsampling_factor, profiler.new_rid())
        with self._cv:
            if self._closed:
                raise RuntimeError("service is closed")
            if (self.max_pending is not None
                    and len(self._pending) >= self.max_pending):
                raise RuntimeError(
                    f"service overloaded: {len(self._pending)} requests "
                    f"already queued (max_pending={self.max_pending})")
            req.queued = profiler.begin("serve.queue", rid=req.handle.rid)
            req.t_arrival = req.queued.t0_ns / 1e9
            self._last_arrival = req.t_arrival
            self._pending.append(req)
            self._cv.notify()
        return req.handle

    def submit_raw(self, feats: np.ndarray) -> StreamHandle:
        """Submit unstandardized aux features (F, n_aux), the h5 contract of
        `bin/qpnet_decode`; the service's `frontend` maps them to
        (standardized h, frame-rate d)."""
        if self.frontend is None:
            raise RuntimeError(
                "service has no feature frontend; construct it with "
                "frontend= or submit standardized (h, d) via submit()")
        h, d = self.frontend(np.asarray(feats, np.float64))
        return self.submit(h, d)

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for t in self._threads:
            t.join()

    # ---- scheduler ----

    def _take(self, room: int, joined: bool) -> Tuple[int, List[_Request]]:
        """Under `_cv`: drop the cancelled pending requests and take up to
        `room` of the rest, oldest first, as one cohort: (group index,
        requests).  Their serve.queue spans end with the index and whether
        they join a running session."""
        # requests cancelled while queued never reach a kernel
        live = [r for r in self._pending if not r.handle.cancelled]
        for r in self._pending:
            if r.handle.cancelled:
                profiler.end(r.queued, cancelled=True)
        self.stats["streams_cancelled"] += len(self._pending) - len(live)
        group = live[:room]
        self._pending = live[len(group):]
        gidx = self._groups
        if group:
            self._groups += 1
        for r in group:
            profiler.end(r.queued, group=gidx, joined=joined)
        return gidx, group

    def _take_group(self) -> Optional[Tuple[int, List[_Request]]]:
        """(group index, requests), or None once closed and drained.  The
        span serve.gather is the time this idle device held a pending
        request before dispatching."""
        with self._cv:
            # This thread being here means its device is idle: dispatch when
            # the group is full, arrivals went quiet for gather_quiet_s, the
            # oldest request has waited gather_window_s, or the service is
            # closing.  Threads of other devices race on the same queue, so
            # emptiness is checked again after every wait.
            gather = None
            while True:
                while not self._pending and not self._closed:
                    gather = None                     # another device took it
                    self._cv.wait()
                if not self._pending:
                    return None                       # closed and drained
                if gather is None:
                    gather = profiler.begin("serve.gather")
                if self._closed or len(self._pending) >= self.max_streams:
                    break
                now = time.perf_counter()
                deadline = min(
                    self._pending[0].t_arrival + self.gather_window_s,
                    self._last_arrival + self.gather_quiet_s)
                if deadline <= now:
                    break
                self._cv.wait(deadline - now)
            gidx, group = self._take(self.max_streams, joined=False)
            profiler.end(gather, group=gidx, streams=len(group))
            return gidx, group

    def _scheduler(self, device, sessions):
        run = _Running(sessions, device)
        while True:
            taken = self._take_group()
            if taken is None:
                return
            gidx, group = taken
            if not group:                            # all arrivals cancelled
                continue
            try:
                self._run_group(group, run, gidx)
                self._stream(run)
            except Exception as e:  # noqa: BLE001 — report to all clients
                logging.exception("stream session failed")
                for c in run.cohorts:
                    for req in c.reqs:
                        if req.cohort is not None:   # not ended yet
                            req.handle.error = e
                            req.handle._q.put(None)
                    profiler.end(c.span, error=True)
                run.clear()

    def _bucket(self, run: "_Running", n: int) -> int:
        """The session bucket for n rows: the power of two at or above n.
        A running session moves down only to a bucket that is built
        already: building one would stall every live row to save a few
        microseconds a step."""
        B = 1 << (n - 1).bit_length()
        if run.gen is not None and B < run.gen.B and B not in run.gens:
            return run.gen.B
        return B

    def _session(self, run: "_Running", B: int,
                 parent) -> StreamingGenerator:
        """The device's session of bucket B, built (the span
        serve.session_build, under `parent`) where prewarm() missed it."""
        sess = run.gens.get(B)
        if sess is None:
            profiler.count("serve.session_builds")
            with profiler.span("serve.session_build", parent=parent,
                               bucket=B):
                sess = self._make_session(B, run.device)
            run.gens[B] = sess
        return sess

    def _move(self, run: "_Running", B: int, parent) -> None:
        """Move the live rows to the session of bucket B, compacted to its
        first rows in their order."""
        target = self._session(run, B, parent)
        keep = [i for i, r in enumerate(run.rows) if r is not None]
        run.gen.move_rows(target, keep)
        run.rows = [run.rows[i] for i in keep] + [None] * (B - len(keep))
        run.gen = target
        profiler.count("serve.bucket_moves")

    def _run_group(self, group: List[_Request], run: "_Running", gidx: int):
        """Bring a cohort into the device's session: a fresh session of its
        bucket (seed + gidx) on an idle device, else the running session at
        this feed boundary, in free rows, moving the rows to another bucket
        where the live rows and the cohort need one.  The span serve.group
        runs from here to the end of the cohort's last stream; new rows of
        a running session are primed at the next feed."""
        n = len(run.live()) + len(group)
        B = self._bucket(run, n)
        cohort = _Cohort(group, profiler.begin(
            "serve.group", group=gidx, streams=len(group), bucket=B,
            built=B not in run.gens))
        run.cohorts.append(cohort)
        with self._cv:
            self.stats["groups"] += 1
        if run.gen is None:
            run.gen = self._session(run, B, cohort.span)
            # the packed weights stay; fresh rings and a seed of its own
            run.gen.reset(seed=self.seed + gidx)
            run.rows = list(group) + [None] * (B - len(group))
            if self.first_chunk_samples > 0:
                # a short first chunk (whole frames) brings the first audio
                # forward
                run.first = min(max(r.h.shape[0] for r in group),
                                max(1, -(-self.first_chunk_samples
                                         // self.cfg.upsampling_factor)))
            return
        profiler.count("serve.joined", len(group))
        if B != run.gen.B:
            self._move(run, B, cohort.span)
        free = [i for i, r in enumerate(run.rows) if r is None]
        for i, r in zip(free, group):
            run.rows[i] = r
            run.unprimed.append(i)

    def _stream(self, run: "_Running"):
        """Feed the device's session until no row is live and no request is
        pending.  Each feed runs nominal chunks (a fresh session's first
        one may be short) from each row's own frame; at each boundary the
        rows whose stream is complete or cancelled are freed, and the
        pending requests join (`_run_group`) up to max_streams rows.  The
        span serve.feed a feed, under the newest cohort still streaming
        (index: that cohort's feeds before it)."""
        up = self.cfg.upsampling_factor
        while True:
            L, run.first = run.first or run.gen.chunk_frames, None
            cohort = run.cohorts[-1]
            with profiler.span("serve.feed", parent=cohort.span,
                               index=cohort.feeds, frames=L):
                if run.unprimed:
                    run.gen.prime_rows(run.unprimed, np.stack(
                        [run.rows[i].h[0] for i in run.unprimed]))
                    run.unprimed = []
                out = run.gen.feed(*self._block(run.rows, L))
            cohort.feeds += 1
            for i, r in enumerate(run.rows):
                if r is None:
                    continue
                take = min(r.h.shape[0] - r.frame, L) * up
                if not r.handle.cancelled:
                    r.handle._q.put(out[i, :take].copy())
                r.frame += L
            ended = []
            with self._cv:
                self.stats["feeds"] += 1
                for i, r in enumerate(run.rows):
                    if r is not None and (r.handle.cancelled
                                          or r.frame >= r.h.shape[0]):
                        self.stats["streams_cancelled" if r.handle.cancelled
                                   else "streams_done"] += 1
                        run.rows[i] = None
                        ended.append(r)
                room = self.max_streams - len(run.live())
                joined = []
                if room > 0 and self._pending:
                    gather = profiler.begin("serve.gather")
                    gidx, joined = self._take(room, joined=True)
                    if joined:
                        profiler.end(gather, group=gidx,
                                     streams=len(joined))
            for r in ended:
                r.handle._q.put(None)
                run.end(r)
            if joined:
                self._run_group(joined, run, gidx)
                continue
            if not run.live():
                run.clear()
                return
            B = self._bucket(run, len(run.live()))
            if B != run.gen.B:
                self._move(run, B, run.cohorts[-1].span)

    def _block(self, rows: List[Optional[_Request]], L: int):
        """A feed's (h (B, L, n_aux), d (B, L)): L frames of each row's
        stream from its own frame, repeat-last padding past the stream's
        end, free rows zero."""
        B = len(rows)
        h_blk = np.zeros((B, L, self.cfg.n_aux), np.float32)
        d_blk = np.ones((B, L), np.float32)
        for i, r in enumerate(rows):
            if r is None:
                continue
            sl = r.h[r.frame: r.frame + L]
            h_blk[i, : len(sl)] = sl
            d_blk[i, : len(sl)] = r.d[r.frame: r.frame + L]
            h_blk[i, len(sl):] = sl[-1]              # repeat-last padding
            d_blk[i, len(sl):] = r.d[r.frame + len(sl) - 1]
        return h_blk, d_blk


class _Cohort:
    """The streams that enter a session at one dispatch or one feed
    boundary, and their span serve.group."""

    def __init__(self, reqs: List[_Request], span: profiler.Open):
        self.reqs, self.span = reqs, span
        self.left = len(reqs)                       # streams still running
        self.feeds = 0                              # feeds it parents
        for r in reqs:
            r.cohort = self


class _Running:
    """A device's running session: the StreamingGenerator of its bucket
    (`gens`: the device's sessions, bucket -> generator), a request or None
    a row, the cohorts still streaming (oldest first), the rows to prime
    before the next feed and a fresh session's short first chunk."""

    def __init__(self, gens: dict, device):
        self.gens, self.device = gens, device
        self.gen: Optional[StreamingGenerator] = None
        self.rows: List[Optional[_Request]] = []
        self.cohorts: List[_Cohort] = []
        self.unprimed: List[int] = []
        self.first: Optional[int] = None

    def live(self) -> List[_Request]:
        return [r for r in self.rows if r is not None]

    def end(self, req: _Request) -> None:
        """A stream has ended: its cohort's span ends with its last."""
        c, req.cohort = req.cohort, None
        c.left -= 1
        if c.left == 0:
            profiler.end(c.span)
            self.cohorts.remove(c)

    def clear(self) -> None:
        """The device is idle again: the session drops its state."""
        if self.gen is not None:
            self.gen.reset()
        self.gen, self.rows, self.cohorts, self.unprimed = None, [], [], []
        self.first = None


# ---------------------------------------------------------------------------
# TCP transport
# ---------------------------------------------------------------------------
#
# Wire protocol (one utterance per connection), the JAX package's:
#   client -> server: one JSON line {"frames": F} + F*n_aux f32 (h) + F f32
#                     (d), little-endian.  With {"frames": F, "raw": true}
#                     the payload is F*n_aux f32 of unstandardized aux
#                     features and the server's frontend derives (h, d).
#   server -> client: repeated [u32 n][n x int16 PCM]; n=0 terminates.  On a
#                     rejected request the server sends the sentinel u32
#                     0xFFFFFFFF and one JSON line {"error": ...} instead.
#   health/stats:     a header of {"stats": true} (no payload) gets one JSON
#                     line back — {"ok": true, "pending": N, "devices": D,
#                     ...service counters} — and the connection closes.

_ERR_SENTINEL = 0xFFFFFFFF

# cap on the frame count the server sizes reads for; a negative or absurd
# count is rejected before the handler blocks on a payload
_MAX_WIRE_FRAMES = 2_000_000

# cap on any newline-terminated JSON line on the wire
_MAX_WIRE_LINE = 1 << 16


def _read_exact(rfile, n: int, what: str = "client closed mid-message"
                ) -> bytes:
    """Exact read through a buffered rfile (a prior readline may already
    hold payload bytes in its buffer).  Raises ConnectionError(`what`) on a
    short read."""
    buf = rfile.read(n)
    if len(buf) != n:
        raise ConnectionError(what)
    return buf


def _read_json_line(rfile, what: str) -> dict:
    """Read one bounded, newline-terminated JSON line."""
    line = rfile.readline(_MAX_WIRE_LINE)
    if not line.endswith(b"\n"):
        if len(line) >= _MAX_WIRE_LINE:
            raise ValueError(f"{what} line exceeds {_MAX_WIRE_LINE} bytes")
        raise ConnectionError(f"connection closed mid-{what}")
    return json.loads(line)


class _Handler(socketserver.StreamRequestHandler):
    """One connection; a serve.write a chunk, with its stream's rid."""

    def handle(self):
        svc: StreamingService = self.server.service  # type: ignore[attr-defined]
        cfg = svc.cfg
        try:
            header = _read_json_line(self.rfile, "header")
            if header.get("stats"):
                with svc._cv:
                    body = {"ok": not svc._closed,
                            "pending": len(svc._pending),
                            "devices": len(svc._devices),
                            "max_streams": svc.max_streams,
                            **svc.stats}
                self.wfile.write((json.dumps(body) + "\n").encode())
                return
            F = int(header["frames"])
            if not 0 < F <= _MAX_WIRE_FRAMES:
                raise ValueError(f"frames must be in (0, "
                                 f"{_MAX_WIRE_FRAMES}], got {F}")
            feats = np.frombuffer(
                _read_exact(self.rfile, 4 * F * cfg.n_aux),
                "<f4").reshape(F, cfg.n_aux)
            if header.get("raw"):
                handle = svc.submit_raw(feats)
            else:
                d = np.frombuffer(_read_exact(self.rfile, 4 * F), "<f4")
                handle = svc.submit(feats, d)
        except Exception as e:  # noqa: BLE001 — reported to the client
            try:
                self.wfile.write(
                    struct.pack("<I", _ERR_SENTINEL)
                    + (json.dumps({"error": str(e)}) + "\n").encode())
            except OSError:
                pass                                 # client already gone
            return
        postfilter = (svc.postfilter_factory()
                      if svc.postfilter_factory else None)
        try:
            for k, chunk in enumerate(handle.chunks()):
                with profiler.span("serve.write", rid=handle.rid,
                                   first=k == 0):
                    wav = decode_mu_law(chunk, cfg.n_quantize)
                    if postfilter is not None:       # e.g. noise restoration
                        wav = postfilter.process(wav)
                    pcm = np.clip(wav * 32768, -32768, 32767).astype("<i2")
                    self.wfile.write(struct.pack("<I", len(pcm))
                                     + pcm.tobytes())
            self.wfile.write(struct.pack("<I", 0))
        except OSError:
            # the client hung up mid-stream: stop generating for it
            handle.cancel()


class StreamServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    # a burst of max_streams simultaneous connects must not overflow the
    # listen backlog (the default of 5 drops clients)
    request_queue_size = 128

    def __init__(self, service: StreamingService, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__((host, port), _Handler)
        self.service = service


def serve_tcp(service: StreamingService, host: str = "127.0.0.1",
              port: int = 8765) -> StreamServer:
    """Start the TCP front end in a daemon thread; returns the server (its
    .server_address has the bound port; .shutdown() stops it)."""
    srv = StreamServer(service, host, port)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def request_stats(address) -> dict:
    """Client helper: the {"stats": true} probe; returns the server's JSON
    status.  Raises RuntimeError with the server's error body if it
    rejected the probe."""
    with socket.create_connection(address) as s:
        s.sendall(json.dumps({"stats": True}).encode() + b"\n")
        rfile = s.makefile("rb")
        head = _read_exact(rfile, 4, "server closed mid-stats")
        if struct.unpack("<I", head)[0] == _ERR_SENTINEL:
            raise RuntimeError(_read_json_line(rfile, "error")["error"])
        line = head + rfile.readline(_MAX_WIRE_LINE - 4)
        if not line.endswith(b"\n"):
            raise ConnectionError("connection closed mid-stats")
        return json.loads(line)


def request_stream(address, h: np.ndarray, d: Optional[np.ndarray] = None):
    """Client helper: send one utterance, yield int16 PCM chunks.

    With `d` given, `h` is standardized conditioning (the submit()
    contract); without, `h` is raw aux features sent with "raw": true for
    the server's frontend.  Raises RuntimeError on a server-side
    rejection."""
    h = np.ascontiguousarray(h, "<f4")
    header = {"frames": int(h.shape[0])}
    payload = h.tobytes()
    if d is None:
        header["raw"] = True
    else:
        payload += np.ascontiguousarray(d, "<f4").tobytes()
    with socket.create_connection(address) as s:
        s.sendall(json.dumps(header).encode() + b"\n" + payload)
        rfile = s.makefile("rb")
        while True:
            hdr = _read_exact(rfile, 4, "server closed mid-stream")
            n = struct.unpack("<I", hdr)[0]
            if n == _ERR_SENTINEL:
                raise RuntimeError(
                    _read_json_line(rfile, "error")["error"])
            if n == 0:
                return
            yield np.frombuffer(
                _read_exact(rfile, 2 * n, "server closed mid-chunk"),
                "<i2")
