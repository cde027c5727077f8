"""Streaming synthesis serving: batch concurrent requests into one kernel,
ported from `qpnet_tpu/serve.py`.

  * `StreamingService.submit(h, d)` enqueues one utterance's conditioning
    (frame-rate aux features and dilation factors, the contract of
    `bin/qpnet_decode`) and returns a `StreamHandle` whose `chunks()`
    iterator yields mu-law sample chunks as the card generates them;
  * a scheduler thread per device gathers co-batchable requests —
    dispatching as soon as arrivals go quiet (`gather_quiet_s`), the group
    is full, or the oldest request has waited `gather_window_s` — groups up
    to `max_streams` of them, pads the group's batch to a power of two (so
    each device keeps O(log max_streams) sessions), and streams the whole
    group through one `StreamingGenerator` session; conditioning shorter
    than the group's longest is padded by repeating its last frame and each
    stream's output is trimmed to its own length;
  * `serve_tcp()` exposes the service over a length-prefixed TCP protocol
    (one connection per utterance, int16 PCM chunks back), byte for byte
    the JAX package's, so either package's client talks to either server.

The synthesis is `StreamingGenerator`'s: on a CUDA device, the generation
kernel (bf16 or w8a8); on a CPU device, its plain twin.

Spans (`utils.profiler`), those of one stream tagged with its handle's
`rid`: serve.queue from `submit` to its group and a serve.write a chunk on
its connection's thread; the scheduler's serve.gather (its idle device
holding a request), and serve.group with serve.session_build and a
serve.feed a feed.
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
        stops emitting chunks for it, and once every stream in its group is
        cancelled or complete the group's kernel loop stops early.  Safe
        from any thread, idempotent, and valid at any stage (pending
        requests are dropped before they are grouped)."""
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


class StreamingService:
    """Batched streaming synthesis over one model.

    max_streams: largest group one session serves.  gather_window_s: the
    cap on how long any request waits for co-batchable traffic; an idle
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
            # requests cancelled while queued never reach a kernel
            live = [r for r in self._pending if not r.handle.cancelled]
            for r in self._pending:
                if r.handle.cancelled:
                    profiler.end(r.queued, cancelled=True)
            self.stats["streams_cancelled"] += (len(self._pending)
                                                - len(live))
            self._pending = live
            group = self._pending[: self.max_streams]
            del self._pending[: len(group)]
            gidx = self._groups
            if group:
                self._groups += 1
            for r in group:
                profiler.end(r.queued, group=gidx)
            profiler.end(gather, group=gidx, streams=len(group))
            return gidx, group

    def _scheduler(self, device, sessions):
        while True:
            taken = self._take_group()
            if taken is None:
                return
            gidx, group = taken
            if not group:                            # all arrivals cancelled
                continue
            try:
                self._run_group(group, sessions, device, gidx)
            except Exception as e:  # noqa: BLE001 — report to all clients
                logging.exception("stream group failed")
                for req in group:
                    req.handle.error = e
                    req.handle._q.put(None)

    def _run_group(self, group: List[_Request], sessions, device,
                   gidx: int):
        """Stream the group through its bucket's session: the span
        serve.group, with a serve.feed a feed."""
        B_real = len(group)
        B = 1 << (B_real - 1).bit_length()          # power-of-two bucket
        with profiler.span("serve.group", group=gidx, streams=B_real,
                           bucket=B, built=B not in sessions):
            cfg = self.cfg
            up = cfg.upsampling_factor
            sess = sessions.get(B)
            if sess is None:
                # prewarm() missed this bucket: the group waits for the build
                profiler.count("serve.session_builds")
                with profiler.span("serve.session_build", bucket=B):
                    sess = self._make_session(B, device)
                sessions[B] = sess
            # the packed weights stay; fresh rings and a seed of its own
            sess.reset(seed=self.seed + gidx)
            Fc = sess.chunk_frames
            F_max = max(r.h.shape[0] for r in group)
            # an optional short first chunk, then nominal chunks
            schedule = []
            if self.first_chunk_samples > 0:
                schedule.append(min(F_max, max(1, -(-self.first_chunk_samples
                                                   // up))))
            start = sum(schedule)
            while start < F_max:
                schedule.append(Fc)
                start += Fc
            done = [0] * B_real                      # samples emitted so far
            start = 0
            with self._cv:
                self.stats["groups"] += 1
            for k, L in enumerate(schedule):
                # once every stream is complete or cancelled, the rest of the
                # schedule is padding: stop and hand the device back
                if all(r.handle.cancelled or done[i] >= r.handle.n_samples
                       for i, r in enumerate(group)):
                    break
                with profiler.span("serve.feed", index=k, frames=L):
                    out = sess.feed(*self._block(group, B, L, start))
                start += L
                with self._cv:
                    self.stats["feeds"] += 1
                for i, r in enumerate(group):
                    if r.handle.cancelled:
                        continue
                    take = min(r.handle.n_samples - done[i], out.shape[1])
                    if take > 0:
                        r.handle._q.put(out[i, :take].copy())
                        done[i] += take
            with self._cv:
                for i, r in enumerate(group):
                    if r.handle.cancelled:
                        self.stats["streams_cancelled"] += 1
                    else:
                        self.stats["streams_done"] += 1
            for r in group:
                r.handle._q.put(None)

    def _block(self, group: List[_Request], B: int, L: int, start: int):
        """A feed's (h (B, L, n_aux), d (B, L)) from frame `start` of each
        stream: repeat-last padding past a stream's end, rows past the
        group's streams zero."""
        h_blk = np.zeros((B, L, self.cfg.n_aux), np.float32)
        d_blk = np.ones((B, L), np.float32)
        for i, r in enumerate(group):
            sl = r.h[start: start + L]
            h_blk[i, : len(sl)] = sl
            d_blk[i, : len(sl)] = r.d[start: start + L]
            if 0 < len(sl) < L:
                h_blk[i, len(sl):] = sl[-1]          # repeat-last padding
                d_blk[i, len(sl):] = r.d[start + len(sl) - 1]
            elif len(sl) == 0:                       # stream already done
                h_blk[i] = r.h[-1]
                d_blk[i] = r.d[-1]
        return h_blk, d_blk


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
