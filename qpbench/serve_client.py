"""The serve cell's load: closed-loop TCP clients in a process of their own.

    python -m qpbench.serve_client <job.json>

Prints "ready", reads one JSON line {"t_start", "t_end", "hold"}
(time.monotonic seconds, which every process of the machine shares) from
standard input, and runs one thread a conversation (`clients` of them).
Each sends its turns' streams over the service's wire protocol (one
connection a stream: a JSON header {"frames": F}, F x A float32 aux, F
float32 dilation factors; back, [u32 n][n int16 PCM] chunks until n = 0, or
0xFFFFFFFF and a JSON error line) and reads each to its end.  The next turn
is sent once the audio has played (from its first sample for as long as it
lasts, or until its last chunk, whichever is later) and the turn's reply
delay has passed (`corpus.schedule`); the first, a reply delay after
t_start.

No stream is sent from the stop on, which is t_end, or with "hold" the
moment a "stop" line arrives.  With "hold" the clients go on past t_end,
and "window_done" is printed once every stream sent before t_end has its
first audio (or `drain_s` after t_end).  At the stop, a stream sent before
t_end is read until its first audio has come (at most `drain_s` longer)
and then closed; one sent later is closed at once.  Writes a pickle of
every stream's record to the job's `out`.  Imports numpy and the standard
library only.
"""

from __future__ import annotations

import json
import pickle
import socket
import struct
import sys
import threading
import time

import numpy as np

from qpbench import corpus

ERR = 0xFFFFFFFF


class _Stop(Exception):
    pass


def _recv(sock, n: int, stop) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            part = sock.recv(n - len(buf))
        except socket.timeout:
            if stop():
                raise _Stop
            continue
        if not part:
            raise ConnectionError("server closed mid-stream")
        buf += part
    return bytes(buf)


class Stop:
    """When the clients stop sending (time.monotonic seconds)."""

    def __init__(self, at: float):
        self.at = at


def one_stream(addr, h, d, rec, t_end, stop_at, drain_s):
    """Send one stream and read it; fills rec."""
    rec["t_send"] = time.monotonic()
    pcm = []

    def stop():
        now = time.monotonic()
        if now < stop_at.at:
            return False
        if rec["t_send"] >= t_end:
            return True
        return rec["t_first"] is not None or now >= stop_at.at + drain_s

    with socket.create_connection(addr) as s:
        s.settimeout(0.1)
        s.sendall(json.dumps({"frames": int(h.shape[0])}).encode() + b"\n"
                  + np.ascontiguousarray(h, "<f4").tobytes()
                  + np.ascontiguousarray(d, "<f4").tobytes())
        try:
            while True:
                n = struct.unpack("<I", _recv(s, 4, stop))[0]
                if n == ERR:
                    rec["err"] = "rejected"
                    return
                if n == 0:
                    rec["t_done"] = time.monotonic()
                    break
                data = _recv(s, 2 * n, stop)
                now = time.monotonic()
                if rec["t_first"] is None:
                    rec["t_first"] = now
                rec["chunks"].append((now, n))
                pcm.append(data)
                if stop():
                    raise _Stop
        except _Stop:
            pass
    rec["n"] = sum(n for _, n in rec["chunks"])
    if rec["n"] == rec["expected"]:
        rec["pcm"] = np.frombuffer(b"".join(pcm), "<i2").copy()


def client(job, c, t_start, t_end, stop_at, out, current, lock):
    cfg, tr = job["cfg"], job["traffic"]
    addr = (job["host"], job["port"])
    up = cfg["upsampling_factor"]
    t_next = t_start + corpus.schedule(cfg, tr, c, 0)[1]
    turn = 0
    while True:
        time.sleep(max(0.0, t_next - time.monotonic()))
        if time.monotonic() >= stop_at.at:
            return
        h, d = corpus.serve_stream(cfg, tr, job["seed"], c, turn)
        rec = {"client": c, "turn": turn, "expected": h.shape[0] * up,
               "t_send": None, "t_first": None, "t_done": None, "n": 0,
               "err": None, "chunks": [], "pcm": None}
        current[c] = rec
        try:
            one_stream(addr, h, d, rec, t_end, stop_at, tr["drain_s"])
        except Exception as e:  # noqa: BLE001 - recorded as a failure
            rec["err"] = f"{type(e).__name__}: {e}"
        with lock:
            out.append(rec)
            current[c] = None
        if rec["err"] is not None or rec["t_done"] is None or \
                rec["t_first"] is None:
            return
        turn += 1
        played = rec["t_first"] + rec["expected"] / corpus.FS
        t_next = max(rec["t_done"], played) + \
            corpus.schedule(cfg, tr, c, turn)[1]


def window_done(current, lock, t_end, drain_s) -> None:
    """Returns once every stream sent before t_end has its first audio or
    has ended, or drain_s after t_end."""
    while time.monotonic() < t_end + drain_s:
        if time.monotonic() >= t_end:
            with lock:
                waiting = [r for r in current.values() if r is not None
                           and r["t_send"] is not None
                           and r["t_send"] < t_end and r["t_first"] is None
                           and r["err"] is None]
            if not waiting:
                return
        time.sleep(0.02)


def main(path: str) -> int:
    with open(path) as f:
        job = json.load(f)
    print("ready", flush=True)
    times = json.loads(sys.stdin.readline())
    t_start, t_end = times["t_start"], times["t_end"]
    stop_at = Stop(float("inf") if times["hold"] else t_end)
    out, current, lock = [], {}, threading.Lock()
    threads = [threading.Thread(target=client, args=(
        job, c, t_start, t_end, stop_at, out, current, lock))
        for c in range(job["traffic"]["clients"])]
    for t in threads:
        t.start()
    if times["hold"]:
        window_done(current, lock, t_end, job["traffic"]["drain_s"])
        print("window_done", flush=True)
        sys.stdin.readline()
        stop_at.at = time.monotonic()
    for t in threads:
        t.join()
    with open(job["out"], "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
