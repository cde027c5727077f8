"""Streaming synthesis server: serve a trained QPNet over TCP.

Loads a checkpoint and the corpus stats, builds the feature frontend (the
`qpnet_decode` conditioning: standardization and pitch-dependent dilation
factors from the F0-scaled track), and serves concurrent clients through one
batched `StreamingService` (qpnet_tpu_torch/serve.py), on the card through
the generation kernel.  Same argv as `qpnet_tpu.bin.qpnet_serve`, plus
--device; clients of either package talk to it (`request_stream`).

  python -m qpnet_tpu_torch.bin.qpnet_serve \\
      --config exp/.../model.conf --stats data/stats.h5 \\
      --checkpoint exp/.../checkpoint-final.pkl --port 8765 --quantize w8a8
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

import numpy as np

from qpnet_tpu_torch.config import RunConfig
from qpnet_tpu_torch.data.stats import load_scaler
from qpnet_tpu_torch.ops import dilated_factor
from qpnet_tpu_torch.utils import set_loglevel

def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, type=str)
    parser.add_argument("--stats", required=True, type=str)
    parser.add_argument("--checkpoint", required=True, type=str)
    parser.add_argument("--host", default="0.0.0.0", type=str)
    parser.add_argument("--port", default=8765, type=int)
    parser.add_argument("--fs", default=22050, type=int)
    parser.add_argument("--f0_dim_index", default=1, type=int)
    parser.add_argument("--f0_factor", default=1.0, type=float)
    parser.add_argument("--maxd", default=32, type=int,
                        help="dilation-factor ceiling of the sessions; "
                             "requests above it are rejected")
    parser.add_argument("--max_streams", default=64, type=int,
                        help="largest concurrent group one session serves")
    parser.add_argument("--n_devices", default=1, type=int,
                        help="spread request groups over cuda:0..N-1, one "
                             "scheduler and session pool per card")
    parser.add_argument("--gather_window_ms", default=50.0, type=float,
                        help="cap on how long any request waits for "
                             "co-batchable traffic after it arrives")
    parser.add_argument("--gather_quiet_ms", default=None, type=float,
                        help="idle devices dispatch once no new request "
                             "arrived for this long (default: "
                             "gather_window_ms/10)")
    parser.add_argument("--chunk_samples", default=5500, type=int,
                        help="minimum samples per streamed chunk (5500 = "
                             "250 ms at 22.05 kHz)")
    parser.add_argument("--first_chunk_samples", default=0, type=int,
                        help=">0: each group's first chunk is this short "
                             "(e.g. 1100 = 50 ms of audio at 22.05 kHz), "
                             "which brings the first audio forward")
    parser.add_argument("--mode", default="sampling",
                        choices=["sampling", "argmax"])
    parser.add_argument("--quantize", default="none",
                        choices=["none", "w8a8"],
                        help="w8a8: int8 W_in/W_out with dynamic int8 "
                             "activations, half the weight bytes of bf16 "
                             "(the JAX package serves the deep "
                             "Rd10Rr3Ed4Er1 network this way)")
    parser.add_argument("--noise_shaping", default=False,
                        action="store_true",
                        help="apply the recipe's noise-restoration filter "
                             "(the corpus-mean MLSA filter of "
                             "noise_restored) to each stream as it plays")
    parser.add_argument("--mcep_dim_start", default=2, type=int)
    parser.add_argument("--mcep_dim_end", default=27, type=int)
    parser.add_argument("--mcep_alpha", default=0.41, type=float)
    parser.add_argument("--mag", default=0.5, type=float)
    parser.add_argument("--shiftms", default=5.0, type=float)
    parser.add_argument("--prewarm", default=None, type=str,
                        help="comma-separated group sizes whose sessions "
                             "are built before the socket opens (e.g. "
                             "'1,8,64'; sizes round up to powers of two)")
    parser.add_argument("--max_pending", default=None, type=int,
                        help="back-pressure: reject new requests once "
                             "this many are queued (default unbounded)")
    parser.add_argument("--seed", default=100, type=int)
    parser.add_argument("--verbose", default=1, type=int)
    parser.add_argument("--interpret", default=False, action="store_true",
                        help="accepted for CLI parity: the same as "
                             "--device cpu")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu runs the kernel's plain PyTorch twin")
    return parser.parse_args(argv)


def make_frontend(scaler, args, cfg):
    """Raw aux features (F, n_aux) float64 -> (standardized h, frame-rate
    d), the conditioning of bin/qpnet_decode.py."""

    def frontend(feats: np.ndarray):
        feats = np.array(feats, np.float64)
        feats[:, args.f0_dim_index] *= args.f0_factor
        d = dilated_factor(
            np.ascontiguousarray(feats[:, args.f0_dim_index]),
            args.fs, cfg.dense_factor)
        h = scaler.transform(feats)
        return h.astype(np.float32), d.astype(np.float32)

    return frontend


def make_postfilter_factory(args, feature_type: str):
    """With --noise_shaping: a factory of per-stream StreamingEmphasizers
    over the stats file's mean mel-cepstrum (noise_restored's direction,
    un-flipped signs); else None."""
    if not args.noise_shaping:
        return None
    from qpnet_tpu_torch.dsp.emphasis import (StreamingEmphasizer,
                                              emphasis_coefs)
    coefs = emphasis_coefs(args.stats, feature_type, args.mcep_dim_start,
                           args.mcep_dim_end, args.mag, invert=False)
    logging.info("noise restoration filter enabled (mcep[%d:%d], mag %.2f, "
                 "alpha %.3f)", args.mcep_dim_start, args.mcep_dim_end,
                 args.mag, args.mcep_alpha)
    return lambda: StreamingEmphasizer(args.fs, coefs, args.mcep_alpha,
                                       shiftms=args.shiftms)


def serve_devices(device: str, n_devices: int) -> list:
    """The devices groups are spread over: cuda:0..n-1, or the CPU."""
    if device == "cpu":
        return ["cpu"] * n_devices
    import torch
    if torch.cuda.device_count() < n_devices:
        raise SystemExit(f"--n_devices {n_devices} > available "
                         f"{torch.cuda.device_count()} CUDA devices")
    return [f"cuda:{i}" for i in range(n_devices)]


def main(argv=None):
    args = get_arguments(argv)
    set_loglevel(args.verbose)
    if args.interpret:
        args.device = "cpu"
    for key, value in vars(args).items():
        logging.info("%s = %s", key, str(value))

    run_cfg = RunConfig.load(args.config)
    cfg = run_cfg.model

    from qpnet_tpu_torch.models import params_from_numpy
    from qpnet_tpu_torch.serve import StreamingService, StreamServer
    from qpnet_tpu_torch.train import load_checkpoint

    devices = serve_devices(args.device, args.n_devices)
    params = params_from_numpy(load_checkpoint(args.checkpoint)["model"],
                               devices[0])
    scaler = load_scaler(args.stats, run_cfg.feature_type)
    service = StreamingService(
        params, cfg, max_streams=args.max_streams, maxd=args.maxd,
        gather_window_s=args.gather_window_ms / 1000.0,
        gather_quiet_s=(None if args.gather_quiet_ms is None
                        else args.gather_quiet_ms / 1000.0),
        mode=args.mode, seed=args.seed,
        min_chunk_samples=args.chunk_samples,
        first_chunk_samples=args.first_chunk_samples,
        quantize=args.quantize, frontend=make_frontend(scaler, args, cfg),
        devices=devices, max_pending=args.max_pending,
        postfilter_factory=make_postfilter_factory(args,
                                                   run_cfg.feature_type))
    if args.prewarm:
        buckets = [int(b) for b in args.prewarm.split(",")]
        logging.info("prewarming session buckets %s ...", buckets)
        service.prewarm(buckets)
        logging.info("prewarm done")
    server = StreamServer(service, args.host, args.port)
    logging.info("serving on %s:%d (max %d streams/session, %d-sample "
                 "chunks, %s)", *server.server_address[:2], args.max_streams,
                 service.min_chunk_samples, ", ".join(map(str, devices)))

    def _term(signum, frame):
        # SIGTERM: stop accepting, then close the service, which drains the
        # groups already queued so in-flight clients get their streams
        logging.info("SIGTERM: draining in-flight streams")
        raise KeyboardInterrupt

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logging.info("shutting down")
    finally:
        server.shutdown()
        service.close()


if __name__ == "__main__":
    main()
