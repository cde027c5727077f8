"""Batch AR decoding worker: sorts utterances by feature length, batches
them, seeds with a single mu-law zero, optionally scales F0 (recomputing the
pitch-dependent dilation factors from the scaled track), generates through
the CUDA generation kernel or the scan engine (--engine, --quantize,
--dtype), then mu-law-decodes and writes int16 wavs into the `feat_id` path
template.  Same argv as `qpnet_tpu.bin.qpnet_decode`, plus --device and
--trace_dir (a torch.profiler trace of the decoding, the port's spans
beside the card's kernels, for a short list: it keeps every kernel).
--n_devices N shards each batch over the first N cards (one thread per
card; through the kernel the output equals one card's bit for bit,
through the scan engine on cards only to rounding), and
--n_hosts/--host_id give each host (process) its strided slice of the
list.

  python -m qpnet_tpu_torch.bin.qpnet_decode --feats <dir|list> \\
      --stats stats.h5 --config model.conf --checkpoint checkpoint-final.pkl \\
      --outdir out/feat_id.wav --batch_size 20
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import math
import os
import sys

import numpy as np
from scipy.io import wavfile

from qpnet_tpu_torch.config import RunConfig
from qpnet_tpu_torch.data import find_files, read_hdf5, read_txt, shape_hdf5
from qpnet_tpu_torch.data.stats import load_scaler
from qpnet_tpu_torch.ops import decode_mu_law, dilated_factor, encode_mu_law
from qpnet_tpu_torch.utils import profiler, set_loglevel


def strtobool(v: str) -> bool:
    return str(v).lower() in ("y", "yes", "t", "true", "on", "1")


def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--feats", required=True, type=str)
    parser.add_argument("--stats", required=True, type=str)
    parser.add_argument("--config", required=True, type=str)
    parser.add_argument("--outdir", required=True, type=str,
                        help="output path template containing feat_id")
    parser.add_argument("--checkpoint", required=True, type=str)
    parser.add_argument("--fs", default=22050, type=int)
    parser.add_argument("--batch_size", default=1, type=int,
                        help="utterances per kernel call (reference "
                             "default 20); 0 = the whole sorted set")
    parser.add_argument("--extra_memory", default=False, type=strtobool,
                        help="accepted for CLI parity (no effect)")
    parser.add_argument("--intervals", default=1000, type=int)
    parser.add_argument("--seed", default=100, type=int)
    parser.add_argument("--n_gpus", default=1, type=int,
                        help="accepted for CLI parity")
    parser.add_argument("--n_devices", default=1, type=int,
                        help="cards to shard each batch over (the first "
                             "n_devices of --device's type)")
    parser.add_argument("--n_hosts", default=1, type=int,
                        help="multi-host fan-out: each process decodes "
                             "feat_list[host_id::n_hosts]")
    parser.add_argument("--host_id", default=0, type=int,
                        help="this process's index in [0, n_hosts)")
    parser.add_argument("--engine", default="auto",
                        choices=["auto", "pallas", "xla"],
                        help="pallas: the CUDA generation kernel (bf16 or "
                             "w8a8); xla: the scan engine, plain PyTorch "
                             "step by step in --dtype (float32 is the "
                             "parity mode), which also takes d varying "
                             "within frames and int8_weights; auto: the "
                             "kernel, or the scan where only it applies")
    parser.add_argument("--quantize", default="none",
                        choices=["none", "w8a8", "int8_weights"],
                        help="none: bf16 in the kernel, --dtype in the "
                             "scan; w8a8: the kernel with int8 W_in/W_out "
                             "and dynamic int8 activations; int8_weights: "
                             "the scan with int8 W_in/W_out dequantized per "
                             "column (weight-only)")
    parser.add_argument("--verbose", default=1, type=int)
    parser.add_argument("--f0_factor", default=1.0, type=float)
    parser.add_argument("--f0_dim_index", default=1, type=int)
    parser.add_argument("--mode", default="sampling",
                        choices=["sampling", "argmax"])
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"],
                        help="compute precision of the scan engine "
                             "(float32 is the parity mode); the kernel is "
                             "bf16 by construction")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu runs the kernel's plain PyTorch twin")
    parser.add_argument("--trace_dir", default=None, type=str,
                        help="write a Chrome trace of the decoding (host "
                             "ops, kernels and the spans of "
                             "utils.profiler) into this directory")
    return parser.parse_args(argv)


def pad_list(batch_list, pad_value=0.0):
    batch_size = len(batch_list)
    maxlen = max(b.shape[0] for b in batch_list)
    n_feats = batch_list[0].shape[-1]
    out = np.full((batch_size, maxlen, n_feats), pad_value)
    for i, b in enumerate(batch_list):
        out[i, : b.shape[0]] = b
    return out


def decode_batches(feat_list, run_cfg, args, scaler):
    """Yield (feat_ids, x, h, n_samples_list, d) batches, sorted by length
    and zero-padded."""
    cfg = run_cfg.model
    up = cfg.upsampling_factor
    feature_type = run_cfg.feature_type
    shapes = [shape_hdf5(f, "/" + feature_type)[0] for f in feat_list]
    order = np.argsort(shapes)
    feat_list = [feat_list[i] for i in order]
    n_batch = (1 if args.batch_size <= 0
               else math.ceil(len(feat_list) / args.batch_size))
    for batch_files in np.array_split(feat_list, n_batch):
        batch_h, batch_d, feat_ids, n_samples = [], [], [], []
        for featfile in batch_files:
            h = read_hdf5(featfile, "/" + feature_type).astype(np.float64)
            h[:, args.f0_dim_index] *= args.f0_factor
            d = dilated_factor(
                np.ascontiguousarray(h[:, args.f0_dim_index]),
                args.fs, cfg.dense_factor)
            d = np.repeat(d, up)
            h = scaler.transform(h)
            batch_h.append(h)
            batch_d.append(d[:, None])
            feat_ids.append(os.path.basename(featfile).rsplit(".", 1)[0])
            n_samples.append(h.shape[0] * up - 1)
        h_pad = pad_list(batch_h).astype(np.float32)
        d_pad = pad_list(batch_d)[:, :, 0].astype(np.float32)
        B = len(feat_ids)
        x = np.full((B, 1),
                    int(encode_mu_law(np.zeros(1), cfg.n_quantize)[0]),
                    np.int32)
        yield feat_ids, x, h_pad, n_samples, d_pad


def main(argv=None):
    args = get_arguments(argv)
    set_loglevel(args.verbose)
    mesh = None
    if args.n_devices > 1:
        from qpnet_tpu_torch.parallel import make_mesh
        mesh = make_mesh(args.n_devices, args.device)
    for key, value in vars(args).items():
        logging.info("%s = %s", key, str(value))
    outdir_is_dir = "feat_id" not in os.path.basename(args.outdir)
    if outdir_is_dir:
        logging.info("--outdir has no feat_id placeholder in its filename; "
                     "writing %s/<feat_id>.wav", args.outdir)

    def wav_path(feat_id):
        if outdir_is_dir:
            return os.path.join(args.outdir, feat_id + ".wav")
        return args.outdir.replace("feat_id", feat_id)

    outdir_parent = args.outdir if outdir_is_dir \
        else os.path.dirname(args.outdir)
    if outdir_parent and not os.path.isdir(outdir_parent):
        os.makedirs(outdir_parent, exist_ok=True)

    run_cfg = RunConfig.load(args.config)
    cfg = run_cfg.model
    feat_ext = ".%s" % run_cfg.feature_format
    if os.path.isdir(args.feats):
        feat_list = sorted(find_files(args.feats, "*%s" % feat_ext))
    elif os.path.isfile(args.feats):
        feat_list = read_txt(args.feats)
    else:
        logging.error("--feats should be directory or list.")
        sys.exit(1)
    logging.info("number of utterances = %d", len(feat_list))
    if args.n_hosts > 1:
        if not 0 <= args.host_id < args.n_hosts:
            logging.error("--host_id must be in [0, n_hosts)")
            sys.exit(1)
        # strided host shard: hosts write disjoint outputs
        feat_list = feat_list[args.host_id::args.n_hosts]
        logging.info("host %d/%d decodes %d utterances",
                     args.host_id, args.n_hosts, len(feat_list))

    import torch

    from qpnet_tpu_torch.models import batch_fast_generate, params_from_numpy
    from qpnet_tpu_torch.models.generate import check_engine
    from qpnet_tpu_torch.train import load_checkpoint

    check_engine(args.engine, args.quantize)  # before any file is read
    ckpt = load_checkpoint(args.checkpoint)
    params = params_from_numpy(ckpt["model"], args.device)
    scaler = load_scaler(args.stats, run_cfg.feature_type)
    if mesh is not None:
        logging.info("decoding over a %d-device mesh", mesh.size)

    with (profiler.trace(args.trace_dir) if args.trace_dir
          else contextlib.nullcontext()):
        for feat_ids, x, h, n_samples, d in decode_batches(
                feat_list, run_cfg, args, scaler):
            logging.info("decoding start! (batch of %d)", len(feat_ids))
            samples_list = batch_fast_generate(
                params, cfg, x, h, n_samples, d, seed=args.seed,
                mode=args.mode, compute_dtype=getattr(torch, args.dtype),
                engine=args.engine, quantize=args.quantize,
                device=args.device, mesh=mesh)
            for feat_id, samples in zip(feat_ids, samples_list):
                wav = decode_mu_law(samples, cfg.n_quantize)
                wav_filename = wav_path(feat_id)
                os.makedirs(os.path.dirname(wav_filename) or ".",
                            exist_ok=True)
                wav = np.clip(wav * 32768, -32768, 32767)
                wavfile.write(wav_filename, args.fs, wav.astype(np.int16))
                logging.info("wrote %s.", wav_filename)


if __name__ == "__main__":
    main()
