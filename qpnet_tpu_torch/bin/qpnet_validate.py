"""Validation worker: the teacher-forced cross-entropy of one checkpoint over
a validation set (one pass, no shuffle, no gradients), appended as
{checkpoint name: mean loss} to `<resultdir>/validation_result.yml`, so the
best speaker-adaptation iteration can be picked.  Same argv as
`qpnet_tpu.bin.qpnet_validate`, plus --device; either package extends the
other's file.

  python -m qpnet_tpu_torch.bin.qpnet_validate --waveforms <dir|list> \\
      --feats <dir|list> --stats stats.h5 --resultdir exp \\
      --config exp/model.conf --checkpoint exp/checkpoint-1000.pkl
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Iterable, List, Tuple

import numpy as np

from qpnet_tpu_torch.config import ModelConfig, RunConfig
from qpnet_tpu_torch.utils import set_loglevel

RESULT_FILE = "validation_result.yml"


def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--waveforms", required=True, type=str)
    parser.add_argument("--feats", required=True, type=str)
    parser.add_argument("--stats", required=True, type=str)
    parser.add_argument("--resultdir", required=True, type=str)
    parser.add_argument("--config", required=True, type=str)
    parser.add_argument("--checkpoint", required=True, type=str)
    parser.add_argument("--batch_length", default=20000, type=int)
    parser.add_argument("--batch_size", default=1, type=int)
    parser.add_argument("--max_length", default=30000, type=int)
    parser.add_argument("--f0_threshold", default=0, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--n_gpus", default=1, type=int,
                        help="accepted for CLI parity")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--verbose", default=1, type=int)
    return parser.parse_args(argv)


def validation_loss(params, cfg: ModelConfig, batches: Iterable[dict],
                    device="cuda") -> Tuple[float, List[float]]:
    """(mean, per-batch losses) of `make_eval_step` (f32) over an iterable
    of the batcher's numpy batches; the mean of no batch is nan."""
    from qpnet_tpu_torch.train.step import batch_to_device, make_eval_step
    eval_step = make_eval_step(cfg)
    losses = []
    for batch in batches:
        batch = {k: v for k, v in batch.items() if k != "window_lens"}
        losses.append(float(eval_step(params, batch_to_device(batch,
                                                               device))))
    return (float(np.mean(losses)) if losses else float("nan")), losses


def record_result(resultdir: str, name: str, loss: float) -> str:
    """Add {name: loss} to resultdir/validation_result.yml; returns its
    path."""
    from qpnet_tpu_torch.utils.yamlconf import (read_validation_record,
                                                write_validation_record)
    os.makedirs(resultdir, exist_ok=True)
    path = os.path.join(resultdir, RESULT_FILE)
    results = read_validation_record(path) if os.path.exists(path) else {}
    results[name] = loss
    write_validation_record(path, results)
    return path


def main(argv=None):
    args = get_arguments(argv)
    set_loglevel(args.verbose)
    from qpnet_tpu_torch.models.qpnet import params_from_numpy, resolve_device
    device = resolve_device(args.device)
    for key, value in vars(args).items():
        logging.info("%s = %s", key, str(value))

    from qpnet_tpu_torch.bin.qpnet_train import resolve_lists
    from qpnet_tpu_torch.data.batcher import train_window_generator
    from qpnet_tpu_torch.data.stats import load_scaler
    from qpnet_tpu_torch.train.checkpoint import load_checkpoint

    run_cfg = RunConfig.load(args.config)
    cfg = run_cfg.model
    params = params_from_numpy(load_checkpoint(args.checkpoint)["model"],
                               device)
    args.feature_format = run_cfg.feature_format
    wav_list, feat_list = resolve_lists(args)
    logging.info("number of validation data = %d.", len(wav_list))
    scaler = load_scaler(args.stats, run_cfg.feature_type)
    batches = train_window_generator(
        wav_list, feat_list, cfg, feat_transform=scaler.transform,
        feature_type=run_cfg.feature_type, batch_length=args.batch_length,
        batch_size=args.batch_size, max_length=args.max_length,
        f0_threshold=args.f0_threshold, shuffle=False, loop=False)
    mean_loss, losses = validation_loss(params, cfg, batches, device)
    logging.info("validation loss = %.6f over %d batches", mean_loss,
                 len(losses))
    path = record_result(args.resultdir, os.path.basename(args.checkpoint),
                         mean_loss)
    logging.info("wrote %s", path)


if __name__ == "__main__":
    main()
