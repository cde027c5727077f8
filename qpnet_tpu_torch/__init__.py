"""qpnet_tpu_torch — the PyTorch/CUDA port of qpnet_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same configs, `model.conf`
JSON, checkpoint pickles, h5 schema and CLI argv.  It imports neither JAX
nor `qpnet_tpu`.  Ported so far: autoregressive decoding through the
generation kernel (bf16 and w8a8, the default and the deep
`Rd10Rr3Ed4Er1` network) and through the scan engine (f32, bf16,
int8_weights, d varying within frames), streaming generation, the
`Vocoder` API and the TCP serving stack, single-GPU training with either
engine, validation, reference-checkpoint conversion, the serving soak, and
WORLD analysis and synthesis on the host (float64, bit-equal to the JAX
package's) and on the device (plain PyTorch), which `Vocoder.analyze`/
`vocode` run, and the feature-pipeline workers (extraction, stats, noise
shaping and restoration, also served per stream) over the port's host
C++ MLSA core, the recipe layer, and data parallelism (sharded decode, dp
training on one host and on many; ROADMAP.md lists the rest).

  config.py   model, feature and training configuration
  ops/        mu-law, pitch factors, the generation kernel (K1), the fused
              training stack (K2) and their plain twins; csrc/ holds the
              CUDA sources and the host DSP core, built at first use
  models/     parameters, teacher-forced forward (plain or through K2),
              ring priming, the chunked kernel loop, the scan engine and
              the streaming generator
  dsp/        filters, continuous F0, mel-cepstra, the MLSA filter and
              spectral emphasis, WORLD analysis and synthesis (world/): the
              host paths and their device counterparts
  api.py      `Vocoder`: an experiment directory as one object
  serve.py    batched streaming service and its TCP protocol
  data/       h5 feature files, file lists, feature statistics, the
              training window batcher
  train/      checkpoints, the train step (loss, Adam) and the trainer loop
  parallel/   the dp mesh, the multi-host world over torch.distributed,
              the dp dryrun
  bin/        the decode, serve, train, update and validate CLIs, and the
              feature-pipeline workers
  tools/      reference-checkpoint conversion, the serving soak
  utils/      logging, the worker pool, the tracing (spans, counters and
              torch.profiler traces)
"""

__version__ = "0.1.0"

from qpnet_tpu_torch.api import Vocoder  # noqa: E402,F401
