"""qpnet_tpu_torch — the PyTorch/CUDA port of qpnet_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same configs, `model.conf`
JSON, checkpoint pickles, h5 schema and CLI argv.  It imports neither JAX
nor `qpnet_tpu`.  Ported so far: autoregressive decoding of the kernel
engine, and single-GPU training with either engine (ROADMAP.md lists the
rest).

  config.py   model, feature and training configuration
  ops/        mu-law, pitch factors, the generation kernel (K1), the fused
              training stack (K2) and their plain twins; csrc/ holds the
              CUDA sources, built at first use
  models/     parameters, teacher-forced forward (plain or through K2),
              ring priming and the chunked decode loop
  data/       h5 feature reads, file lists, feature scaler, the training
              window batcher
  train/      checkpoints, the train step (loss, Adam) and the trainer loop
  bin/        the decode, train and update CLIs
"""

__version__ = "0.1.0"
