from qpnet_tpu_torch.train.checkpoint import load_checkpoint  # noqa: F401
