from qpnet_tpu_torch.utils.logging import set_loglevel  # noqa: F401
