from qpnet_tpu_torch.train.checkpoint import (  # noqa: F401
    adam_state_from_optax, load_checkpoint, save_checkpoint, save_final,
)
