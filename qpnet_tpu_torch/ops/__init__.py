from qpnet_tpu_torch.ops.mulaw import encode_mu_law, decode_mu_law  # noqa: F401
from qpnet_tpu_torch.ops.pitch import (  # noqa: F401
    dilated_factor, batch_f0, extend_time,
)
