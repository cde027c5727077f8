from qpnet_tpu_torch.models.qpnet import (  # noqa: F401
    init_params, forward, count_params, params_from_numpy,
)
from qpnet_tpu_torch.models.generate import (  # noqa: F401
    batch_fast_generate, teacher_forced_logits,
)
