from qpnet_tpu_torch.utils.logging import set_loglevel  # noqa: F401
from qpnet_tpu_torch.utils.multi_process import multi_processing  # noqa: F401
