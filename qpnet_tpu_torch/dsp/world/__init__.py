"""WORLD-style vocoder analysis and synthesis, the port of
`qpnet_tpu/dsp/world`.

Two backends with the JAX package's names: the float64 numpy host path
(dio, harvest, stonemask, cheaptrick, d4c, the aperiodicity codec,
synthesis), copied so that it stays bit-equal to the JAX package's, and
the float32 device path in plain PyTorch (device_f0.py,
device_analysis.py, device_synthesis.py), the port of the JAX package's XLA
programs.  `WorldAnalyzer` and `WorldSynthesizer` select between them with
the JAX package's values; "jax" means "on the torch device" here.
"""

from qpnet_tpu_torch.dsp.world.dio import dio  # noqa: F401
from qpnet_tpu_torch.dsp.world.harvest import harvest  # noqa: F401
from qpnet_tpu_torch.dsp.world.stonemask import stonemask  # noqa: F401
from qpnet_tpu_torch.dsp.world.cheaptrick import cheaptrick  # noqa: F401
from qpnet_tpu_torch.dsp.world.d4c import d4c  # noqa: F401
from qpnet_tpu_torch.dsp.world.codec import (  # noqa: F401
    code_aperiodicity, decode_aperiodicity,
)
from qpnet_tpu_torch.dsp.world.synthesis import synthesize  # noqa: F401
from qpnet_tpu_torch.dsp.world.api import (  # noqa: F401
    WorldAnalyzer, WorldSynthesizer,
)
from qpnet_tpu_torch.dsp.world.device_f0 import (  # noqa: F401
    device_dio, device_harvest, device_stonemask,
)
from qpnet_tpu_torch.dsp.world.device_analysis import (  # noqa: F401
    device_analyze, device_cheaptrick, device_d4c, device_freqt,
    device_sp2mc,
)
from qpnet_tpu_torch.dsp.world.device_synthesis import (  # noqa: F401
    device_restore, device_synthesize,
)
