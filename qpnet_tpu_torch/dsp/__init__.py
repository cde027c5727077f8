"""Signal processing of the port: filters, continuous F0, mel-cepstra, the
MLSA filter and spectral emphasis, and WORLD analysis and synthesis
(world/), the port of `qpnet_tpu/dsp`."""

from qpnet_tpu_torch.dsp.filters import (  # noqa: F401
    low_cut_filter, low_pass_filter,
)
from qpnet_tpu_torch.dsp.contf0 import convert_continuous_f0  # noqa: F401
from qpnet_tpu_torch.dsp.mcep import (  # noqa: F401
    freqt, sp2mc, mc2sp, mc2b, b2mc, spectrogram2npow, extfrm,
)
from qpnet_tpu_torch.dsp.mlsa import mlsa_filter, synthesis_diff  # noqa: F401
