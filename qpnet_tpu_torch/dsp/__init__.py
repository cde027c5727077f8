"""Signal processing of the port: filters, continuous F0, mel-cepstra and
WORLD analysis (world/), the port of `qpnet_tpu/dsp` (MLSA, emphasis and
the native binding wait for the synthesis slice)."""

from qpnet_tpu_torch.dsp.filters import (  # noqa: F401
    low_cut_filter, low_pass_filter,
)
from qpnet_tpu_torch.dsp.contf0 import convert_continuous_f0  # noqa: F401
from qpnet_tpu_torch.dsp.mcep import (  # noqa: F401
    freqt, sp2mc, mc2sp, mc2b, b2mc, spectrogram2npow, extfrm,
)
