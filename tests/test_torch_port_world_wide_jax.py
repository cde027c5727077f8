"""PyTorch port vs the JAX package: the device F0 passes at the candidate
and band counts past the analysis kernels' narrow builds, run on the CPU
(where W1-W3's wrappers run their plain versions) against `jax_f0`.

  * `device_harvest(max_candidates=24)` at its defaults (84 channel ranks,
    71-800 Hz at 24 an octave) and `max_candidates=40` at 6 an octave (21
    ranks: K past the ranks), against `jax_harvest`;
  * `device_dio` at 12 bands an octave (C = 42) and 18.1 (C = 64) against
    `jax_dio`.

Each distinct K or C is a fresh JAX compile, so these four passes live in
a file of their own.  The signal is a 0.5 s vibrato tone at 16 kHz (the
one of test_torch_port_dsp_device.py).  The gates are that file's for
whole passes (torch's pocketfft against XLA's FFT, both float32, so not
bit for bit): voicing agreement >= 0.99 and median |dF0| <= 0.05 Hz on
frames voiced in both; on this input the passes agree in voicing on every
frame, harvest within 7e-4 Hz and dio within 0.011 Hz at most.
"""

import numpy as np
import pytest
import torch

from qpnet_tpu.dsp.world.jax_f0 import jax_dio, jax_harvest
from qpnet_tpu_torch.dsp.world.device_f0 import device_dio, device_harvest
from qpnet_tpu_torch.ops import world_kernel as WK
from torch_port_threads import one_thread  # noqa: F401

FS = 16000
N = FS // 2
VOICING_MIN = 0.99
DF0_MEDIAN_MAX = 0.05        # Hz, frames voiced in both


def _vibrato(seed=16):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / FS
    f0 = 140.0 + 5.0 * np.sin(2 * np.pi * 5.0 * t)
    phase = 2 * np.pi * np.cumsum(f0) / FS
    x = np.sin(phase) + 0.4 * np.sin(2 * phase + 1.0)
    return ((x + 0.02 * rng.standard_normal(N)) * 8000).astype(np.float32)


def _agree(got, want):
    assert got.shape == want.shape
    vg, vw = got > 0, want > 0
    both = vg & vw
    assert both.mean() > 0.5
    agree = float((vg == vw).mean())
    med = float(np.median(np.abs(got - want)[both]))
    assert agree >= VOICING_MIN and med <= DF0_MEDIAN_MAX, (agree, med)


@pytest.mark.parametrize("K,channels_in_octave", [(24, 24.0), (40, 6.0)])
def test_device_harvest_wide_k_matches_jax(K, channels_in_octave):
    assert K > WK.POOL_REGS and K + 1 > WK.VITERBI_NARROW
    x = _vibrato()
    kw = dict(max_candidates=K, channels_in_octave=channels_in_octave)
    want = np.asarray(jax_harvest(x, FS, **kw))
    WK.reset_launch_count()
    got = device_harvest(torch.from_numpy(x), FS, **kw).numpy()
    assert WK.launch_count("pool") == WK.launch_count("viterbi") == 0
    _agree(got, want)


@pytest.mark.parametrize("channels_in_octave,C", [(12.0, 42), (18.1, 64)])
def test_device_dio_wide_bands_matches_jax(channels_in_octave, C):
    assert 1 + int(np.log2(800.0 / 71.0) * channels_in_octave) == C
    assert C > WK.FIX_NARROW
    x = _vibrato()
    want = np.asarray(jax_dio(x, FS, channels_in_octave=channels_in_octave))
    got = device_dio(torch.from_numpy(x), FS,
                     channels_in_octave=channels_in_octave).numpy()
    _agree(got, want)
