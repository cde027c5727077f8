"""PyTorch port: the device WORLD analysis on the CPU, a zero pad beyond
n_valid and one pass split by stage (moved from
test_torch_port_dsp_device.py, whose signals and rate they share, so that
the test workers take these slow cases apart from the rest).
"""

import numpy as np
import torch

from qpnet_tpu_torch.dsp.world import WorldAnalyzer
from qpnet_tpu_torch.dsp.world.device_analysis import (device_analyze,
                                                       device_cheaptrick,
                                                       device_d4c)
from qpnet_tpu_torch.dsp.world.device_f0 import mark, marks_ms, stage_marks
from test_torch_port_dsp_device import CPU, FS, KW, _sawtooth, _t
from torch_port_threads import one_thread  # noqa: F401


def test_padding_invariance():
    """A zero pad beyond n_valid changes nothing: the envelopes of a signal
    alone and padded a second longer are equal, and npow's mean is taken
    over the true frames only."""
    rng = np.random.default_rng(4)
    n = int(0.55 * FS)
    ph = 2 * np.pi * np.cumsum(np.full(n, 140.0)) / FS
    x = (0.5 * np.sin(ph) + 0.02 * rng.normal(size=n)).astype(np.float32)
    ta = np.arange(0, 0.54, 0.005).astype(np.float32)
    f0 = np.full(len(ta), 140.0, np.float32)
    x_pad = np.concatenate([x, np.zeros(FS - n % FS, np.float32)])
    for fn in (device_cheaptrick, device_d4c):
        a = fn(_t(x), _t(f0), _t(ta), FS, n_valid=n)
        b = fn(_t(x_pad), _t(f0), _t(ta), FS, n_valid=n)
        assert torch.equal(a, b), fn.__name__
    F = int(n / (FS * 0.005)) + 1
    npow = device_analyze(_t(x_pad), FS, n, F, 0.41, mcep_dim=24,
                          device=CPU, **KW)[3].numpy()
    assert np.isclose(np.mean(10.0 ** (npow[:F] / 10.0)), 1.0, atol=1e-4)


def test_stage_marks_split_one_pass():
    """stage_marks() splits one fused pass by stage (host clock readings on
    the CPU) without changing its outputs; outside it no mark is kept."""
    x = _sawtooth()[: int(0.3 * FS)]
    an = WorldAnalyzer(fs=FS, minf0=60, maxf0=400, backend="jax",
                       f0_backend="jax", device="cpu")
    plain = an.extract_all(x, dim=24, alpha=0.41)
    with stage_marks() as marks:
        mark("start", CPU)
        timed = an.extract_all(x, dim=24, alpha=0.41)
    mark("outside", CPU)
    split = marks_ms(marks)
    assert [s for s, _ in split] == [
        "upload", "F0 candidates", "F0 pooling loop", "F0 refinement",
        "F0 Viterbi loop", "F0 short runs", "CheapTrick", "D4C", "mcep",
        "codeap, npow"]
    assert all(ms >= 0 for _, ms in split)
    for k in plain:
        np.testing.assert_array_equal(timed[k], plain[k])
