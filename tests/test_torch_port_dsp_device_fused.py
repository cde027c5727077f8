"""PyTorch port: the device WORLD analysis on the CPU, the fused
extract_all pass against the staged device path (moved from
test_torch_port_dsp_device.py, whose rate it shares, so that the test
workers take these slow cases apart from the rest).
"""

import numpy as np
import pytest

from qpnet_tpu_torch.dsp.world import WorldAnalyzer
from test_torch_port_dsp_device import FS
from torch_port_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("f0_analyzer", ["harvest", "dio"])
def test_fused_extract_all_matches_staged(f0_analyzer):
    """extract_all (one pass) reproduces the staged device path: analyze,
    mcep, codeap, npow with the same stages and buckets."""
    rng = np.random.default_rng(7)
    n = int(0.7 * FS)
    ph = 2 * np.pi * np.cumsum(np.linspace(110, 170, n)) / FS
    x = (0.6 * np.sin(ph) + 0.15 * np.sin(2 * ph)
         + 0.01 * rng.normal(size=n)) * 9000
    kw = dict(fs=FS, minf0=60, maxf0=400, f0_analyzer=f0_analyzer,
              backend="jax", f0_backend="jax", device="cpu")
    staged = WorldAnalyzer(**kw)
    f0_s, _, _ = staged.analyze(x)
    out = WorldAnalyzer(**kw).extract_all(x, dim=24, alpha=0.41)
    assert out["f0"].shape == f0_s.shape == (int(n / 80) + 1,)
    np.testing.assert_array_equal(out["f0"], f0_s)
    np.testing.assert_allclose(out["mcep"], staged.mcep(dim=24, alpha=0.41),
                               atol=1e-5)
    np.testing.assert_allclose(out["codeap"], staged.codeap(), atol=1e-4)
    np.testing.assert_allclose(out["npow"], staged.npow(), atol=1e-4)
    np.testing.assert_array_equal(out["time_axis"],
                                  np.arange(len(f0_s)) * 0.005)
    assert (out["f0"] > 0).mean() > 0.7
