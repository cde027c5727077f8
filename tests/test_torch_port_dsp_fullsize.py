"""PyTorch port vs the JAX package at full size: the 3 s synthetic voiced
utterance of chip_smoke.py's phase 15 at 22,050 Hz (harvest 40-400 Hz,
fftl 1024), with the host F0 fed to every backend.

The JAX package's codeap max gate (0.1 dB, tests/test_jax_analysis.py:134)
is met on its own test's input but not here: float32 D4C puts a few codeap
values beyond it, JAX's device path and the port's at the same places.  So
phase 15 holds full-size codeap to a median of 0.01 dB and to under 1% of
its values beyond 0.1 dB (dsp/world/gates.py).  On the CPU, this file's
input gave 1 of 1,202 values beyond 0.1 dB for both, max 0.18678 dB
(JAX) and 0.18679 dB (port), and the port within 0.0097 dB of JAX.
"""

import numpy as np

from qpnet_tpu.dsp.world import WorldAnalyzer as JaxWorldAnalyzer
from qpnet_tpu_torch.dsp.world import WorldAnalyzer, gates

FS = 22050
KW = dict(fs=FS, shiftms=5.0, minf0=40.0, maxf0=400.0, fftl=1024)
PORT_JAX_CODEAP_MAX_DB = 0.05


def test_full_size_codeap_outliers_are_the_jax_device_paths_too():
    x = gates.voiced_utterance(np.random.default_rng(15), 3.0, FS)
    host = WorldAnalyzer(**KW)
    f0, ta = host.estimate_f0(x)
    host.analyze(x, f0_time=(f0, ta))
    ca_h = host.codeap()
    jd = JaxWorldAnalyzer(backend="jax", f0_backend="host", **KW)
    jd.analyze(x, f0_time=(f0, ta))
    ca_j = np.asarray(jd.codeap())
    td = WorldAnalyzer(backend="jax", f0_backend="host", device="cpu", **KW)
    td.analyze(x, f0_time=(f0, ta))
    ca_t = td.codeap()

    m_j = gates.codeap_full_metrics(ca_h, ca_j)
    m_t = gates.codeap_full_metrics(ca_h, ca_t)
    # JAX's own device path misses its max gate on this input ...
    assert m_j["codeap_max_db"] > gates.CODEAP_MAX_DB
    # ... at the same codeap values as the port's
    np.testing.assert_array_equal(
        np.abs(ca_j - ca_h) > gates.CODEAP_MAX_DB,
        np.abs(ca_t - ca_h) > gates.CODEAP_MAX_DB)
    # and both meet the full-size gates that phase 15 holds
    assert not gates.gate_failures(m_j), gates.gate_failures(m_j)
    assert not gates.gate_failures(m_t), gates.gate_failures(m_t)
    assert np.abs(ca_t - ca_j).max() < PORT_JAX_CODEAP_MAX_DB
