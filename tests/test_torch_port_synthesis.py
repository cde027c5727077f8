"""WORLD synthesis of the port against the JAX package's.

  * host `synthesize` and `_pulse_times` (float64 numpy, default_rng):
    bit for bit;
  * device synthesis on the CPU (float32 PyTorch) against `jax_synthesize`
    and the host with tests/test_jax_synthesis.py's gates: pulse times
    equal (the port builds its pulse track in float64, so its pulse times
    are the host's within 1e-6 of a sample; JAX's float32 track may move
    one by a sample), the
    deterministic (ap ~ 0) waveform with correlation > 0.999 and rms |d|
    < 5e-3 of rms, the noise envelope's band energies within 2 dB,
    determinism per seed, the fused restore within 2e-3 of rms of the
    synthesis fed host-decoded spectra, the synthesizer's device backend
    within 0.1 dB MCD and 1 Hz F0 RMSE of the host's;
  * `synthesis_async` equal to `synthesis`; `device_fir` against lfilter
    within 1e-5 (float32).
"""

import numpy as np
import pytest
import torch
from scipy.signal import firwin, lfilter

from qpnet_tpu.dsp.world import jax_synthesis as JX
from qpnet_tpu.dsp.world import synthesis as JS
from qpnet_tpu_torch.dsp.filters import device_fir
from qpnet_tpu_torch.dsp.mcep import mc2sp, sp2mc
from qpnet_tpu_torch.dsp.world import device_synthesis as DX
from qpnet_tpu_torch.dsp.world import gates
from qpnet_tpu_torch.dsp.world import synthesis as TS
from qpnet_tpu_torch.dsp.world.api import WorldSynthesizer
from qpnet_tpu_torch.dsp.world.codec import (code_aperiodicity,
                                             decode_aperiodicity)
from qpnet_tpu_torch.tools.evaluate import wav_metrics

FS = 22050
SHIFTMS = 5.0
CPU = "cpu"


def _f0_track(F, voiced_gap=True):
    """tests/test_jax_synthesis.py's vibrato F0, with an unvoiced gap in the
    middle (gates.synthesis_fixture)."""
    return gates.synthesis_fixture(F, FS, SHIFTMS, voiced_gap)[0]


def _envelope(F):
    return gates.synthesis_fixture(F, FS, SHIFTMS)[1]


@pytest.mark.parametrize("gap,ap_level,seed", [(True, 0.3, 0),
                                               (False, 1e-6, 4),
                                               (True, 0.999999, 9)])
def test_host_synthesize_bit_equal(gap, ap_level, seed):
    F = 60
    f0 = _f0_track(F, gap)
    sp = _envelope(F)
    ap = np.full_like(sp, ap_level)
    np.testing.assert_array_equal(
        TS.synthesize(f0, sp, ap, FS, SHIFTMS, seed),
        JS.synthesize(f0, sp, ap, FS, SHIFTMS, seed))
    ta = np.arange(F) * SHIFTMS / 1000.0
    n = int(F * SHIFTMS / 1000.0 * FS)
    for a, b in zip(TS._pulse_times(f0, ta, FS, n),
                    JS._pulse_times(f0, ta, FS, n)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gap", [True, False])
def test_device_pulse_times_equal_the_host(gap):
    """Pulse indices and voicing equal the host's on this track; shifts
    within 1e-6 of a sample; JAX's device track has as many pulses, one
    sample off at most on < 5% of them (its own gate)."""
    F = 100
    f0 = _f0_track(F, gap)
    ta = np.arange(F) * SHIFTMS / 1000.0
    n = int(F * SHIFTMS / 1000.0 * FS)
    idx_h, shift_h, voiced_h = TS._pulse_times(f0, ta, FS, n)
    idx_d, shift_d, voiced_d = DX.pulse_times_debug(f0, FS, SHIFTMS,
                                                    device=CPU)
    np.testing.assert_array_equal(idx_d, idx_h)
    np.testing.assert_array_equal(voiced_d, voiced_h)
    assert np.abs(shift_d - shift_h).max() * FS < 1e-6
    idx_j, _, _ = JX.pulse_times_debug(f0, FS, SHIFTMS)
    d = np.abs(idx_j.astype(int) - idx_d.astype(int))
    assert len(idx_j) == len(idx_d) and d.max() <= 1 and (d == 0).mean() > 0.95


def test_device_pulse_times_on_whole_cycles():
    """The 500 Hz unvoiced default at 22,050 Hz lands the phase on a whole
    cycle every 441 samples, where rounding decides the index: there the
    device and the host may index one sample apart, one with a shift of a
    whole sample, so the pulse times (index + shift) agree within 1e-6 of
    a sample, the count and voicing exactly."""
    F = 60
    f0 = _f0_track(F)
    f0[:20] = 0.0                            # a 100 ms unvoiced start
    ta = np.arange(F) * SHIFTMS / 1000.0
    n = int(F * SHIFTMS / 1000.0 * FS)
    idx_h, shift_h, voiced_h = TS._pulse_times(f0, ta, FS, n)
    idx_d, shift_d, voiced_d = DX.pulse_times_debug(f0, FS, SHIFTMS,
                                                    device=CPU)
    assert len(idx_d) == len(idx_h)
    np.testing.assert_array_equal(voiced_d, voiced_h)
    t_h, t_d = idx_h + shift_h * FS, idx_d + shift_d * FS
    assert np.abs(t_h - t_d).max() < 1e-6
    assert np.abs(idx_h.astype(int) - idx_d.astype(int)).max() <= 1


def test_device_prepends_origin_pulse():
    f0 = np.full(40, 120.0)
    idx, shift, _ = DX.pulse_times_debug(f0, FS, SHIFTMS, device=CPU)
    assert idx[0] == 0 and shift[0] == 0.0
    assert np.all(np.abs(np.diff(idx[1:]) - FS / 120.0) < 2)


def test_device_periodic_component_against_jax_and_host():
    """ap ~ 0: deterministic; the gates against the host float64 loop and
    against JAX's device synthesis."""
    F = 100
    f0 = _f0_track(F, voiced_gap=False)
    sp = _envelope(F)
    ap = np.full_like(sp, 1e-6)
    y_h = TS.synthesize(f0, sp, ap, FS, frame_period=SHIFTMS, seed=0)
    y_d = DX.device_synthesize(f0, sp, ap, 0, FS, SHIFTMS, device=CPU)
    assert y_d.dtype == torch.float32 and y_d.shape == y_h.shape
    y_j = np.asarray(JX.jax_synthesize(f0, sp, ap, np.uint32(0), FS,
                                       frame_period=SHIFTMS))
    for ref in (y_h, y_j):
        m = gates.periodic_metrics(ref, y_d.numpy())
        assert not gates.gate_failures(m), m


def test_device_noise_envelope_matches_host_and_jax():
    F = 200
    f0 = np.zeros(F)
    sp = _envelope(F)
    ap = np.full_like(sp, 0.999999)
    y_h = TS.synthesize(f0, sp, ap, FS, frame_period=SHIFTMS, seed=3)
    y_j = np.asarray(JX.jax_synthesize(f0, sp, ap, np.uint32(3), FS,
                                       frame_period=SHIFTMS))
    y_d = DX.device_synthesize(f0, sp, ap, 3, FS, SHIFTMS,
                               device=CPU).numpy()
    Sd = np.abs(np.fft.rfft(y_d)) ** 2
    edges = np.linspace(0, len(Sd), 6).astype(int)
    for ref in (y_h, y_j):
        Sr = np.abs(np.fft.rfft(ref)) ** 2
        for a, b in zip(edges[:-1], edges[1:]):
            assert abs(10 * np.log10(Sd[a:b].sum() / Sr[a:b].sum())) < 2.0


def test_device_deterministic_per_seed():
    F = 60
    f0 = _f0_track(F)
    sp = _envelope(F)
    ap = np.full_like(sp, 0.3)
    a, b, c = (DX.device_synthesize(f0, sp, ap, s, FS, SHIFTMS, device=CPU)
               for s in (7, 7, 8))
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 0


def test_device_restore_matches_synthesis_of_host_decoded():
    """device_restore (mc2sp on the warped axis, the aperiodicity decode,
    synthesis) against device_synthesize fed the host-decoded spectra,
    same seed: within 2e-3 of rms (JAX's gate for jax_restore)."""
    F = 100
    f0 = _f0_track(F)
    sp = _envelope(F)
    mcep = sp2mc(sp, 34, 0.455)
    codeap = code_aperiodicity(np.full_like(sp, 0.3), FS)
    y_ref = DX.device_synthesize(f0, mc2sp(mcep, 0.455, 1024),
                                 decode_aperiodicity(codeap, FS, 1024), 5,
                                 FS, SHIFTMS, device=CPU).numpy()
    y = DX.device_restore(f0, mcep, codeap, 0.455, 5, FS, fftl=1024,
                          frame_period=SHIFTMS, device=CPU).numpy()
    rms = np.sqrt(np.mean(y_ref ** 2))
    assert np.sqrt(np.mean((y_ref - y) ** 2)) < 2e-3 * rms


def test_synthesizer_device_backend_matches_host_mcd():
    """WorldSynthesizer(backend='jax') on the CPU (F=201 pads the frames)
    against the host backend: MCD < 0.1 dB, F0 RMSE < 1 Hz."""
    F = 201
    f0 = _f0_track(F, voiced_gap=False)
    sp = _envelope(F)
    ap = np.full_like(sp, 1e-6)
    mcep = sp2mc(sp, 34, 0.455)
    y_h = WorldSynthesizer(fs=FS, shiftms=SHIFTMS).synthesis(f0, mcep, ap)
    y_d = WorldSynthesizer(fs=FS, shiftms=SHIFTMS, backend="jax",
                           device=CPU).synthesis(f0, mcep, ap)
    assert len(y_d) == len(y_h) and y_d.dtype == np.float64
    m = wav_metrics(y_h, y_d, FS, minf0=60, maxf0=400)
    assert m["mcd_db"] < 0.1 and m["f0_rmse_hz"] < 1.0, m


def test_synthesis_async_matches_sync():
    F = 80
    f0 = _f0_track(F)
    sp = _envelope(F)
    ap = np.full_like(sp, 0.2)
    mcep = sp2mc(sp, 34, 0.455)
    dev = WorldSynthesizer(fs=FS, shiftms=SHIFTMS, backend="jax", device=CPU)
    outs = [dev.synthesis_fetch(h) for h in
            [dev.synthesis_async(f0, mcep, ap, 0.455) for _ in range(3)]]
    direct = dev.synthesis(f0, mcep, ap, 0.455)
    for o in outs:
        np.testing.assert_array_equal(o, direct)
    codeap = code_aperiodicity(ap, FS)
    a = dev.synthesis_fetch(dev.restore_async(f0, mcep, codeap, 0.455))
    b = dev.synthesis_fetch(dev.restore_async(f0, mcep, codeap, 0.455))
    np.testing.assert_array_equal(a, b)
    assert a.shape == direct.shape


def test_device_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DX.device_synthesize(np.full(10, 100.0), np.ones((10, 513)),
                             np.full((10, 513), 0.5), 0, FS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorldSynthesizer(backend="jax").synthesis(
            np.full(10, 100.0), np.zeros((10, 35)), np.full((10, 513), 0.5))


@pytest.mark.parametrize("n_taps", [31, 255])
def test_device_fir_matches_lfilter(n_taps):
    """tests/test_dsp_filters.py:47's gate for jax_fir: within 1e-5."""
    rng = np.random.default_rng(n_taps)
    x = rng.normal(size=500).astype(np.float32)
    taps = firwin(n_taps, 0.3).astype(np.float32)
    y = device_fir(torch.from_numpy(x), taps)
    assert y.dtype == torch.float32 and y.shape == (500,)
    np.testing.assert_allclose(y.numpy(), lfilter(taps, 1, x), atol=1e-5)
