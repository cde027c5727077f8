"""PyTorch port vs the JAX package: the device WORLD analysis (device_f0.py,
device_analysis.py) run on the CPU against `jax_f0`/`jax_analysis`, and
against the port's own host backend through the JAX package's
device-vs-host gates.  One rate and length (16 kHz, a 1 s bucket) for every
JAX call, so JAX compiles once per function; signals are made from seeds
with numpy.

Tolerances, with the worst case this file's inputs gave on the CPU
(torch's pocketfft against XLA's FFT, both float32):
  * given the same F0 and time axis: device_cheaptrick within 1e-3 dB (max)
    of jax_cheaptrick (worst 4.2e-4), device_d4c within 1e-3 dB (4.4e-5),
    device_sp2mc and device_freqt within 1e-4 absolute (2.4e-6, 2.4e-7);
  * F0 alone (harvest, dio+stonemask) and device_analyze against
    jax_analyze: voicing agreement >= 0.99 (1.0), median |dF0| <= 0.05 Hz
    on frames voiced in both (1.2e-4), mcep mean |d| <= 1e-3 (2.9e-7),
    codeap median |d| <= 0.01 dB (9.3e-6), npow within 1e-3 dB (3.1e-5);
  * device against the port's host backend: the JAX package's own gates
    (tests/test_jax_analysis.py:48-49, 102, 131-134; tests/test_jax_f0.py:
    86-90, 117-118, 277-281).
"""

import itertools

import numpy as np
import pytest
import torch

from qpnet_tpu.dsp.world.jax_analysis import (jax_analyze, jax_cheaptrick,
                                              jax_d4c, jax_freqt, jax_sp2mc)
from qpnet_tpu.dsp.world.jax_f0 import jax_dio, jax_harvest, jax_stonemask
from qpnet_tpu.tools.make_synth_corpus import synth_utterance
from qpnet_tpu_torch.dsp.mcep import freqt
from qpnet_tpu_torch.dsp.world import WorldAnalyzer, gates
from qpnet_tpu_torch.dsp.world.device_analysis import (device_analyze,
                                                       device_cheaptrick,
                                                       device_d4c,
                                                       device_freqt,
                                                       device_sp2mc)
from qpnet_tpu_torch.dsp.world.device_f0 import (_fix_contour_scan,
                                                 _viterbi, device_dio,
                                                 device_harvest,
                                                 device_stonemask)
from qpnet_tpu_torch.dsp.world.dio import _fix_contour, dio
from qpnet_tpu_torch.dsp.world.harvest import harvest
from qpnet_tpu_torch.dsp.world.stonemask import stonemask
from torch_port_threads import one_thread  # noqa: F401

FS = 16000
N = FS
KW = dict(f0_floor=60.0, f0_ceil=400.0)
CPU = torch.device("cpu")

# device against JAX's device path
VOICING_MIN = 0.99
DF0_MEDIAN_MAX = 0.05        # Hz, frames voiced in both
SPEC_DB_MAX = 1e-3           # cheaptrick / d4c, same F0 and time axis
CEP_MAX = 1e-4               # sp2mc / freqt
MCEP_MEAN_MAX = 1e-3
CODEAP_MEDIAN_MAX = 0.01     # dB


def _vibrato(f0_base=140.0, amp_h2=0.4, noise=0.02, seed=0, n=N):
    """tests/test_jax_f0.py's vibrato tone."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    f0 = f0_base + 5.0 * np.sin(2 * np.pi * 5.0 * t)
    phase = 2 * np.pi * np.cumsum(f0) / FS
    x = np.sin(phase) + amp_h2 * np.sin(2 * phase + 1.0)
    return x + noise * rng.standard_normal(n), f0


def _sawtooth(seed=5, n=N):
    """tests/test_jax_analysis.py's gliding sawtooth at int16 scale."""
    rng = np.random.default_rng(seed)
    ph = np.cumsum(np.linspace(120, 180, n) / FS)
    return (0.5 * (2 * (ph % 1.0) - 1.0) + 0.01 * rng.normal(size=n)) * 12000


def _speech(seed=5):
    return synth_utterance(np.random.default_rng(seed), FS, 1.0,
                           150.0)[:N] * 9000


SIGNALS = {"vibrato": lambda: _vibrato()[0] * 8000, "sawtooth": _sawtooth,
           "speech": _speech}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _f0_agreement(a, b):
    """(voicing agreement, median |dF0| on frames voiced in both)."""
    va, vb = a > 0, b > 0
    both = va & vb
    assert both.sum() > 0.3 * len(a)
    return float((va == vb).mean()), float(np.median(np.abs(a - b)[both]))


def _db(a, scale=10.0):
    return scale * np.log10(np.maximum(a, 1e-30))


@pytest.fixture(scope="module")
def jax_f0():
    """JAX's device harvest of each signal (one compile for all)."""
    return {k: np.asarray(jax_harvest(np.asarray(make(), np.float32), FS,
                                      **KW))
            for k, make in SIGNALS.items()}


# ---------------------------------------------------------------------------
# the device backend against JAX's device modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_device_harvest_matches_jax(jax_f0, name):
    got = device_harvest(_t(SIGNALS[name]()), FS, **KW).numpy()
    assert got.shape == jax_f0[name].shape
    agree, med = _f0_agreement(got, jax_f0[name])
    assert agree >= VOICING_MIN and med <= DF0_MEDIAN_MAX, (agree, med)


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_device_dio_stonemask_matches_jax(name):
    x32 = np.asarray(SIGNALS[name](), np.float32)
    want = np.asarray(jax_stonemask(x32, jax_dio(x32, FS, **KW), FS, **KW))
    raw = device_dio(_t(x32), FS, **KW)
    got = device_stonemask(_t(x32), raw, FS, **KW).numpy()
    agree, med = _f0_agreement(got, want)
    assert agree >= VOICING_MIN and med <= DF0_MEDIAN_MAX, (agree, med)


@pytest.mark.parametrize("name", ["speech", "sawtooth"])
def test_device_spectral_stages_match_jax(jax_f0, name):
    """CheapTrick, D4C and sp2mc fed the same F0 and time axis."""
    x32 = np.asarray(SIGNALS[name](), np.float32)
    f0 = jax_f0[name]
    ta = (np.arange(len(f0)) * 0.005).astype(np.float32)
    sp_j = np.asarray(jax_cheaptrick(x32, f0, ta, FS, fft_size=1024,
                                     f0_floor=71.0, f0_ceil=400.0))
    sp_t = device_cheaptrick(_t(x32), _t(f0), _t(ta), FS, fft_size=1024,
                             f0_floor=71.0, f0_ceil=400.0).numpy()
    assert np.abs(_db(sp_j) - _db(sp_t)).max() <= SPEC_DB_MAX
    ap_j = np.asarray(jax_d4c(x32, f0, ta, FS, fft_size=1024,
                              f0_ceil=1000.0))
    ap_t = device_d4c(_t(x32), _t(f0), _t(ta), FS, fft_size=1024,
                      f0_ceil=1000.0).numpy()
    assert np.abs(_db(ap_j, 20) - _db(ap_t, 20)).max() <= SPEC_DB_MAX
    assert (ap_t[:, 100] < 0.99).mean() > 0.3      # voiced frames coded
    np.testing.assert_allclose(
        device_sp2mc(_t(sp_j), 24, 0.41).numpy(),
        np.asarray(jax_sp2mc(sp_j, 24, 0.41)), rtol=0, atol=CEP_MAX)


def test_device_freqt_matches_jax():
    rng = np.random.default_rng(0)
    c = (rng.normal(size=(5, 30)) * np.exp(-0.2 * np.arange(30))).astype(
        np.float32)
    for order, alpha in ((24, 0.41), (34, -0.455)):
        np.testing.assert_allclose(
            device_freqt(_t(c), order, alpha).numpy(),
            np.asarray(jax_freqt(c, order, alpha)), rtol=0, atol=CEP_MAX)
    # the linear map equals the host recursion it is built from
    np.testing.assert_allclose(device_freqt(_t(c), 24, 0.41).numpy(),
                               freqt(c.astype(np.float64), 24, 0.41),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("f0_analyzer", ["harvest", "dio"])
def test_device_analyze_matches_jax(f0_analyzer):
    """The fused pass on a 0.7 s utterance padded to its 1 s bucket."""
    n = int(0.7 * FS)
    x = np.zeros(N, np.float32)
    x[:n] = _speech(seed=11)[:n]
    F = int(n / (FS * 0.005)) + 1
    args = (FS, n, F, 0.41)
    kw = dict(fft_size=1024, mcep_dim=24, cheaptrick_floor=71.0,
              f0_analyzer=f0_analyzer, **KW)
    want = [np.asarray(a)[:F] for a in jax_analyze(x, *args, **kw)]
    got = [a.numpy()[:F] for a in device_analyze(_t(x), *args, **kw)]
    agree, med = _f0_agreement(got[0], want[0])
    assert agree >= VOICING_MIN and med <= DF0_MEDIAN_MAX, (agree, med)
    assert np.abs(got[1] - want[1]).mean() <= MCEP_MEAN_MAX
    assert np.median(np.abs(got[2] - want[2])) <= CODEAP_MEDIAN_MAX
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# the loops held to oracles
# ---------------------------------------------------------------------------

def test_viterbi_backtrack_oracle():
    """_viterbi against a brute-force numpy Viterbi on a track whose optimal
    path switches candidate slots mid-way (tests/test_jax_f0.py's oracle:
    it pins the back-track's frame alignment)."""
    F, K = 12, 2
    tc, uc = 8.0, 0.35
    rng = np.random.default_rng(3)
    refined = np.zeros((F, K), np.float32)
    score = np.zeros((F, K), np.float32)
    refined[:, 0], refined[:, 1] = 100.0, 105.0
    score[:6, 0], score[:6, 1] = 0.9, 0.4
    score[6:, 0], score[6:, 1] = 0.4, 0.9
    score += rng.uniform(0, 0.01, score.shape).astype(np.float32)

    f0 = _viterbi(_t(refined), _t(score), tc, uc).numpy()

    S = K + 1
    emits = np.full((F, S), np.inf)
    emits[:, 0] = uc
    emits[:, 1:] = 1.0 - score
    logf = np.log(refined)
    best_cost, best_path = np.inf, None
    for path in itertools.product(range(S), repeat=F):
        c = emits[0, path[0]]
        for t in range(1, F):
            s, p = path[t], path[t - 1]
            if s == 0 or p == 0:
                c += 0.0 if (s == 0 and p == 0) else uc
            else:
                c += tc * abs(logf[t, s - 1] - logf[t - 1, p - 1])
            c += emits[t, s]
        if c < best_cost:
            best_cost, best_path = c, path
    expect = np.array([0.0 if s == 0 else refined[t, s - 1]
                       for t, s in enumerate(best_path)])
    np.testing.assert_allclose(f0, expect, rtol=1e-6)


def test_fix_contour_scan_matches_host_oracle():
    """The contour loops reproduce the port's host dio._fix_contour walk on
    random candidate tables (tests/test_jax_f0.py's construction), and
    never voice frame 0."""
    rng = np.random.default_rng(3)
    C, F = 6, 240
    for trial in range(8):
        f0 = np.zeros(F)
        cands = np.zeros((C, F))
        t0 = 0
        while t0 < F - 30:
            seg = rng.integers(12, 60)
            base = rng.uniform(100, 300)
            tr = base * (1 + 0.02 * np.cumsum(rng.normal(size=seg)) / 10)
            f0[t0: t0 + seg] = tr[: F - t0]
            for c in range(C):
                noise = 1 + 0.003 * rng.normal(size=min(seg, F - t0))
                if rng.random() < 0.7:
                    cands[c, t0: t0 + seg] = tr[: F - t0] * noise
                elif rng.random() < 0.5:
                    cands[c, t0: t0 + seg] = tr[: F - t0] * 2 * noise
            t0 += seg + rng.integers(5, 25)
        f0[rng.random(F) < 0.05] = 0.0
        host = _fix_contour(f0, cands, 5.0, 0.1, f0_floor=90.0)
        dev = _fix_contour_scan(_t(f0), _t(cands), 5.0, 0.1, 90.0).numpy()
        agree = np.isclose(host, dev, rtol=2e-3, atol=1e-2)
        assert agree.mean() > 0.99, (trial, np.nonzero(~agree)[0][:10])
    f0 = np.zeros(30)
    f0[5:21] = 150.0
    cands = np.full((4, 30), 150.0)
    host = _fix_contour(f0, cands, 5.0, 0.1, f0_floor=90.0)
    dev = _fix_contour_scan(_t(f0), _t(cands), 5.0, 0.1, 90.0).numpy()
    assert host[0] == 0.0 and dev[0] == 0.0
    assert np.allclose(host, dev, rtol=2e-3, atol=1e-2)


# ---------------------------------------------------------------------------
# the analyzer's contract (padding, fused against staged and the stage marks
# are test_torch_port_dsp_device_pass.py and _fused.py: files of their own,
# so that the test workers take them apart)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,f0_backend", [("jax", "host"),
                                                ("numpy", "jax"),
                                                ("numpy", "host")])
def test_extract_all_requires_device_backends(backend, f0_backend):
    an = WorldAnalyzer(fs=FS, backend=backend, f0_backend=f0_backend,
                       device="cpu")
    with pytest.raises(RuntimeError, match="extract_all"):
        an.extract_all(np.zeros(FS))


def test_device_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    x = np.zeros(FS)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_harvest(x, FS)
    with pytest.raises(RuntimeError, match="CUDA"):
        WorldAnalyzer(fs=FS, backend="jax", f0_backend="jax").extract_all(x)


# ---------------------------------------------------------------------------
# the device backend against the port's host backend: JAX's own gates
# ---------------------------------------------------------------------------

def test_device_harvest_within_host_gates():
    """tests/test_jax_f0.py:86-90 at its search range (90-400 Hz)."""
    x = _speech()
    kw = dict(f0_floor=90.0, f0_ceil=400.0)
    f0_dev = device_harvest(_t(x), FS, **kw).numpy()
    f0_host, _ = harvest(x, FS, **kw)
    vd, vh = f0_dev > 0, f0_host > 0
    both = vd & vh
    assert (vd == vh).mean() > 0.85
    assert both.sum() > 0.4 * len(f0_dev)
    diff = np.abs(f0_dev - f0_host)[both]
    assert np.median(diff) < 2.0
    assert (diff < 10.0).mean() > 0.9


def test_device_dio_within_host_gates():
    """tests/test_jax_f0.py:277-281: dio+stonemask, device against host."""
    x = _speech()
    kw = dict(f0_floor=90.0, f0_ceil=400.0)
    f0_dev = device_stonemask(_t(x), device_dio(_t(x), FS, **kw), FS,
                              **kw).numpy()
    raw, ta = dio(x, FS, **kw)
    f0_host = stonemask(x, raw, ta, FS)
    vd, vh = f0_dev > 0, f0_host > 0
    both = vd & vh
    assert (vd == vh).mean() > 0.8
    assert both.sum() > 0.3 * len(f0_dev)
    diff = np.abs(f0_dev - f0_host)[both]
    assert np.median(diff) < 2.0
    assert (diff < 10.0).mean() > 0.85


def test_analyzer_f0_backend_within_host_gates():
    """tests/test_jax_f0.py:115-120: the analyzer's device F0 keeps the
    host contract (shape, time axis, range) and lands on the host track."""
    x, _ = _vibrato(seed=9)
    kw = dict(fs=FS, minf0=90.0, maxf0=400.0)
    f0_d, t_d = WorldAnalyzer(f0_backend="jax", device="cpu",
                              **kw).estimate_f0(x)
    f0_h, t_h = WorldAnalyzer(**kw).estimate_f0(x)
    assert f0_d.shape == f0_h.shape and np.allclose(t_d, t_h)
    voiced = (f0_d > 0) & (f0_h > 0)
    assert voiced.mean() > 0.85
    assert np.median(np.abs(f0_d[voiced] - f0_h[voiced])) < 1.0
    assert ((f0_d == 0) | ((f0_d >= 90.0) & (f0_d <= 400.0))).all()


def test_cheaptrick_d4c_within_host_gates():
    """tests/test_jax_analysis.py:48-49 (CheapTrick: median < 0.01 dB, mean
    < 0.05 dB) and :102-105 (D4C: max < 0.05 dB, equal voicing), on those
    tests' signals (gates.py, which chip_smoke.py holds on the card)."""
    m = {**gates.cheaptrick_metrics(CPU, FS), **gates.d4c_metrics(CPU, FS)}
    assert set(m) == {"ct_median_db", "ct_mean_db", "d4c_max_db",
                      "d4c_same_voicing"}
    assert not gates.gate_failures(m), gates.gate_failures(m)


def test_worldanalyzer_device_backend_within_host_gates():
    """tests/test_jax_analysis.py:127-134: with the host F0 in both, the
    device spectral stages keep the host geometry; mcep c0 mean |d| < 0.1,
    mcep mean |d| < 0.05, codeap max |d| < 0.1 dB (gates.py)."""
    m = gates.analyzer_metrics(CPU, FS)
    assert m["an_f0_equal"] and m["an_mcep_shape_equal"]
    assert not gates.gate_failures(m), gates.gate_failures(m)
