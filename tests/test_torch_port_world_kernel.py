"""PyTorch port vs the JAX package: the device WORLD analysis's sequential
stages (`qpnet_tpu_torch/ops/world_kernel.py`, kernels W1-W4 on the card),
run on the CPU through their plain versions against the JAX stages they
replace, on inputs made from seeds with numpy.

Tolerances:
  * W1 pooling (jax_f0._pool_candidates) and W3 FixF0Contour steps 3-4
    (jax_f0._fix_contour_scan): bit-equal, ties on spread and the 5% edge
    included;
  * W2 Viterbi (jax_f0._viterbi): the state path equal, f0 within 1e-6
    relative (f0 is a copy of a refined value, so equal states give equal
    f0); exact cost ties pin the first-index rule;
  * W4 smoothing (jax_analysis._jax_linear_smoothing): within 1e-6
    relative on positive spectra (XLA on the CPU may contract or reorder
    the sum over offsets).

The kernels themselves build and run only on the card, where chip_smoke.py
phase 15 holds each against its plain version bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.dsp.world import jax_analysis, jax_f0
from qpnet_tpu_torch.dsp.world import device_analysis, device_f0
from qpnet_tpu_torch.dsp.world.device_analysis import device_analyze
from qpnet_tpu_torch.ops import world_kernel as WK

POS = 1e30           # a screened-out candidate's spread (device_f0._POS)
THRESHOLD = 0.10     # harvest's agreement threshold
K = 6                # harvest's max_candidates
TC, UC = 8.0, 0.35   # harvest's transition and unvoiced costs


def _t(a, dtype=np.float32):
    return torch.as_tensor(np.asarray(a, dtype))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# W1: candidate pooling
# ---------------------------------------------------------------------------

def _pool_inputs(seed, n_ch=14, F=96):
    """(n_ch, F) candidates and spreads: per frame a base of 20*m Hz with
    candidates at exactly +-5% of it (21m, 19m: |f - p| equals
    0.05*p in float32, so they are kept), one ulp inside the edge (a
    duplicate), octave errors, zeros, and spreads drawn from a few values
    (ranks tie; 0.1 is the threshold itself) or screened out."""
    rng = np.random.default_rng(seed)
    m = rng.integers(4, 16, size=F).astype(np.float32)
    base = 20.0 * m
    edge_in = np.nextafter(21.0 * m, np.float32(0.0)).astype(np.float32)
    choices = np.stack([base, 21.0 * m, 19.0 * m, edge_in, 2.0 * base,
                        0.5 * base, base * 1.02, np.zeros(F, np.float32)])
    pick = rng.integers(0, len(choices), size=(n_ch, F))
    cands = choices[pick, np.arange(F)[None, :]].astype(np.float32)
    levels = np.array([0.01, 0.02, 0.05, THRESHOLD, 0.2, POS], np.float32)
    spreads = levels[rng.integers(0, len(levels), size=(n_ch, F))]
    spreads[cands == 0] = POS
    return cands, spreads


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_matches_jax_bit_equal(seed):
    cands, spreads = _pool_inputs(seed)
    want = np.asarray(jax_f0._pool_candidates(_j(cands), _j(spreads),
                                              THRESHOLD, K))
    got = device_f0._pool_candidates(_t(cands), _t(spreads), THRESHOLD,
                                     K).numpy()
    assert got.shape == want.shape == (cands.shape[1], K)
    np.testing.assert_array_equal(got, want)
    # the inputs reach both rules: kept edges, dropped duplicates, full rows
    assert np.any(np.isin(got, cands[cands > 0]))
    assert (got > 0).sum(1).max() >= 3


def test_pool_edge_and_tie_cases():
    """One frame per rule, against JAX bit for bit: +5% and -5% of a kept
    candidate are kept, one ulp inside is a duplicate, a spread of exactly
    the threshold agrees, equal spreads keep the channel order, and no
    frame keeps more than K."""
    f, sp = np.zeros((8, 4), np.float32), np.full((8, 4), POS, np.float32)
    f[:3, 0], sp[:3, 0] = [100.0, 105.0, 95.0], 0.05
    f[:2, 1], sp[:2, 1] = [200.0, np.nextafter(np.float32(210.0),
                                                np.float32(0.0))], 0.05
    f[:3, 2], sp[:3, 2] = [150.0, 300.0, 75.0], [THRESHOLD, 0.01, 0.01]
    f[:, 3], sp[:, 3] = 100.0 * 1.2 ** np.arange(8), 0.02
    want = np.asarray(jax_f0._pool_candidates(_j(f), _j(sp), THRESHOLD, K))
    got = device_f0._pool_candidates(_t(f), _t(sp), THRESHOLD, K).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :3], [100.0, 105.0, 95.0])
    np.testing.assert_array_equal(got[1, :2], [200.0, 0.0])
    np.testing.assert_array_equal(got[2, :3], [300.0, 75.0, 150.0])
    np.testing.assert_array_equal(got[3], f[:K, 3])


# ---------------------------------------------------------------------------
# W2: the Viterbi
# ---------------------------------------------------------------------------

def _states(f0, refined):
    """The state path behind f0: 0 where unvoiced, else 1 + the column of
    refined (distinct per frame) it copies."""
    hit = refined == f0[:, None]
    assert np.all(hit.sum(1)[f0 > 0] == 1)
    return np.where(f0 > 0, hit.argmax(1) + 1, 0)


def _viterbi_both(refined, score):
    want = np.asarray(jax_f0._viterbi(_j(refined), _j(score), TC, UC))
    got = device_f0._viterbi(_t(refined), _t(score), TC, UC).numpy()
    return got, want


def _viterbi_inputs(seed, F):
    """Candidates around a wandering contour (scored higher) with octave
    errors, invalid (0) candidates and unvoiced stretches; values distinct
    per frame."""
    rng = np.random.default_rng(seed)
    track = 150.0 * np.exp(np.cumsum(rng.normal(0, 0.02, F)))
    mult = rng.choice([1.0, 2.0, 0.5, 1.3], size=(F, K), p=[.4, .2, .2, .2])
    refined = track[:, None] * mult * (1 + rng.normal(0, 0.01, (F, K)))
    refined[rng.random((F, K)) < 0.25] = 0.0
    refined[(np.arange(F) // 17) % 4 == 3] = 0.0
    score = np.where(mult == 1.0, rng.uniform(0.6, 1.0, (F, K)),
                     rng.uniform(0.0, 0.7, (F, K)))
    return refined.astype(np.float32), score.astype(np.float32)


@pytest.mark.parametrize("seed,F", [(0, 1), (1, 2), (2, 3), (3, 200),
                                    (4, 601)])
def test_viterbi_matches_jax(seed, F):
    refined, score = _viterbi_inputs(seed, F)
    got, want = _viterbi_both(refined, score)
    np.testing.assert_array_equal(_states(got, refined),
                                  _states(want, refined))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
    if F >= 200:
        assert 0.2 < (got > 0).mean() < 0.95


def test_viterbi_ties_take_the_first_index():
    """Exact cost ties: the final argmin between two equally scored
    candidates (F=1) keeps the first; at F=2 the unvoiced frame 1 is
    reached at equal cost (0.35) from frame 0's unvoiced state and both
    perfect candidates, and the back-pointer keeps state 0."""
    refined = np.zeros((1, K), np.float32)
    refined[0, :2] = [150.0, 200.0]
    score = np.zeros((1, K), np.float32)
    score[0, :2] = 0.9
    got, want = _viterbi_both(refined, score)
    np.testing.assert_array_equal(got, [150.0])
    np.testing.assert_array_equal(want, [150.0])

    refined = np.zeros((2, K), np.float32)
    refined[0, :2] = [150.0, 200.0]
    score = np.zeros((2, K), np.float32)
    score[0, :2] = 1.0
    got, want = _viterbi_both(refined, score)
    np.testing.assert_array_equal(got, [0.0, 0.0])
    np.testing.assert_array_equal(want, [0.0, 0.0])


# ---------------------------------------------------------------------------
# W3: FixF0Contour steps 3-4
# ---------------------------------------------------------------------------

def _contour_inputs(seed, C=6, F=240):
    """tests/test_jax_f0.py's random voiced sections with near-continuous
    candidates, octave candidates, junk-free gaps and 5% dropouts."""
    rng = np.random.default_rng(seed)
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
    return f0.astype(np.float32), cands.astype(np.float32)


def _contour_both(f0, cands, f0_floor=90.0):
    want = np.asarray(jax_f0._fix_contour_scan(_j(f0), _j(cands), 5.0, 0.1,
                                               f0_floor))
    got = device_f0._fix_contour_scan(_t(f0), _t(cands), 5.0, 0.1,
                                      f0_floor).numpy()
    return got, want


@pytest.mark.parametrize("seed", range(8))
def test_fix_contour_matches_jax_bit_equal(seed):
    f0, cands = _contour_inputs(seed)
    got, want = _contour_both(f0, cands)
    np.testing.assert_array_equal(got, want)
    # the walks extended sections into frames that were unvoiced
    assert np.any((got > 0) & (f0 == 0))


def test_fix_contour_onset_and_frame_zero_bit_equal():
    """tests/test_jax_f0.py's onset pattern: a backward chain that survives
    to the start leaves frame 0 unvoiced in both."""
    F, C = 30, 4
    f0 = np.zeros(F, np.float32)
    f0[5:21] = 150.0
    cands = np.full((C, F), 150.0, np.float32)
    got, want = _contour_both(f0, cands)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0 and got[1] > 0.0


def test_fix_contour_short_input_returns_f0():
    """n <= vrm: the early return before any walk, in both packages."""
    f0 = np.linspace(100, 120, 5).astype(np.float32)
    cands = np.tile(f0, (3, 1))
    got, want = _contour_both(f0, cands)
    np.testing.assert_array_equal(got, f0)
    np.testing.assert_array_equal(want, f0)


# ---------------------------------------------------------------------------
# W4: fractional-box smoothing
# ---------------------------------------------------------------------------

FS = 22050


@pytest.mark.parametrize("stage,fft,kmax,lo_hz,hi_hz", [
    # CheapTrick: fftl 1024, kmax from ceil_f0 = 500 Hz, width 2*f0/3
    ("cheaptrick", 1024, 10, 30.0, 333.0),
    # D4C: fft 2048 at 22,050 Hz, kmax from f0_ceil 1000 Hz, widths cf0/2, cf0
    ("d4c", 2048, 49, 23.5, 1000.0)])
def test_smoothing_matches_jax(stage, fft, kmax, lo_hz, hi_hz):
    rng = np.random.default_rng(len(stage))
    F = 40
    spec = np.exp(rng.normal(0, 2, (F, fft // 2 + 1))).astype(np.float32)
    width = rng.uniform(lo_hz, hi_hz, F).astype(np.float32)
    want = np.asarray(jax_analysis._jax_linear_smoothing(
        _j(spec), _j(width), FS, fft, kmax))
    got = device_analysis._linear_smoothing(_t(spec), _t(width), FS, fft,
                                            kmax).numpy()
    assert got.shape == spec.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _wrapper_calls(dev):
    z = dict(dtype=torch.float32, device=dev)
    return {
        "pool": lambda: WK.pool(torch.ones((3, 5), **z),
                                torch.zeros((3, 5), **z), 0.1, K),
        "viterbi": lambda: WK.viterbi(torch.ones((5, K + 1), **z),
                                      torch.zeros((5, K), **z),
                                      torch.ones((5, K), **z), TC, UC),
        "fix_contour": lambda: WK.fix_contour(torch.ones(5, **z),
                                              torch.ones((5, 3), **z), 0.1),
        "smooth": lambda: WK.smooth(torch.ones((2, 9), **z),
                                    torch.ones((2, 4), **z)),
    }


def test_wrappers_on_the_cpu_run_the_plain_versions_uncounted():
    WK.reset_launch_count()
    out = {k: fn() for k, fn in _wrapper_calls(torch.device("cpu")).items()}
    assert {k: WK.launch_count(k) for k in WK.KERNELS} == dict.fromkeys(
        WK.KERNELS, 0)
    assert out["pool"].shape == (5, K) and out["viterbi"].shape == (5,)
    assert out["fix_contour"].shape == (5,) and out["smooth"].shape == (2, 5)
    np.testing.assert_array_equal(out["smooth"].numpy(), np.full((2, 5), 4.0))


@pytest.mark.parametrize("name", WK.KERNELS)
def test_wrappers_refuse_other_devices(name):
    with pytest.raises(ValueError, match="CUDA or CPU"):
        _wrapper_calls(torch.device("meta"))[name]()


def test_fused_pass_goes_through_the_wrappers(monkeypatch):
    """The whole slice on the CPU: device_analyze with harvest calls W1 and
    W2 once and W4 four times (CheapTrick once, D4C three times); with dio
    it calls W3 once; each call's result is the plain version's."""
    calls = []
    for name in WK.KERNELS:
        fn = getattr(WK, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(WK, name, counted)
    rng = np.random.default_rng(7)
    fs, n = 16000, 16000
    t = np.arange(n) / fs
    x = np.sin(2 * np.pi * np.cumsum(140 + 5 * np.sin(2 * np.pi * 5 * t))
               / fs) + 0.02 * rng.standard_normal(n)
    kw = dict(n_valid=n, f_valid=n // 80 + 1, alpha=0.41, fft_size=512,
              mcep_dim=24, f0_floor=60.0, f0_ceil=400.0, device="cpu")
    f0, mcep, codeap, npow = device_analyze(_t(x), fs, **kw)
    assert sorted(calls) == ["pool"] + ["smooth"] * 4 + ["viterbi"]
    assert 0.5 < float((f0 > 0).float().mean()) and torch.isfinite(mcep).all()
    calls.clear()
    device_analyze(_t(x), fs, f0_analyzer="dio", **kw)
    assert sorted(calls) == ["fix_contour"] + ["smooth"] * 4
