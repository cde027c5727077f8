"""PyTorch port vs the JAX package: the float64 host DSP (filters, continuous
F0, mel-cepstra, the aperiodicity codec and the WORLD host estimators) and
`WorldAnalyzer(backend="numpy")` must be bit-equal to the JAX package's host
path, the reference-parity default.  One rate and length (16 kHz, 1 s) for
the whole file; signals are made from seeds with numpy."""

import importlib

import numpy as np
import pytest

from qpnet_tpu.dsp import contf0 as jcontf0
from qpnet_tpu.dsp import filters as jfilters
from qpnet_tpu.dsp import mcep as jmcep
from qpnet_tpu.dsp.world import WorldAnalyzer as JaxAnalyzer
from qpnet_tpu.tools.make_synth_corpus import synth_utterance
from qpnet_tpu_torch.dsp import contf0, filters, mcep
from qpnet_tpu_torch.dsp.world import WorldAnalyzer


def _modules(pkg):
    # the world packages export functions under their modules' names
    return [importlib.import_module(f"{pkg}.dsp.world.{m}") for m in (
        "api", "cheaptrick", "codec", "common", "d4c", "dio", "harvest",
        "refine", "stonemask")]


(world_api, cheaptrick, codec, common, d4c, dio, harvest, refine,
 stonemask) = _modules("qpnet_tpu_torch")
(jworld_api, jct, jcodec, jcommon, jd4c, jdio, jharvest, jrefine,
 jstonemask) = _modules("qpnet_tpu")

FS = 16000
N = FS
F0_RANGE = dict(f0_floor=60.0, f0_ceil=400.0)


def _vibrato(f0_base=140.0, amp_h2=0.4, noise=0.02, seed=0, n=N):
    """tests/test_jax_f0.py's vibrato tone."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    f0 = f0_base + 5.0 * np.sin(2 * np.pi * 5.0 * t)
    phase = 2 * np.pi * np.cumsum(f0) / FS
    x = np.sin(phase) + amp_h2 * np.sin(2 * phase + 1.0)
    return x + noise * rng.standard_normal(n)


def _sawtooth(seed=5, n=N):
    """tests/test_jax_analysis.py's gliding sawtooth at int16 scale."""
    rng = np.random.default_rng(seed)
    ph = np.cumsum(np.linspace(120, 180, n) / FS)
    return (0.5 * (2 * (ph % 1.0) - 1.0) + 0.01 * rng.normal(size=n)) * 12000


SIGNALS = {
    "vibrato": lambda: _vibrato() * 8000,
    "sawtooth": _sawtooth,
    "speech": lambda: synth_utterance(np.random.default_rng(5), FS, 1.0,
                                      150.0)[:N] * 9000,
}


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def tracks():
    """Host harvest of each signal: (x, f0, time_axis), from the JAX
    package (the port's own harvest is held to it below)."""
    out = {}
    for name, make in SIGNALS.items():
        x = make()
        out[name] = (x, *jharvest.harvest(x, FS, **F0_RANGE))
    return out


def test_common_helpers_bit_equal():
    rng = np.random.default_rng(1)
    x = rng.normal(size=N)
    for n in (1, 7, 64, 255):
        _eq(common.nuttall(n), jcommon.nuttall(n))
        assert common.next_pow2(n) == jcommon.next_pow2(n)
    for v in (0.5, 1.5, 2.4999, -0.5, 7.5):
        assert common.matlab_round(v) == jcommon.matlab_round(v)
    for kind, ratio in (("blackman", 4.0), ("hanning", 3.0)):
        for f0, pos in ((47.0, 0.0), (133.3, 0.5), (400.0, 0.999)):
            _eq(common.get_windowed_waveform(x, FS, f0, pos, kind, ratio),
                jcommon.get_windowed_waveform(x, FS, f0, pos, kind, ratio))
    spec = np.abs(rng.normal(size=1025)) + 1e-3
    for f0 in (47.0, 150.0, 390.0):
        _eq(common.dc_correction(spec, f0, FS, 2048),
            jcommon.dc_correction(spec, f0, FS, 2048))
        _eq(common.linear_smoothing(spec, f0, FS, 2048),
            jcommon.linear_smoothing(spec, f0, FS, 2048))
    log_amp = rng.normal(size=513) * 0.3
    _eq(common.minimum_phase_spectrum(log_amp),
        jcommon.minimum_phase_spectrum(log_amp))


@pytest.mark.parametrize("cutoff", [70, 300])
def test_filters_bit_equal(cutoff):
    x = _vibrato(seed=2) * 3000
    _eq(filters.low_cut_filter(x, FS, cutoff=cutoff),
        jfilters.low_cut_filter(x, FS, cutoff=cutoff))
    _eq(filters.low_pass_filter(x, FS, cutoff=cutoff),
        jfilters.low_pass_filter(x, FS, cutoff=cutoff))


def test_continuous_f0_bit_equal(tracks):
    _, f0, _ = tracks["speech"]
    assert (f0 == 0).any() and (f0 > 0).any()
    for a, b in zip(contf0.convert_continuous_f0(f0),
                    jcontf0.convert_continuous_f0(f0)):
        _eq(a, b)
    for shift in (5.0, 10.0):
        for a, b in zip(contf0.smoothed_continuous_f0(f0, shift),
                        jcontf0.smoothed_continuous_f0(f0, shift)):
            _eq(a, b)
    # a track that rings below zero takes the widening escalation
    spiky = np.zeros(200)
    spiky[20:40], spiky[41:45], spiky[150:152] = 300.0, 40.0, 400.0
    for a, b in zip(contf0.smoothed_continuous_f0(spiky, 5.0),
                    jcontf0.smoothed_continuous_f0(spiky, 5.0)):
        _eq(a, b)
    unvoiced = np.zeros(50)
    for a, b in zip(contf0.smoothed_continuous_f0(unvoiced, 5.0),
                    jcontf0.smoothed_continuous_f0(unvoiced, 5.0)):
        _eq(a, b)


def test_mcep_bit_equal(tracks):
    x, f0, ta = tracks["vibrato"]
    sp = jct.cheaptrick(x, f0, ta, FS, fft_size=1024)
    for order, alpha in ((24, 0.41), (34, 0.455)):
        mc = mcep.sp2mc(sp, order, alpha)
        _eq(mc, jmcep.sp2mc(sp, order, alpha))
        _eq(mcep.sp2mc(sp[3], order, alpha), jmcep.sp2mc(sp[3], order, alpha))
        _eq(mcep.freqt(mc, 40, -alpha), jmcep.freqt(mc, 40, -alpha))
        _eq(mcep.mc2sp(mc, alpha, 1024), jmcep.mc2sp(mc, alpha, 1024))
        _eq(mcep.mc2b(mc, alpha), jmcep.mc2b(mc, alpha))
        _eq(mcep.b2mc(mc, alpha), jmcep.b2mc(mc, alpha))
    npow = mcep.spectrogram2npow(sp)
    _eq(npow, jmcep.spectrogram2npow(sp))
    _eq(mcep.spvec2pow(sp[7]), jmcep.spvec2pow(sp[7]))
    for a, b in zip(mcep.extfrm(sp, npow, -20), jmcep.extfrm(sp, npow, -20)):
        _eq(a, b)


@pytest.mark.parametrize("fs", [8000, 16000, 22050, 24000])
def test_codec_bit_equal(fs):
    rng = np.random.default_rng(fs)
    ap = np.clip(rng.uniform(size=(9, 513)), 1e-6, 1.0)
    assert codec.n_aperiodicity_bands(fs) == jcodec.n_aperiodicity_bands(fs)
    _eq(codec.band_frequencies(fs), jcodec.band_frequencies(fs))
    coded = codec.code_aperiodicity(ap, fs)
    _eq(coded, jcodec.code_aperiodicity(ap, fs))
    _eq(codec.decode_aperiodicity(coded, fs, 1024),
        jcodec.decode_aperiodicity(coded, fs, 1024))
    _eq(codec.expand_coarse(ap[0, :coded.shape[1]], fs, 1024),
        jcodec.expand_coarse(ap[0, :coded.shape[1]], fs, 1024))


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_harvest_bit_equal(tracks, name):
    x, f0, ta = tracks[name]
    got, got_ta = harvest.harvest(x, FS, **F0_RANGE)
    _eq(got, f0)
    _eq(got_ta, ta)
    assert (f0 > 0).mean() > 0.5                # the estimator tracked


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_dio_stonemask_bit_equal(name):
    x = SIGNALS[name]()
    f0, ta = dio.dio(x, FS, **F0_RANGE)
    jf0, jta = jdio.dio(x, FS, **F0_RANGE)
    _eq(f0, jf0)
    _eq(ta, jta)
    _eq(stonemask.stonemask(x, f0, ta, FS),
        jstonemask.stonemask(x, jf0, jta, FS))
    assert (f0 > 0).mean() > 0.3


def test_dio_constants_and_refine_bit_equal(tracks):
    assert dio.decimation_plan(N, FS, 400.0) == jdio.decimation_plan(
        N, FS, 400.0)
    assert dio.decimation_plan(N, FS, 4000.0) == jdio.decimation_plan(
        N, FS, 4000.0)
    bounds = 60.0 * 2.0 ** (np.arange(1, 9) / 2.0)
    _eq(dio.band_lowpass_responses(bounds, 4000.0, 8192),
        jdio.band_lowpass_responses(bounds, 4000.0, 8192))
    x, f0, ta = tracks["speech"]
    _eq(refine.refine_many(x, FS, ta, f0), jrefine.refine_many(x, FS, ta, f0))
    # the host contour fixing on a random candidate table
    rng = np.random.default_rng(3)
    cands = np.where(rng.random((4, 200)) < 0.7,
                     150.0 * (1 + 0.01 * rng.normal(size=(4, 200))), 0.0)
    track = np.where(rng.random(200) < 0.9, cands[0], 0.0)
    _eq(dio._fix_contour(track, cands, 5.0, 0.1, f0_floor=60.0),
        jdio._fix_contour(track, cands, 5.0, 0.1, f0_floor=60.0))


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_cheaptrick_bit_equal(tracks, name):
    x, f0, ta = tracks[name]
    for fftl, floor in ((1024, 71.0), (2048, 60.0)):
        _eq(cheaptrick.cheaptrick(x, f0, ta, FS, fft_size=fftl,
                                  f0_floor=floor),
            jct.cheaptrick(x, f0, ta, FS, fft_size=fftl, f0_floor=floor))
    assert cheaptrick.DEFAULT_F0 == jct.DEFAULT_F0 and cheaptrick.Q1 == jct.Q1


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_d4c_bit_equal(tracks, name):
    x, f0, ta = tracks[name]
    ap = d4c.d4c(x, f0, ta, FS, fft_size=1024)
    _eq(ap, jd4c.d4c(x, f0, ta, FS, fft_size=1024))
    assert (ap < 0.99).any()                    # voiced frames were coded
    for k in ("UNVOICED_AP", "FLOOR_F0_D4C", "LOVE_TRAIN_LOWEST_F0",
              "LOVE_TRAIN_THRESHOLD"):
        assert getattr(d4c, k) == getattr(jd4c, k)


def test_bucket_pad_signal_equal():
    for n in (1, FS - 1, FS, FS + 1):
        x = np.random.default_rng(n).normal(size=n)
        a, na = world_api._bucket_pad_signal(x, FS)
        b, nb = jworld_api._bucket_pad_signal(x, FS)
        _eq(a, b)
        assert na == nb == n


@pytest.mark.parametrize("f0_analyzer", ["harvest", "dio"])
def test_world_analyzer_numpy_bit_equal(f0_analyzer):
    """analyze, mcep, codeap and npow of the host backend; the analyzer
    never touches a device, so the default device="cuda" is fine here."""
    x = SIGNALS["speech"]()
    kw = dict(fs=FS, minf0=60, maxf0=400, f0_analyzer=f0_analyzer)
    port, ref = WorldAnalyzer(**kw), JaxAnalyzer(**kw)
    for a, b in zip(port.analyze(x), ref.analyze(x)):
        _eq(a, b)
    _eq(port.mcep(dim=24, alpha=0.41), ref.mcep(dim=24, alpha=0.41))
    _eq(port.codeap(), ref.codeap())
    _eq(port.npow(), ref.npow())
    with pytest.raises(RuntimeError, match="analyze"):
        WorldAnalyzer(**kw).mcep()
