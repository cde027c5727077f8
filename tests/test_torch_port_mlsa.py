"""The port's MLSA filter and spectral emphasis against the JAX package's.

Tolerances (the JAX package's MLSA has two engines, and each check names
the one it ran against):
  * the port's one-shot filter (the float64 C++ core, `csrc/qpdsp.cpp`)
    against JAX's native float64 core (`native/libqpdsp.so`, built with
    -march=native, which may contract FMAs): within 1e-12 of scale;
  * against its own plain per-sample version: bit for bit (the core is
    built with -ffp-contract=off and the plain loop runs the same IEEE
    operations in the same order);
  * chunked against one-shot, the filter state carried: bit for bit;
  * the streaming filter against JAX's StreamingEmphasizer (a float32
    scan): within 1e-5 of scale;
  * emphasize and filter_wav_file against JAX's: int16 within 1 LSB.
"""

import numpy as np
import pytest
from scipy.io import wavfile
from scipy.signal import firwin, lfilter

from qpnet_tpu.dsp import emphasis as JE
from qpnet_tpu.dsp import mlsa as JM
from qpnet_tpu.dsp import native as JN
from qpnet_tpu.dsp.mcep import mc2b as jax_mc2b
from qpnet_tpu_torch import dsp as TD
from qpnet_tpu_torch.dsp import emphasis as TE
from qpnet_tpu_torch.dsp import mlsa as TM
from qpnet_tpu_torch.dsp import native as TN
from qpnet_tpu_torch.dsp.mcep import mc2b

FS = 16000


def _scale(a):
    return float(np.abs(a).max())


def _coefs(rng, F, M, s=0.2):
    mc = rng.normal(size=(F, M + 1)) * s
    b = mc2b(mc, 0.41)
    np.testing.assert_array_equal(b, jax_mc2b(mc, 0.41))
    return b


def test_dsp_exports_mlsa_as_jax_does():
    assert TD.mlsa_filter is TM.mlsa_filter
    assert TD.synthesis_diff is TM.synthesis_diff


@pytest.mark.parametrize("pd", [4, 5])
def test_core_against_jax_native_and_the_plain_loop(pd):
    """Frame-varying coefficients: the JAX package's native engine within
    1e-12 of scale; the plain per-sample loop bit for bit; JAX's float32
    scan engine within float32 rounding (5e-6 of scale)."""
    assert JN.available(), "the JAX package's native engine did not build"
    rng = np.random.default_rng(pd)
    x = rng.normal(size=3000)
    b = _coefs(rng, 12, 24)
    y = TM.mlsa_filter(x, b, 0.41, 250, pd=pd)
    native = JN.mlsa_filter(x, b, 0.41, 250, pd=pd)
    assert np.abs(y - native).max() <= 1e-12 * _scale(native)
    plain, _ = TM.mlsa_filter_plain(x, b, 0.41, 250, pd=pd)
    np.testing.assert_array_equal(y, plain)
    scan = np.asarray(JM._mlsa_scan(np.asarray(x, np.float32),
                                    np.asarray(b, np.float32), 0.41, pd,
                                    250), np.float64)
    assert np.abs(y - scan).max() <= 5e-6 * _scale(y)


def test_jax_mlsa_filter_runs_its_native_engine():
    """qpnet_tpu.dsp.mlsa.mlsa_filter (the engine the JAX recipe runs)
    is its native core here, and the port holds to it within 1e-12."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=2000)
    b = _coefs(rng, 5, 20)
    want = JM.mlsa_filter(x, b, 0.455, 400)
    np.testing.assert_array_equal(want, JN.mlsa_filter(x, b, 0.455, 400))
    got = TM.mlsa_filter(x, b, 0.455, 400)
    assert np.abs(got - want).max() <= 1e-12 * _scale(want)


def test_identity_and_gain():
    rng = np.random.default_rng(2)
    x = rng.normal(size=2000)
    b = np.zeros((3, 20))
    np.testing.assert_array_equal(TM.mlsa_filter(x, b, 0.455, 700), x)
    b[:, 0] = 0.5
    np.testing.assert_allclose(TM.mlsa_filter(x, b, 0.455, 700),
                               x * np.exp(0.5), rtol=1e-15)


@pytest.mark.parametrize("chunks", [(1, 999, 1, 999), (250,) * 8,
                                    (1713, 287)])
@pytest.mark.parametrize("pd", [4, 5])
def test_chunked_equals_one_shot_bit_for_bit(chunks, pd):
    """The carried state (two exp-filter stages and the sample counter):
    any chunking, frame switches falling inside chunks, gives the one-shot
    output bit for bit, and the plain loop carries the same state."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=sum(chunks))
    b = _coefs(rng, 9, 16)
    one = TM.mlsa_filter(x, b, 0.41, 230, pd=pd)
    carry = TM.mlsa_init_state(16, pd)
    plain_carry = TM.mlsa_init_state(16, pd)
    outs, start = [], 0
    for n in chunks:
        y, carry = TM.mlsa_filter_stateful(x[start:start + n], b, carry,
                                           0.41, pd, 230)
        yp, plain_carry = TM.mlsa_filter_plain(x[start:start + n], b, 0.41,
                                               230, pd, plain_carry)
        np.testing.assert_array_equal(y, yp)
        np.testing.assert_array_equal(carry[0], plain_carry[0])
        outs.append(y)
        start += n
    assert carry[1] == plain_carry[1] == len(x)
    np.testing.assert_array_equal(np.concatenate(outs), one)


def test_core_rejects_bad_arguments():
    x = np.zeros(10)
    with pytest.raises(ValueError, match="state"):
        TN.mlsa_filter_state(x, np.zeros((1, 5)), 0.4, 10, 4, np.zeros(3), 0)
    with pytest.raises(RuntimeError, match="rc=1"):
        TN.mlsa_filter_state(x, np.zeros((1, 5)), 0.4, 10, 3,
                             np.zeros(2 * (3 + 3 * 4)), 0)
    with pytest.raises(ValueError, match="pd"):
        TM.mlsa_init_state(4, 6)


@pytest.mark.parametrize("n_taps", [1, 31, 255])
def test_fir_core_against_lfilter_and_chunked(n_taps):
    rng = np.random.default_rng(n_taps)
    x = rng.normal(size=1500)
    taps = firwin(n_taps, 0.25) if n_taps > 1 else np.array([0.7])
    one = TN.fir(x, taps)
    np.testing.assert_allclose(one, lfilter(taps, 1, x), rtol=0,
                               atol=1e-13 * _scale(x))
    hist, outs, start = np.zeros(n_taps - 1), [], 0
    for n in (7, 1, 400, 1092):
        y, hist = TN.fir_state(x[start:start + n], taps, hist)
        outs.append(y)
        start += n
    np.testing.assert_array_equal(np.concatenate(outs), one)


MC = np.array([0.0, 0.4, -0.2, 0.1, -0.05, 0.02, 0.0, 0.01, 0.0, -0.01])


@pytest.mark.parametrize("highpass", [True, False])
@pytest.mark.parametrize("chunks", [(4096,), (500, 1, 1595, 1000, 1000),
                                    (64,) * 64])
def test_streaming_emphasizer_against_jax_and_one_shot(chunks, highpass):
    """The port's streaming filter against the JAX package's (float32 scan)
    within 1e-5 of scale for each chunking, with and without the 70 Hz
    high-pass; against the port's one-shot emphasize (or the bare MLSA
    filter) bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=sum(chunks)) * 0.3
    t = TE.StreamingEmphasizer(FS, MC, 0.41, shiftms=5.0, highpass=highpass)
    j = JE.StreamingEmphasizer(FS, MC, 0.41, shiftms=5.0, highpass=highpass)
    outs_t, outs_j, start = [], [], 0
    for n in chunks:
        outs_t.append(t.process(x[start:start + n]))
        outs_j.append(j.process(x[start:start + n]))
        start += n
    yt, yj = np.concatenate(outs_t), np.concatenate(outs_j)
    assert np.abs(yt - yj).max() <= 1e-5 * _scale(yj)
    if highpass:
        one = TE.emphasize(x, FS, MC, 0.41, 5.0)
    else:
        one = TM.synthesis_diff(x, np.tile(MC, (TE.frame_count(
            len(x), FS, 5.0), 1)), 0.41, 5.0, FS)
    np.testing.assert_array_equal(yt, one)


def _stats(tmp_path, rng, dim=39):
    path = str(tmp_path / "stats.h5")
    from qpnet_tpu.data.h5io import write_hdf5
    write_hdf5(path, "/world/mean", rng.normal(size=dim) * 0.3)
    write_hdf5(path, "/world/scale", np.ones(dim))
    return path


@pytest.mark.parametrize("invert", [True, False])
def test_emphasis_coefs_emphasize_and_filter_wav_file(tmp_path, invert):
    """emphasis_coefs equal; emphasize within 1e-12 of scale of JAX's
    (native engine); filter_wav_file's int16 within 1 LSB, float wavs
    within 1e-12 of scale; a sample-rate mismatch raises."""
    rng = np.random.default_rng(5)
    stats = _stats(tmp_path, rng)
    ct = TE.emphasis_coefs(stats, "world", 2, 27, 0.5, invert)
    cj = JE.emphasis_coefs(stats, "world", 2, 27, 0.5, invert)
    np.testing.assert_array_equal(ct, cj)
    x = rng.normal(size=8000) * 3000
    yt = TE.emphasize(x, FS, ct, 0.41, 5.0)
    yj = JE.emphasize(x, FS, cj, 0.41, 5.0)
    assert np.abs(yt - yj).max() <= 1e-12 * _scale(yj)
    src = str(tmp_path / "in.wav")
    wavfile.write(src, FS, np.clip(x, -32768, 32767).astype(np.int16))
    TE.filter_wav_file(src, str(tmp_path / "t" / "o.wav"), FS, ct, 0.41, 5.0)
    JE.filter_wav_file(src, str(tmp_path / "j" / "o.wav"), FS, cj, 0.41, 5.0)
    (ft, wt), (fj, wj) = (wavfile.read(str(tmp_path / d / "o.wav"))
                          for d in "tj")
    assert ft == fj == FS and wt.dtype == wj.dtype == np.int16
    assert np.abs(wt.astype(int) - wj.astype(int)).max() <= 1
    srcf = str(tmp_path / "inf.wav")
    wavfile.write(srcf, FS, (x / 32768).astype(np.float32))
    TE.filter_wav_file(srcf, str(tmp_path / "tf.wav"), FS, ct, 0.41, 5.0)
    JE.filter_wav_file(srcf, str(tmp_path / "jf.wav"), FS, cj, 0.41, 5.0)
    a, b = (wavfile.read(str(tmp_path / f))[1] for f in ("tf.wav", "jf.wav"))
    assert a.dtype == b.dtype == np.float64
    assert np.abs(a - b).max() <= 1e-12 * _scale(b)
    with pytest.raises(ValueError, match="sample rate"):
        TE.filter_wav_file(src, str(tmp_path / "x.wav"), 22050, ct, 0.41, 5.0)


def _welch_db(x, fftl=256):
    n = (len(x) // fftl) * fftl
    frames = x[:n].reshape(-1, fftl) * np.hanning(fftl)
    ps = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    return 10 * np.log10(np.maximum(ps.mean(axis=0), 1e-30))


def test_noise_shaping_round_trip():
    """tests/test_dsp_mlsa.py's round trip through the port: shaping with
    flipped signs then restoring with the original ones gives the input
    spectrum back within 0.5 dB, and the shaping alone moves it > 1 dB."""
    fs, alpha, shiftms = 16000, 0.41, 5.0
    rng = np.random.default_rng(3)
    x = rng.normal(size=40000)
    mc = np.zeros(25)
    mc[1:6] = [0.4, -0.25, 0.15, -0.1, 0.05]
    F = int(len(x) / (fs * shiftms / 1000)) + 1
    coef_fwd = np.tile(mc, (F, 1)).copy()
    coef_fwd[:, 1:] *= -1.0
    shaped = TM.synthesis_diff(x, coef_fwd, alpha, shiftms, fs)
    restored = TM.synthesis_diff(shaped, np.tile(mc, (F, 1)), alpha,
                                 shiftms, fs)
    a, c, s = _welch_db(x), _welch_db(restored), _welch_db(shaped)
    sl = slice(4, 124)
    assert np.abs((c - a)[sl]).mean() < 0.5
    assert np.abs((s - a)[sl]).mean() > 1.0
    np.testing.assert_allclose(
        shaped, JM.synthesis_diff(x, coef_fwd, alpha, shiftms, fs),
        rtol=0, atol=1e-12 * _scale(shaped))
