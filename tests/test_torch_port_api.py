"""PyTorch port vs the JAX package: the high-level `Vocoder` API on the CPU
(the generation kernel's plain twin), loading experiments the JAX package
wrote.  `synthesize` must write what the port's decode CLI writes, F0 scaling
included, and equal JAX's `Vocoder(interpret=True)` in argmax mode; the
conditioning contract, batch order and lengths, and session reuse of
`stream` follow the JAX API.  `analyze` on the host backend and `vocode`
through it equal JAX's bit for bit, PCM rescaling included; `analyze` on
the device backend (the default) stays within
tests/test_torch_port_dsp_device.py's tolerances of JAX's."""

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from qpnet_tpu import Vocoder as JaxVocoder
from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.config import RunConfig as JaxRunConfig
from qpnet_tpu.data.h5io import write_hdf5
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.tools.make_synth_corpus import synth_utterance
from qpnet_tpu.train.checkpoint import save_checkpoint, save_final
from qpnet_tpu_torch import Vocoder
from qpnet_tpu_torch.data.stats import Scaler, load_scaler
from qpnet_tpu_torch.models.generate import StreamingGenerator
from qpnet_tpu_torch.ops import decode_mu_law, dilated_factor

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=2,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=5)
FS = 1000
AN_FS = 16000


@pytest.fixture(scope="module")
def expdir(tmp_path_factory):
    """A JAX-written experiment: model.conf, checkpoint-final.pkl,
    checkpoint-7.pkl, stats.h5 and one raw feature h5."""
    tmp = tmp_path_factory.mktemp("port_api")
    cfg = JaxConfig(**TINY)
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    save_final(str(tmp), params)
    save_checkpoint(str(tmp), params, None, 7)
    JaxRunConfig(model=cfg, fs=FS).save(str(tmp / "model.conf"))
    rng = np.random.default_rng(0)
    write_hdf5(str(tmp / "stats.h5"), "/world/mean",
               rng.normal(size=cfg.n_aux))
    write_hdf5(str(tmp / "stats.h5"), "/world/scale",
               rng.uniform(0.5, 2.0, cfg.n_aux))
    F = 11
    feats = np.abs(rng.normal(size=(F, cfg.n_aux))) + 0.1
    feats[:, 1] = rng.uniform(80.0, 120.0, F)        # d = fs/(f0*8) < 2
    write_hdf5(str(tmp / "utt1.h5"), "/world", feats)
    return tmp, cfg, params, feats


@pytest.fixture(scope="module")
def an_expdir(tmp_path_factory):
    """A JAX-written experiment with the 16 kHz analysis geometry (n_aux =
    28: uv, cont-F0, 25 mcep, 1 codeap), its stats taken from the JAX host
    analysis of a 0.6 s synthetic utterance, and that utterance as a
    normalized float clip."""
    tmp = tmp_path_factory.mktemp("port_api_an")
    cfg = JaxConfig(**dict(TINY, n_aux=28))
    save_final(str(tmp), jax_init_params(jax.random.PRNGKey(1), cfg))
    JaxRunConfig(model=cfg, fs=AN_FS).save(str(tmp / "model.conf"))
    wav = synth_utterance(np.random.default_rng(2), AN_FS, 0.6, 150.0)
    jv = JaxVocoder(None, cfg, None, fs=AN_FS)
    feats = jv.analyze(wav, dsp_backend="numpy")
    write_hdf5(str(tmp / "stats.h5"), "/world/mean", feats.mean(0))
    write_hdf5(str(tmp / "stats.h5"), "/world/scale", feats.std(0) + 1e-3)
    return tmp, wav


def load(tmp, **kw):
    return Vocoder.load(str(tmp), stats=str(tmp / "stats.h5"), device="cpu",
                        **kw)


@pytest.mark.parametrize("f0_factor,quantize", [(1.0, "none"),
                                                (0.5, "none"),
                                                (1.5, "w8a8")])
def test_synthesize_matches_port_decode_cli(expdir, tmp_path, f0_factor,
                                            quantize):
    from qpnet_tpu_torch.bin import qpnet_decode

    tmp, cfg, _, feats = expdir
    lst = tmp_path / "feats.list"
    lst.write_text(str(tmp / "utt1.h5") + "\n")
    qpnet_decode.main([
        "--feats", str(lst), "--stats", str(tmp / "stats.h5"),
        "--config", str(tmp / "model.conf"),
        "--checkpoint", str(tmp / "checkpoint-final.pkl"),
        "--outdir", str(tmp_path / "out" / "feat_id.wav"), "--fs", str(FS),
        "--f0_factor", str(f0_factor), "--quantize", quantize,
        "--device", "cpu", "--verbose", "0"])
    _, want = wavfile.read(str(tmp_path / "out" / "utt1.wav"))
    voc = load(tmp, quantize=quantize)
    assert voc.fs == FS                              # from model.conf
    if f0_factor == 1.0:
        fs_got, got = wavfile.read(voc.synthesize_to_wav(
            feats, str(tmp_path / "api.wav")))
        assert fs_got == FS
    else:
        wav = voc.synthesize(feats, f0_factor=f0_factor)
        got = np.clip(wav * 32768, -32768, 32767).astype(np.int16)
    assert got.shape == (feats.shape[0] * cfg.upsampling_factor - 1,)
    np.testing.assert_array_equal(got, want)


def test_synthesize_matches_jax_vocoder_argmax(expdir):
    tmp, _, _, feats = expdir
    jv = JaxVocoder.load(str(tmp), stats=str(tmp / "stats.h5"),
                         mode="argmax", engine="pallas", interpret=True)
    want = jv.synthesize(feats, f0_factor=1.5)
    got = load(tmp, mode="argmax").synthesize(feats, f0_factor=1.5)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_conditioning_contract(expdir):
    """conditioning() is the decode CLI's math: the F0 column scaled before
    both the dilation factors and the standardization."""
    tmp, cfg, _, feats = expdir
    scaler = load_scaler(str(tmp / "stats.h5"), "world")
    h, d = load(tmp).conditioning(feats, f0_factor=1.5)
    manual = np.array(feats, np.float64)
    manual[:, 1] *= 1.5
    np.testing.assert_array_equal(
        d, dilated_factor(np.ascontiguousarray(manual[:, 1]), FS,
                          cfg.dense_factor).astype(np.float32))
    np.testing.assert_array_equal(h, scaler.transform(manual).astype(
        np.float32))
    jh, jd = JaxVocoder.load(str(tmp), stats=str(tmp / "stats.h5")
                             ).conditioning(feats, f0_factor=1.5)
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(d, jd)


def test_batch_preserves_input_order_and_lengths(expdir):
    tmp, cfg, _, feats = expdir
    rng = np.random.default_rng(3)
    voc = load(tmp, mode="argmax")
    lengths = [5, 11, 8]
    batch = []
    for F in lengths:
        f = np.abs(rng.normal(size=(F, cfg.n_aux))) + 0.1
        f[:, 1] = rng.uniform(80.0, 120.0, F)
        batch.append(f)
    wavs = voc.synthesize_batch(batch)
    up = cfg.upsampling_factor
    assert [w.shape[0] for w in wavs] == [F * up - 1 for F in lengths]
    for w in wavs:
        assert w.dtype == np.float32 and np.abs(w).max() <= 1.0
    # each row alone gives the same samples in argmax mode
    np.testing.assert_array_equal(voc.synthesize(batch[1]), wavs[1])


def test_stream_reuses_its_session_and_equals_the_generator(expdir):
    tmp, cfg, _, feats = expdir
    voc = load(tmp, mode="sampling")
    chunks1 = list(voc.stream(feats, chunk_samples=20))
    assert list(voc._streams) == [(2, 20)]          # (maxd bucket, chunk)
    chunks2 = list(voc.stream(feats, chunk_samples=20))
    assert len(voc._streams) == 1                   # cached and reused
    up = cfg.upsampling_factor
    assert [c.shape[0] for c in chunks1] == [20, 20, 15]
    np.testing.assert_array_equal(np.concatenate(chunks1),
                                  np.concatenate(chunks2))
    # the same feeds on a direct session
    h, d = voc.conditioning(feats)
    sess = StreamingGenerator(voc.params, voc.cfg, 1, maxd=2, seed=100,
                              min_chunk_samples=20, device="cpu")
    hp = np.concatenate([h, np.repeat(h[-1:], 1, 0)])
    dp = np.concatenate([d, np.repeat(d[-1:], 1)])
    mu = np.concatenate([sess.feed(hp[None, s:s + 4], dp[None, s:s + 4])[0]
                         for s in range(0, 12, 4)])[: feats.shape[0] * up]
    np.testing.assert_array_equal(np.concatenate(chunks1),
                                  decode_mu_law(mu, cfg.n_quantize))
    list(voc.stream(feats, chunk_samples=40))
    assert len(voc._streams) == 2                   # a new chunk length


def test_load_by_iteration_and_scaler_object(expdir):
    tmp, cfg, _, feats = expdir
    sc = Scaler.from_stats(np.zeros(cfg.n_aux), np.ones(cfg.n_aux))
    voc = Vocoder.load(str(tmp), checkpoint=7, stats=sc, mode="argmax",
                       device="cpu")
    assert voc.synthesize(feats[:4]).shape == (4 * cfg.upsampling_factor - 1,)


def test_feats_shape_validated(expdir):
    tmp, cfg, _, _ = expdir
    voc = load(tmp)
    with pytest.raises(ValueError, match="feats must be"):
        voc.conditioning(np.zeros((5, cfg.n_aux + 2)))
    with pytest.raises(ValueError, match="empty"):
        voc.conditioning(np.zeros((0, cfg.n_aux)))


def test_what_is_not_ported_raises(expdir):
    """`qpnet_serve --noise_shaping` builds the restoration filter over the
    experiment's stats (one-shot `emphasize` bit for bit); the scan
    engine's combinations load and synthesize what batch_fast_generate
    gives, and int8_weights streams as the JAX package streams it (bf16
    weights through the kernel, which has no weight-only scheme), so its
    stream is the "none" stream bit for bit; xla with w8a8 raises."""
    from qpnet_tpu_torch.bin import qpnet_serve
    from qpnet_tpu_torch.models import batch_fast_generate
    from qpnet_tpu_torch.ops import encode_mu_law

    tmp, cfg, _, feats = expdir
    x0 = np.full((1, 1), int(encode_mu_law(np.zeros(1), cfg.n_quantize)[0]),
                 np.int32)
    from qpnet_tpu_torch.dsp.emphasis import emphasis_coefs, emphasize
    args = qpnet_serve.get_arguments([
        "--config", str(tmp / "model.conf"),
        "--stats", str(tmp / "stats.h5"),
        "--checkpoint", str(tmp / "checkpoint-final.pkl"),
        "--device", "cpu", "--noise_shaping"])
    filt = qpnet_serve.make_postfilter_factory(args, "world")()
    wav = np.random.default_rng(5).normal(size=900) * 0.1
    coefs = emphasis_coefs(args.stats, "world", args.mcep_dim_start,
                           args.mcep_dim_end, args.mag, invert=False)
    np.testing.assert_array_equal(
        np.concatenate([filt.process(wav[:300]), filt.process(wav[300:])]),
        emphasize(wav, args.fs, coefs, args.mcep_alpha, args.shiftms))
    for kw in ({"engine": "xla"}, {"quantize": "int8_weights"}):
        v = load(tmp, mode="argmax", **kw)
        h, d = v.conditioning(feats)
        want = batch_fast_generate(
            v.params, cfg, x0, h[None],
            [len(h) * cfg.upsampling_factor - 1],
            np.repeat(d, cfg.upsampling_factor)[None], seed=v.seed,
            mode="argmax", engine="xla", quantize=v.quantize, device="cpu")
        np.testing.assert_array_equal(
            v.synthesize(feats),
            np.asarray(decode_mu_law(want[0], cfg.n_quantize), np.float32))
    # streaming int8_weights packs bf16 and runs the kernel's bf16 branch,
    # as the JAX package's StreamingGenerator does: the "none" stream's
    # audio, bit for bit
    want = list(load(tmp).stream(feats))
    got = list(load(tmp, quantize="int8_weights").stream(feats))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="w8a8"):
        load(tmp, engine="xla", quantize="w8a8")


def test_defaults_to_cuda(expdir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    tmp, _, _, _ = expdir
    with pytest.raises(RuntimeError, match="CUDA"):
        Vocoder.load(str(tmp), stats=str(tmp / "stats.h5"))


# ---- analysis frontend ----

def _jax_vocoder(tmp, **kw):
    return JaxVocoder.load(str(tmp), stats=str(tmp / "stats.h5"),
                           engine="pallas", interpret=True, **kw)


@pytest.mark.parametrize("f0_factor", [1.0, 1.5])
def test_vocode_host_backend_matches_jax_vocoder_argmax(an_expdir,
                                                        f0_factor):
    """The host analysis is bit-equal, and synthesis in argmax mode is, so
    the whole vocode is."""
    tmp, wav = an_expdir
    want = _jax_vocoder(tmp, mode="argmax").vocode(
        wav, f0_factor=f0_factor, dsp_backend="numpy")
    voc = load(tmp, mode="argmax")
    got = voc.vocode(wav, f0_factor=f0_factor, dsp_backend="numpy")
    F = int(len(wav) / (AN_FS * 0.005)) + 1
    assert got.shape == (F * voc.cfg.upsampling_factor - 1,)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_analyze_device_backend_matches_jax(an_expdir):
    """The default dsp_backend="jax" (the fused device pass, here on the
    CPU) against JAX's fused pass: [uv | cont-F0 | mcep | codeap] within
    tests/test_torch_port_dsp_device.py's tolerances."""
    tmp, wav = an_expdir
    want = _jax_vocoder(tmp).analyze(wav)
    got = load(tmp).analyze(wav)
    assert got.shape == want.shape and got.dtype == np.float32
    assert (got[:, 0] == want[:, 0]).mean() >= 0.99       # voicing
    both = (got[:, 0] > 0) & (want[:, 0] > 0)
    assert both.mean() > 0.3
    assert np.median(np.abs(got[both, 1] - want[both, 1])) <= 0.05
    assert np.abs(got[:, 2:-1] - want[:, 2:-1]).mean() <= 1e-3
    assert np.median(np.abs(got[:, -1] - want[:, -1])) <= 0.01


@pytest.mark.parametrize("kind", ["int16", "int32", "uint8", "float"])
def test_analyze_pcm_rescaling_matches_jax(an_expdir, kind):
    """Integer PCM is rescaled from its container's full scale (unsigned
    PCM offset-binary), a float in [-1, 1) by 32768, as in JAX."""
    tmp, wav = an_expdir
    pcm = {"int16": lambda w: (w * 32767).astype(np.int16),
           "int32": lambda w: (w * 2 ** 31).astype(np.int32),
           "uint8": lambda w: np.round(w * 127 + 128).astype(np.uint8),
           "float": lambda w: w}[kind](wav)
    want = _jax_vocoder(tmp).analyze(pcm, dsp_backend="numpy")
    got = load(tmp).analyze(pcm, dsp_backend="numpy")
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] > 0).mean() > 0.3


def test_analyze_validates_its_input(expdir, an_expdir):
    tmp, _ = an_expdir
    voc = load(tmp)
    with pytest.raises(ValueError, match="1-D"):
        voc.analyze(np.zeros((2, 100)))
    with pytest.raises(ValueError, match="empty"):
        voc.analyze(np.zeros(0))
    # a model whose aux width is not the analysis geometry's
    with pytest.raises(ValueError, match="n_aux"):
        Vocoder.load(str(expdir[0]), device="cpu", fs=AN_FS).analyze(
            np.sin(np.arange(4000) / 10.0), dsp_backend="numpy")
