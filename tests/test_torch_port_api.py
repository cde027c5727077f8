"""PyTorch port vs the JAX package: the high-level `Vocoder` API on the CPU
(the generation kernel's plain twin), loading experiments the JAX package
wrote.  `synthesize` must write what the port's decode CLI writes, F0 scaling
included, and equal JAX's `Vocoder(interpret=True)` in argmax mode; the
conditioning contract, batch order and lengths, and session reuse of
`stream` follow the JAX API."""

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
    sc = Scaler(np.zeros(cfg.n_aux), np.ones(cfg.n_aux))
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
    """analyze and vocode wait for the host DSP; the scan engine's
    combinations load and synthesize what batch_fast_generate gives, while
    int8_weights cannot stream (the kernel has no weight-only scheme)."""
    from qpnet_tpu_torch.models import batch_fast_generate
    from qpnet_tpu_torch.ops import encode_mu_law

    tmp, cfg, _, feats = expdir
    x0 = np.full((1, 1), int(encode_mu_law(np.zeros(1), cfg.n_quantize)[0]),
                 np.int32)
    voc = load(tmp)
    tone = np.sin(np.arange(2000) / 10.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        voc.analyze(tone)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        voc.vocode(tone, f0_factor=1.5)
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
    with pytest.raises(ValueError, match="int8_weights"):
        next(load(tmp, quantize="int8_weights").stream(feats))
    with pytest.raises(ValueError, match="w8a8"):
        load(tmp, engine="xla", quantize="w8a8")


def test_defaults_to_cuda(expdir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    tmp, _, _, _ = expdir
    with pytest.raises(RuntimeError, match="CUDA"):
        Vocoder.load(str(tmp), stats=str(tmp / "stats.h5"))
