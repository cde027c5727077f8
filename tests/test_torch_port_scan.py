"""PyTorch port vs the JAX package: the scan engine (`engine="xla"`), its
f32 parity mode, bf16 and `int8_weights`, dilation factors that vary within
frames, the scan's ring layout (time origin rf, no extra adaptive slot),
sampling from a seeded torch.Generator, and the engine routing of
`batch_fast_generate`."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.models import generate as JG
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models import generate as TG
from qpnet_tpu_torch.models import qpnet as TQ

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=2,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=5)
UP = TINY["upsampling_factor"]
F32_TOL = 1e-5          # f32: max |d| / max |ref|
BF16_TOL = 2e-2         # bf16 and int8_weights: max |d| / max |ref|
ARGMAX_AGREE = 0.98
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def carried(seed, **kw):
    spec = dict(TINY, **kw)
    cfg_j, cfg = JaxConfig(**spec), ModelConfig(**spec)
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    pt = TQ.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return pj, pt, cfg_j, cfg


def make_case(cfg, B, F, seed, d_kind="frames", seed_len=1):
    """(x0, h, forced, d, n): d constant ("const", 2.6), frame-constant
    ("frames") or varying within frames ("samples")."""
    rng = np.random.default_rng(seed)
    n = F * UP - 1
    h = rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32)
    if d_kind == "const":
        d = np.full((B, F * UP), 2.6, np.float32)
    elif d_kind == "frames":
        d = np.repeat(rng.uniform(1.0, 3.5, (B, F)), UP, 1).astype(np.float32)
    else:
        d = rng.uniform(1.0, 6.0, (B, F * UP)).astype(np.float32)
    forced = rng.integers(0, cfg.n_quantize, (B, n)).astype(np.int32)
    if seed_len <= 1:
        x0 = np.full((B, 1), cfg.n_quantize // 2, np.int32)
    else:
        x0 = rng.integers(0, cfg.n_quantize, (B, seed_len)).astype(np.int32)
    return x0, h, forced, d, n


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_quantize_int8_bit_equal_to_jax():
    _, pt, _, _ = carried(0)
    for w in (pt["fixed"][0]["W_cur"], pt["adaptive"][1]["W_skip"],
              torch.zeros(8, 3), pt["W_post2"]):
        qj, sj = JG._quantize_int8(jnp.asarray(w.numpy()))
        qt, st = TG._quantize_int8(w)
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("quantize", ["none", "int8_weights"])
def test_fused_weights_match_jax(quantize):
    pj, pt, _, _ = carried(1)
    fj, aj = JG._fused_weights(pj, jnp.bfloat16, quantize)
    ft, at = TG._fused_weights(pt, torch.bfloat16, quantize)
    for dj, dt in zip(fj + aj, ft + at):
        assert sorted(dj) == sorted(dt)
        for k in dj:
            assert str(dt[k].dtype).split(".")[-1] == str(dj[k].dtype)
            np.testing.assert_array_equal(dt[k].float().numpy(),
                                          np.asarray(dj[k], np.float32))


@pytest.mark.parametrize("const_seed,maxd", [(True, 4), (False, 4),
                                             (False, 8)])
def test_scan_rings_match_jax(const_seed, maxd):
    """The scan's layout: origin rf, adaptive rings of maxd * dil slots."""
    pj, pt, cfg_j, cfg = carried(2)
    B = 2
    rf = cfg.receptive_field(maxd)
    rng = np.random.default_rng(2)
    if const_seed:
        x_seed = np.full((B, rf + 1), cfg.n_quantize // 2, np.int32)
    else:
        x_seed = rng.integers(0, cfg.n_quantize, (B, rf + 1)).astype(np.int32)
    h0 = rng.normal(size=(B, cfg.n_aux)).astype(np.float32)
    fj, aj = JG._prime_ring_buffers(pj, cfg_j, jnp.asarray(x_seed),
                                    jnp.asarray(h0), maxd, jnp.float32,
                                    t0=rf, const_seed=const_seed)
    ft, at = TG._prime_ring_buffers(pt, cfg, torch.from_numpy(x_seed),
                                    torch.from_numpy(h0), maxd, const_seed,
                                    t0=rf, ring_pad=0)
    assert [a.shape[1] for a in at] == [maxd * dl for dl in cfg.dilationsA]
    for a, b in zip(ft + at, fj + aj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("d_kind,seed_len", [("const", 1), ("frames", 1),
                                             ("samples", 1), ("samples", 7)])
def test_f32_forced_logits_match_jax(d_kind, seed_len):
    pj, pt, cfg_j, cfg = carried(3)
    x0, h, forced, d, n = make_case(cfg, 2, 10, 3, d_kind, seed_len)
    ref = JG.teacher_forced_logits(pj, cfg_j, x0, h, forced, d, engine="xla",
                                   compute_dtype=jnp.float32)
    got = TG.teacher_forced_logits(pt, cfg, x0, h, forced, d,
                                   compute_dtype=torch.float32, device="cpu")
    assert got.shape == ref.shape == (2, n, cfg.n_quantize)
    assert got.dtype == np.float32
    assert rel(got, ref) <= F32_TOL


@pytest.mark.parametrize("quantize,dtype", [("none", "bfloat16"),
                                            ("int8_weights", "float32"),
                                            ("int8_weights", "bfloat16")])
def test_bf16_and_int8_weights_forced_logits_match_jax(quantize, dtype):
    pj, pt, cfg_j, cfg = carried(4)
    x0, h, forced, d, _ = make_case(cfg, 2, 10, 4, "samples")
    tdt, jdt = DTYPES[dtype]
    ref = JG.teacher_forced_logits(pj, cfg_j, x0, h, forced, d, engine="xla",
                                   compute_dtype=jdt, quantize=quantize)
    got = TG.teacher_forced_logits(pt, cfg, x0, h, forced, d,
                                   compute_dtype=tdt, quantize=quantize,
                                   device="cpu")
    assert rel(got, ref) <= BF16_TOL
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= ARGMAX_AGREE


def test_int8_weights_close_to_f32_scan():
    """tests/test_quantize.py's gates on the port: int8_weights against the
    f32 scan on the same forced stream."""
    _, pt, _, cfg = carried(5)
    x0, h, forced, d, _ = make_case(cfg, 2, 10, 5)
    kw = dict(compute_dtype=torch.float32, device="cpu")
    ref = TG.teacher_forced_logits(pt, cfg, x0, h, forced, d, **kw)
    q = TG.teacher_forced_logits(pt, cfg, x0, h, forced, d,
                                 quantize="int8_weights", **kw)
    rmse = np.sqrt(np.mean((q - ref) ** 2)) / np.sqrt(np.mean(ref ** 2))
    assert rmse < 0.10
    assert (q.argmax(-1) == ref.argmax(-1)).mean() > 0.90


@pytest.mark.parametrize("d_kind,seed_len,engine", [
    ("const", 1, "xla"),
    ("frames", 1, "xla"),
    ("samples", 1, "auto"),     # d varies within frames: auto takes the scan
    ("samples", 7, "xla"),      # multi-sample seed, rf % size != 0
])
def test_f32_argmax_streams_equal_jax(d_kind, seed_len, engine):
    pj, pt, cfg_j, cfg = carried(6)
    x0, h, _, d, n = make_case(cfg, 2, 8, 6, d_kind, seed_len)
    maxd = TG.bucket_maxd(float(np.ceil(d.max())))
    rf = cfg.receptive_field(maxd)
    if seed_len > 1:
        assert any(rf % s for s in cfg.dilationsF + [maxd * dl for dl in
                                                     cfg.dilationsA])
    want = JG.batch_fast_generate(pj, cfg_j, x0, h, [n, n - 7], d,
                                  mode="argmax", engine="xla",
                                  compute_dtype=jnp.float32)
    got = TG.batch_fast_generate(pt, cfg, x0, h, [n, n - 7], d,
                                 mode="argmax", engine=engine,
                                 compute_dtype=torch.float32, device="cpu")
    assert [len(g) for g in got] == [n, n - 7]
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("d_kind", ["frames", "samples"])
def test_forward_equals_generate(d_kind):
    """The tests/test_generate.py replay on the port alone: the argmax
    stream of the f32 scan, replayed through the teacher-forced forward,
    is the forward's argmax at every step."""
    _, pt, _, cfg = carried(7)
    x0, h, _, d, n = make_case(cfg, 2, 8, 7, d_kind)
    B = 2
    samples = np.stack(TG.batch_fast_generate(
        pt, cfg, x0, h, [n] * B, d, mode="argmax", engine="xla",
        compute_dtype=torch.float32, device="cpu"))
    rf = cfg.receptive_field(TG.bucket_maxd(float(np.ceil(d.max()))))
    x_full = np.concatenate([np.full((B, rf), cfg.n_quantize // 2, np.int32),
                             x0, samples[:, :-1]], 1)
    h_up = TQ.upsample_aux(pt, torch.from_numpy(h), UP)
    h_up_full = torch.cat([h_up[:, :1].expand(B, rf, -1), h_up[:, :n]], 1)
    d_full = np.concatenate([np.ones((B, rf), np.float32), d[:, :n]], 1)
    logits = TQ.forward(pt, cfg, torch.from_numpy(x_full), None,
                        torch.from_numpy(d_full), h_up=h_up_full)
    pred = logits.argmax(-1).numpy()
    np.testing.assert_array_equal(pred[:, rf:rf + n], samples)


def test_sampling_deterministic_given_the_seed():
    _, pt, _, cfg = carried(8)
    x0, h, _, d, n = make_case(cfg, 2, 6, 8, "samples")
    kw = dict(mode="sampling", engine="xla", device="cpu")
    a = np.stack(TG.batch_fast_generate(pt, cfg, x0, h, [n] * 2, d, seed=5,
                                        **kw))
    b = np.stack(TG.batch_fast_generate(pt, cfg, x0, h, [n] * 2, d, seed=5,
                                        **kw))
    c = np.stack(TG.batch_fast_generate(pt, cfg, x0, h, [n] * 2, d, seed=6,
                                        **kw))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < cfg.n_quantize


def test_sampling_follows_the_softmax():
    """200,000 draws from fixed logits: total variation from their softmax
    within 0.02."""
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.normal(scale=2.0, size=32).astype(
        np.float32))
    n = 200_000
    gen = torch.Generator().manual_seed(3)
    draws = TG._sample(logits.expand(n, -1), gen).numpy()
    freq = np.bincount(draws, minlength=32) / n
    p = torch.softmax(logits.double(), -1).numpy()
    assert 0.5 * np.abs(freq - p).sum() <= 0.02


ROUTES = [
    # (engine, quantize, d varies within frames) -> "scan", "kernel" or error
    ("xla", "none", False, "scan"),
    ("xla", "int8_weights", False, "scan"),
    ("auto", "none", False, "kernel"),
    ("auto", "w8a8", False, "kernel"),
    ("auto", "none", True, "scan"),
    ("auto", "int8_weights", False, "scan"),
    ("pallas", "none", False, "kernel"),
    ("auto", "int8", False, "ambiguous"),
    ("xla", "w8a8", False, "pallas"),
    ("pallas", "int8_weights", False, "xla"),
    ("pallas", "none", True, "frame"),
    ("auto", "w8a8", True, "frame rate"),
    ("scan", "none", False, "engine should be"),
    ("auto", "int4", False, "unknown quantize"),
]


@pytest.mark.parametrize("engine,quantize,varying,want", ROUTES)
def test_engine_routing(monkeypatch, caplog, engine, quantize, varying, want):
    _, pt, _, cfg = carried(10)
    x0, h, _, d, n = make_case(cfg, 1, 4, 10, "samples" if varying
                               else "frames")
    ran = []

    def spy(name, fn):
        def wrapped(*a, **k):
            ran.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(TG, name, wrapped)
    spy("_scan_path", TG._scan_path)
    spy("_pallas_path", TG._pallas_path)
    run = lambda: TG.batch_fast_generate(pt, cfg, x0, h, [n], d, seed=1,
                                         engine=engine, quantize=quantize,
                                         device="cpu")
    if want in ("scan", "kernel"):
        with caplog.at_level(logging.INFO):
            out = run()
        assert ran == [{"scan": "_scan_path",
                        "kernel": "_pallas_path"}[want]]
        assert len(out[0]) == n
        fell_back = "using the scan engine" in caplog.text
        assert fell_back == (want == "scan" and engine == "auto")
    else:
        with pytest.raises(ValueError, match=want):
            run()
        assert ran == []


def test_teacher_forced_logits_defaults_to_the_scan():
    """The JAX signature: engine="xla" and compute_dtype (bf16) by default;
    the kernel only on request."""
    _, pt, _, cfg = carried(11)
    x0, h, forced, d, _ = make_case(cfg, 2, 6, 11)
    scan = TG.teacher_forced_logits(pt, cfg, x0, h, forced, d, device="cpu")
    again = TG.teacher_forced_logits(pt, cfg, x0, h, forced, d, engine="xla",
                                     compute_dtype=torch.bfloat16,
                                     device="cpu")
    np.testing.assert_array_equal(scan, again)
    kernel = TG.teacher_forced_logits(pt, cfg, x0, h, forced, d,
                                      engine="pallas", device="cpu")
    assert rel(kernel, scan) <= BF16_TOL
    with pytest.raises(ValueError, match="engine should be"):
        TG.teacher_forced_logits(pt, cfg, x0, h, forced, d, engine="auto",
                                 device="cpu")
