"""PyTorch port vs the JAX package: the generation kernel's w8a8 branch and
the deep ring layout.

The w8a8 packing must be bit-equal to JAX's `pack_weights(quantize="w8a8")`;
the port's plain twin must follow `pallas_generate(interpret=True,
quantize="w8a8")` (forced logits within 1e-5, carried state equal, sampled
samples equal); and on a deep tiny network (dilations to 32) the twin must
equal JAX's kernel with its fixed rings streamed from HBM
(`stream_min_dil=32`), one-shot and in chunks at window-misaligned offsets,
in bf16 and w8a8.  The CUDA kernels are held against the twin on the card
by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.models import generate as JG
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.ops.gen_kernel import pack_weights as jax_pack_weights
from qpnet_tpu.ops.gen_kernel import pallas_generate
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models import generate as TG
from qpnet_tpu_torch.models import qpnet as TQ
from qpnet_tpu_torch.ops import gen_kernel as TK

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=2,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=5)
# tests/test_gen_kernel.py's deep tiny network: the dilation-32 layer is
# the one JAX streams from HBM at stream_min_dil=32
DEEP = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=6, dilationF_repeat=1,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=10)
W8A8_ATOL = 1e-5   # forced logits: only the aux products sum in another order


def carried(spec, seed):
    cfg_j, cfg = JaxConfig(**spec), ModelConfig(**spec)
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    pt = TQ.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return pj, pt, cfg_j, cfg


@pytest.mark.parametrize("spec,seed", [(TINY, 0), (TINY, 5), (DEEP, 1)])
def test_w8a8_packing_bit_equal_to_jax(spec, seed):
    pj, pt, cfg_j, cfg = carried(spec, seed)
    jp = {k: np.asarray(v) for k, v in
          jax_pack_weights(pj, cfg_j, quantize="w8a8").items()}
    tp = {k: v.numpy() if v.dtype != torch.bfloat16 else v.float().numpy()
          for k, v in TK.pack_weights(pt, cfg, quantize="w8a8").items()}
    assert tp["W_in_q_t"].dtype == np.int8 and jp["W_in"].dtype == np.int8
    np.testing.assert_array_equal(tp["W_in_q_t"], jp["W_in"].swapaxes(1, 2))
    np.testing.assert_array_equal(tp["W_out_q_t"], jp["W_out"].swapaxes(1, 2))
    np.testing.assert_array_equal(tp["s_in"], jp["s_in"][:, 0])
    np.testing.assert_array_equal(tp["s_out"], jp["s_out"][:, 0])
    for k in ("W_aux", "c_all", "b_res", "b_skip_sum", "up_w", "E_cat",
              "b_causal", "b_post1", "b_post2"):
        np.testing.assert_array_equal(tp[k], np.asarray(jp[k], np.float32),
                                      err_msg=k)
    for k in ("W_post1", "W_post2"):
        np.testing.assert_array_equal(tp[k + "_t"],
                                      np.asarray(jp[k], np.float32).T)
    assert "W_in_t" not in tp and "W_out_t" not in tp


def test_mmq_constants_and_rounding_match_jax():
    """The twin's quantized product on rows with exact halves, a zero row
    and a row at the 1e-6 floor: equal to JAX's arithmetic bit for bit."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5, 64)).astype(np.float32)
    a[1] = 0.0
    a[2] *= 1e-9
    a[3, :4] = [127.0, 0.5, -0.5, 1.5]        # 127/amax = 1: halves round
    w = rng.integers(-127, 128, size=(64, 12)).astype(np.int8)
    sc = rng.uniform(0.001, 0.02, size=(12,)).astype(np.float32)

    amax = jnp.maximum(jnp.max(jnp.abs(a), axis=-1, keepdims=True), 1e-6)
    aq = jnp.clip(jnp.round(a * (127.0 / amax)), -127, 127).astype(jnp.int8)
    zi = jax.lax.dot_general(aq, jnp.asarray(w), (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
    ref = np.asarray(zi.astype(jnp.float32) * (amax * (1.0 / 127.0)) * sc)
    got = TK._mmq(torch.from_numpy(a), torch.from_numpy(w.T.copy()).float(),
                  torch.from_numpy(sc))
    np.testing.assert_array_equal(got.numpy(), ref)


def make_case(cfg, B, F, seed):
    rng = np.random.default_rng(seed)
    up = cfg.upsampling_factor
    n = F * up - 1
    h = rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32)
    d = np.repeat(rng.uniform(1.0, 3.5, size=(B, F)), up,
                  axis=1).astype(np.float32)[:, :n]
    forced = rng.integers(0, cfg.n_quantize, size=(B, n)).astype(np.int32)
    x0 = np.full((B, 1), cfg.n_quantize // 2, np.int32)
    return x0, h, forced, d, n


@pytest.fixture(scope="module")
def chunk_case():
    """One 8-frame chunk of the tiny network in both layouts (w8a8), at a
    non-zero step offset and batch offset, and JAX's interpret-mode runs of
    it in forced and sampling mode."""
    pj, pt, cfg_j, cfg = carried(TINY, 6)
    B, F = 3, 8
    x0, h, forced, d, _ = make_case(cfg, B, F, 6)
    n = F * cfg.upsampling_factor
    maxd, x_seed, d_gen = TG._seed_and_d(cfg, x0, d, n)
    hj, dj, _ = JG._pallas_host_prep(cfg_j, h, d_gen, n)
    hj, dj = jnp.asarray(hj[:F]), jnp.asarray(dj[:F])
    jstate = JG._pallas_prologue(pj, cfg_j, jnp.asarray(x_seed),
                                 hj[0], maxd=maxd, quantize="w8a8",
                                 const_seed=True)
    ht, dt, _ = TG._pallas_host_prep(cfg, h, d_gen, n, "cpu")
    tstate = TG._prologue(pt, cfg, torch.from_numpy(x_seed), ht[0], maxd,
                          const_seed=True, quantize="w8a8")
    xf = np.zeros((n, 1, B), np.int32)
    xf[: n - 1, 0] = forced.T
    kw = dict(B=B, maxd=maxd, n_steps=n, step_offset=2 * n, b_offset=4)
    jout = {m: pallas_generate(*jstate[:1], cfg_j, *jstate[1:], hj, dj, 11,
                               interpret=True, quantize="w8a8", mode=m,
                               x_forced=jnp.asarray(xf) if m == "forced"
                               else None, **kw)
            for m in ("forced", "sampling")}
    return dict(cfg=cfg, jstate=jstate, tstate=tstate, ht=ht[:F], dt=dt[:F],
                xf=torch.from_numpy(xf), kw=kw, jout=jout)


def _state_equal(tout, jout):
    for a, b in zip(tout[1:3], jout[1:3]):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))


def test_w8a8_forced_logits_and_state_match_jax_kernel(chunk_case):
    c = chunk_case
    tout = TK.generate(*c["tstate"][:1], c["cfg"], *c["tstate"][1:], c["ht"],
                       c["dt"], 11, mode="forced", x_forced=c["xf"],
                       quantize="w8a8", **c["kw"])
    jout = c["jout"]["forced"]
    assert tout[0].shape == jout[0].shape
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               atol=W8A8_ATOL, rtol=0)
    _state_equal(tout, jout)


def test_w8a8_sampling_matches_jax_kernel(chunk_case):
    c = chunk_case
    tout = TK.generate(*c["tstate"][:1], c["cfg"], *c["tstate"][1:], c["ht"],
                       c["dt"], 11, mode="sampling", quantize="w8a8",
                       **c["kw"])
    jout = c["jout"]["sampling"]
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    _state_equal(tout, jout)


def test_w8a8_logits_close_to_bf16():
    """The gates of tests/test_quantize.py, on the port's twin: w8a8 and
    bf16 forced logits on the same stream."""
    _, pt, _, cfg = carried(TINY, 0)
    x0, h, forced, d, _ = make_case(cfg, 2, 10, 0)
    ref = TG.teacher_forced_logits(pt, cfg, x0, h, forced, d,
                                   engine="pallas", device="cpu")
    q = TG.teacher_forced_logits(pt, cfg, x0, h, forced, d, quantize="w8a8",
                                 engine="pallas", device="cpu")
    assert q.shape == ref.shape
    rmse = float(np.sqrt(np.mean((q - ref) ** 2)))
    rel = rmse / (float(np.sqrt(np.mean(ref ** 2))) + 1e-12)
    agree = float((q.argmax(-1) == ref.argmax(-1)).mean())
    assert rel < 0.10, rel
    assert agree > 0.90, agree


def test_w8a8_needs_its_packing():
    _, pt, _, cfg = carried(TINY, 0)
    x0, h, forced, d, n = make_case(cfg, 1, 4, 0)
    maxd, x_seed, d_gen = TG._seed_and_d(cfg, x0, d, 4 * 5)
    ht, dt, _ = TG._pallas_host_prep(cfg, h, d_gen, 4 * 5, "cpu")
    packed, bF, bA, x = TG._prologue(pt, cfg, torch.from_numpy(x_seed), ht[0],
                                     maxd, const_seed=True)
    with pytest.raises(ValueError, match="pack_weights"):
        TK.generate(packed, cfg, bF, bA, x, ht[:4], dt[:4], 0, B=1,
                    maxd=maxd, n_steps=20, quantize="w8a8")
    with pytest.raises(ValueError, match="quantize"):
        TK.pack_weights(pt, cfg, quantize="int8")


# ---------------------------------------------------------------------------
# the deep ring layout against JAX's HBM-streamed rings
# ---------------------------------------------------------------------------

DEEP_B, DEEP_MAXD, DEEP_F = 3, 4, 12
CHUNKS = (1, 3, 2, 6)   # frames: offsets 10, 40, 60 fall inside 8-slot windows


@pytest.fixture(scope="module")
def deep_case():
    """The deep tiny network's kernel inputs in both layouts, and JAX's
    streamed-ring run (sampling, one call) per quantize."""
    pj, pt, cfg_j, cfg = carried(DEEP, 0)
    rng = np.random.default_rng(0)
    B, maxd, F = DEEP_B, DEEP_MAXD, DEEP_F
    up = cfg.upsampling_factor
    rf = cfg.receptive_field(maxd) + 1
    x_seed = np.full((B, rf), cfg.n_quantize // 2, np.int32)
    h_pad = np.zeros((F, B, 48), np.float32)
    h_pad[:, :, : cfg.n_aux] = rng.normal(size=(F, B, cfg.n_aux))
    d_frames = rng.uniform(1.0, 3.5, (F, 1, B)).astype(np.float32)
    hj = jnp.asarray(h_pad, jnp.bfloat16)
    dj = jnp.asarray(d_frames)
    ht = torch.from_numpy(h_pad).to(torch.bfloat16)
    dt = torch.from_numpy(d_frames)
    out = {}
    for q in ("none", "w8a8"):
        jstate = JG._pallas_prologue(pj, cfg_j, jnp.asarray(x_seed),
                                     jnp.asarray(h_pad[0]), maxd=maxd,
                                     quantize=q, const_seed=True)
        tstate = TG._prologue(pt, cfg, torch.from_numpy(x_seed),
                              ht[0], maxd, const_seed=True, quantize=q)
        kw = dict(B=B, maxd=maxd, mode="sampling", interpret=True,
                  quantize=q, stream_min_dil=32)
        out[q] = dict(tstate=tstate,
                      one=pallas_generate(jstate[0], cfg_j, *jstate[1:], hj,
                                          dj, 7, n_steps=F * up, **kw))
    return dict(cfg=cfg, ht=ht, dt=dt, runs=out)


@pytest.mark.parametrize("quantize", ["none", "w8a8"])
@pytest.mark.parametrize("how", ["one_shot", "chunked"])
def test_deep_rings_match_jax_streamed_kernel(deep_case, quantize, how):
    cfg, ht, dt = deep_case["cfg"], deep_case["ht"], deep_case["dt"]
    run = deep_case["runs"][quantize]
    packed, *state = run["tstate"]
    up = cfg.upsampling_factor
    kw = dict(B=DEEP_B, maxd=DEEP_MAXD, mode="sampling", quantize=quantize)
    if how == "one_shot":
        got = TK.generate(packed, cfg, *state, ht, dt, 7,
                          n_steps=DEEP_F * up, **kw)
    else:
        # JAX's chunked streamed run equals its one-shot run
        # (tests/test_gen_kernel.py), so the port's chunks are held to it
        pieces, off = [], 0
        for fc in CHUNKS:
            f0 = off // up
            s, *state = TK.generate(packed, cfg, *state, ht[f0:f0 + fc],
                                    dt[f0:f0 + fc], 7, n_steps=fc * up,
                                    step_offset=off, **kw)
            pieces.append(s)
            off += fc * up
        got = (torch.cat(pieces), *state)
    want = run["one"]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _state_equal(got, want)
