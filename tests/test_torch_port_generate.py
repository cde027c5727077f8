"""PyTorch port vs the JAX package: ring priming, the kernel's input layout,
and the generation kernel's plain twin against `pallas_generate` in
interpret mode — forced logits at every step, carried state, and
argmax/sampling trajectories — plus chunked continuation within the port.
The CUDA kernel itself is held against the twin on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.models import generate as JG
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.ops.gen_kernel import pallas_generate
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models import generate as TG
from qpnet_tpu_torch.models import qpnet as TQ
from qpnet_tpu_torch.ops import gen_kernel as TK

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=2,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=5)
UP = TINY["upsampling_factor"]
FORCED_ATOL = 1e-2   # bf16 storage points, sums in another order


def carried(seed):
    cfg_j, cfg = JaxConfig(**TINY), ModelConfig(**TINY)
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    pt = TQ.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return pj, pt, cfg_j, cfg


def make_case(cfg, B, F, seed, d_lo=1.0, d_hi=3.5, seed_len=1):
    """Random forced stream, aux, frame-constant d and seed history."""
    rng = np.random.default_rng(seed)
    n = F * UP - 1
    h = rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32)
    d = np.repeat(rng.uniform(d_lo, d_hi, size=(B, F)), UP,
                  axis=1).astype(np.float32)[:, :n]
    forced = rng.integers(0, cfg.n_quantize, size=(B, n)).astype(np.int32)
    if seed_len <= 1:
        x0 = np.full((B, 1), cfg.n_quantize // 2, np.int32)
    else:
        x0 = rng.integers(0, cfg.n_quantize,
                          size=(B, seed_len)).astype(np.int32)
    return x0, h, forced, d, n


def test_maxd_buckets_and_frame_constancy():
    assert TG.MAXD_BUCKETS == JG.MAXD_BUCKETS
    for m in (0.3, 1.0, 1.01, 7.9, 33.0, 48.0, 100.0, 128.0, 130.5, 300.0):
        assert TG.bucket_maxd(m) == JG.bucket_maxd(m)
    rng = np.random.default_rng(0)
    d = np.repeat(rng.uniform(1, 3, (2, 6)), UP, 1).astype(np.float32)
    assert TG._frame_constant(d, UP) and JG._frame_constant(d, UP)
    d[1, 7] += 0.5
    assert not TG._frame_constant(d, UP) and not JG._frame_constant(d, UP)


@pytest.mark.parametrize("n_steps", [5, 49, 51, 120])
def test_host_prep_layout_matches_jax(n_steps):
    cfg = ModelConfig(**TINY)
    rng = np.random.default_rng(n_steps)
    h = rng.normal(size=(3, 7, cfg.n_aux)).astype(np.float32)
    d = rng.uniform(1, 4, (3, n_steps)).astype(np.float32)
    hj, dj, nj = JG._pallas_host_prep(JaxConfig(**TINY), h, d, n_steps)
    ht, dt, nt = TG._pallas_host_prep(cfg, h, d, n_steps, "cpu")
    assert nt == nj
    assert ht.dtype == torch.bfloat16
    np.testing.assert_array_equal(ht.float().numpy(),
                                  np.asarray(hj, np.float32))
    np.testing.assert_array_equal(dt.numpy(), dj)


@pytest.mark.parametrize("const_seed,maxd", [(True, 4), (False, 4),
                                             (False, 2)])
def test_priming_matches_jax(const_seed, maxd):
    """Rings for the kernel's time origin 0, with its extra adaptive slot."""
    pj, pt, cfg_j, cfg = carried(1)
    B = 2
    rf = cfg.receptive_field(maxd)
    rng = np.random.default_rng(1)
    if const_seed:
        x_seed = np.full((B, rf + 1), cfg.n_quantize // 2, np.int32)
    else:
        x_seed = rng.integers(0, cfg.n_quantize, (B, rf + 1)).astype(np.int32)
    h0 = rng.normal(size=(B, cfg.n_aux)).astype(np.float32)
    fj, aj = JG._prime_ring_buffers(pj, cfg_j, jnp.asarray(x_seed),
                                    jnp.asarray(h0), maxd, jnp.float32,
                                    t0=0, const_seed=const_seed, ring_pad=1)
    ft, at = TG._prime_ring_buffers(pt, cfg, torch.from_numpy(x_seed),
                                    torch.from_numpy(h0), maxd, const_seed)
    assert len(ft) == len(fj) and len(at) == len(aj)
    for a, b in zip(ft + at, fj + aj):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("seed,kw", [
    (2, {}),                                  # single-sample seed
    (4, {"seed_len": 40}),                    # real seed history
    (5, {"d_lo": 5.0, "d_hi": 7.4, "F": 14}),  # deep adaptive look-backs
])
def test_forced_logits_match_jax_kernel_every_step(seed, kw):
    """The twin vs pallas_generate(interpret=True), teacher-forced, at every
    step (measured max |d| 6e-8 over the three cases)."""
    pj, pt, cfg_j, cfg = carried(seed)
    F = kw.pop("F", 12)
    x0, h, forced, d, n = make_case(cfg, B=2, F=F, seed=seed, **kw)
    ref = JG.teacher_forced_logits(pj, cfg_j, x0, h, forced, d,
                                   engine="pallas", interpret=True)
    got = TG.teacher_forced_logits(pt, cfg, x0, h, forced, d,
                                   engine="pallas", device="cpu")
    assert got.shape == ref.shape == (2, n, cfg.n_quantize)
    np.testing.assert_allclose(got, ref, atol=FORCED_ATOL)


def test_forced_logits_match_teacher_forced_forward():
    """The twin against the port's own f32 forward replayed over the forced
    stream (mid-scale history, first-frame aux and d = 1 over it)."""
    pj, pt, _, cfg = carried(3)
    x0, h, forced, d, n = make_case(cfg, B=2, F=10, seed=3)
    B = 2
    maxd = TG.bucket_maxd(float(np.ceil(d).max()))
    rf = cfg.receptive_field(maxd)
    hist = np.full((B, rf + 1), cfg.n_quantize // 2, np.int32)
    x_full = np.concatenate([hist, forced[:, :-1]], axis=1)
    h_up = TQ.upsample_aux(pt, torch.from_numpy(h), UP)
    h_up_full = torch.cat([h_up[:, :1].expand(B, rf, -1), h_up[:, :n]], 1)
    d_full = np.concatenate([np.ones((B, rf), np.float32), d], axis=1)
    ref = TQ.forward(pt, cfg, torch.from_numpy(x_full), None,
                     torch.from_numpy(d_full), h_up=h_up_full)[:, rf:rf + n]
    got = TG.teacher_forced_logits(pt, cfg, x0, h, forced, d,
                                   engine="pallas", device="cpu")
    np.testing.assert_allclose(got, ref.numpy(), atol=0.03)


def _both_prologues(seed, B=2, F=6, mode="forced"):
    """The same chunk's inputs in the JAX kernel's and the port's layout."""
    pj, pt, cfg_j, cfg = carried(seed)
    x0, h, forced, d, _ = make_case(cfg, B=B, F=F, seed=seed)
    n = F * UP
    maxd, x_seed, d_gen = TG._seed_and_d(cfg, x0, d, n)
    hj, dj, _ = JG._pallas_host_prep(cfg_j, h, d_gen, n)
    hj, dj = hj[:F], dj[:F]
    jax_state = JG._pallas_prologue(pj, cfg_j, jnp.asarray(x_seed),
                                    jnp.asarray(hj[0]), maxd=maxd,
                                    quantize="none", const_seed=True)
    ht, dt, _ = TG._pallas_host_prep(cfg, h, d_gen, n, "cpu")
    ht, dt = ht[:F], dt[:F]
    port_state = TG._prologue(pt, cfg, torch.from_numpy(x_seed), ht[0], maxd,
                              const_seed=True)
    xf = np.zeros((n, 1, B), np.int32)
    xf[: n - 1, 0] = forced.T
    return (cfg_j, cfg, maxd, n, (jnp.asarray(hj), jnp.asarray(dj)), (ht, dt),
            jax_state, port_state, xf)


@pytest.mark.parametrize("mode", ["forced", "argmax"])
def test_carried_state_matches_jax_kernel(mode):
    (cfg_j, cfg, maxd, n, (hj, dj), (ht, dt), (packed, bF, bA, x0),
     (tpacked, tF, tA, tx0), xf) = _both_prologues(6, mode=mode)
    B = 2
    np.testing.assert_array_equal(tx0.numpy(), np.asarray(x0))
    kw = dict(B=B, maxd=maxd, n_steps=n, mode=mode, step_offset=n,
              b_offset=3)
    jout = pallas_generate(packed, cfg_j, bF, bA, x0, hj, dj, 11,
                           interpret=True,
                           x_forced=jnp.asarray(xf) if mode == "forced"
                           else None, **kw)
    tout = TK.generate(tpacked, cfg, tF, tA, tx0, ht, dt, 11,
                       x_forced=torch.from_numpy(xf) if mode == "forced"
                       else None, **kw)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    for a, b in zip(tout[1:3], jout[1:3]):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   atol=FORCED_ATOL)
    if mode == "forced":
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                   atol=FORCED_ATOL)
    else:
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))


@pytest.mark.parametrize("mode", ["argmax", "sampling"])
def test_trajectory_matches_jax_kernel(mode):
    """Free-running samples: bf16 near-ties may flip a decision, after which
    trajectories diverge, so the gate is the repo's own engine gate: the
    first sample equal and > 85% agreement over the first 40."""
    pj, pt, cfg_j, cfg = carried(7)
    rng = np.random.default_rng(7)
    B, F = 2, 16
    n = F * UP - 1
    h = rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32)
    d = np.repeat(rng.uniform(1.0, 3.5, (B, F)), UP, 1).astype(np.float32)
    x0 = np.full((B, 1), cfg.n_quantize // 2, np.int32)
    a = np.stack(JG.batch_fast_generate(pj, cfg_j, x0, h, [n] * B, d,
                                        seed=9, mode=mode, engine="pallas",
                                        interpret=True))
    b = np.stack(TG.batch_fast_generate(pt, cfg, x0, h, [n] * B, d, seed=9,
                                        mode=mode, device="cpu"))
    assert b.shape == a.shape and b.dtype == np.int32
    assert (a[:, 0] == b[:, 0]).all()
    assert (a[:, :40] == b[:, :40]).mean() > 0.85


def _port_chunk_case(seed=8, B=3, F=6):
    pj, pt, cfg_j, cfg = carried(seed)
    x0, h, forced, d, _ = make_case(cfg, B=B, F=F, seed=seed, d_hi=6.0)
    n = F * UP
    maxd, x_seed, d_gen = TG._seed_and_d(cfg, x0, d, n)
    ht, dt, _ = TG._pallas_host_prep(cfg, h, d_gen, n, "cpu")
    state = TG._prologue(pt, cfg, torch.from_numpy(x_seed), ht[0], maxd,
                         const_seed=True)
    xf = np.zeros((n, 1, B), np.int32)
    xf[: n - 1, 0] = forced.T
    return cfg, maxd, n, ht[:F], dt[:F], state, torch.from_numpy(xf)


@pytest.mark.parametrize("mode", ["argmax", "sampling", "forced"])
def test_chunked_equals_one_shot(mode):
    cfg, maxd, n, h, d, (packed, bF, bA, x0), xf = _port_chunk_case()
    B, F = 3, n // UP
    xf = xf if mode == "forced" else None
    one = TK.generate(packed, cfg, bF, bA, x0, h, d, 5, B=B, maxd=maxd,
                      n_steps=n, mode=mode, x_forced=xf)
    state, pieces = (bF, bA, x0), []
    for f0, f1 in ((0, 2), (2, 3), (3, F)):
        out, *state = TK.generate(
            packed, cfg, *state, h[f0:f1], d[f0:f1], 5, B=B, maxd=maxd,
            n_steps=(f1 - f0) * UP, mode=mode, step_offset=f0 * UP,
            x_forced=None if xf is None else xf[f0 * UP:f1 * UP])
        pieces.append(out)
    assert torch.equal(torch.cat(pieces), one[0])
    for a, b in zip(state, one[1:]):
        assert torch.equal(a, b)


def test_batch_split_by_b_offset_equals_one_call():
    """Rows sampled in two sub-batches with their global b_offset get the
    same streams as in one call."""
    cfg, maxd, n, h, d, (packed, bF, bA, x0), _ = _port_chunk_case()
    kw = dict(maxd=maxd, n_steps=n, mode="sampling")
    full = TK.generate(packed, cfg, bF, bA, x0, h, d, 5, B=3, **kw)[0]
    first = TK.generate(packed, cfg, bF[:, :2], bA[:, :2], x0[:, :2],
                        h[:, :2], d[:, :, :2], 5, B=2, **kw)[0]
    last = TK.generate(packed, cfg, bF[:, 2:], bA[:, 2:], x0[:, 2:],
                       h[:, 2:], d[:, :, 2:], 5, B=1, b_offset=2, **kw)[0]
    assert torch.equal(torch.cat([first, last], 2), full)


def test_decode_defaults_to_cuda_and_rejects_what_is_not_ported():
    _, pt, _, cfg = carried(9)
    x0, h, _, d, n = make_case(cfg, B=1, F=4, seed=9)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TG.batch_fast_generate(pt, cfg, x0, h, [n], d)
    for kw, err in (({"engine": "xla"}, None),
                    ({"engine": "xla", "quantize": "w8a8"}, ValueError),
                    ({"quantize": "int8_weights"}, None),
                    ({"quantize": "int4"}, ValueError),
                    ({"engine": "scan"}, ValueError)):
        if err is None:     # the scan engine
            out = TG.batch_fast_generate(pt, cfg, x0, h, [n], d,
                                         device="cpu", **kw)
            assert out[0].shape == (n,) and out[0].dtype == np.int32
            continue
        with pytest.raises(err):
            TG.batch_fast_generate(pt, cfg, x0, h, [n], d, device="cpu",
                                   **kw)
    d_var = d.copy()
    d_var[0, 1] += 0.25   # d varies within a frame
    with pytest.raises(ValueError, match="frame"):
        TG.batch_fast_generate(pt, cfg, x0, h, [n], d_var, engine="pallas",
                               device="cpu")
    out = TG.batch_fast_generate(pt, cfg, x0, h, [n], d_var, mode="argmax",
                                 device="cpu")
    want = TG.batch_fast_generate(pt, cfg, x0, h, [n], d_var, mode="argmax",
                                  engine="xla", device="cpu")
    np.testing.assert_array_equal(out[0], want[0])
    cfg_, maxd, n, h_, d_, (packed, bF, bA, x0_), _ = _port_chunk_case()
    with pytest.raises(ValueError, match="whole frames"):
        TK.generate(packed, cfg_, bF, bA, x0_, h_, d_, 0, B=3, maxd=maxd,
                    n_steps=n - 1)
    with pytest.raises(ValueError, match="x_forced"):
        TK.generate(packed, cfg_, bF, bA, x0_, h_, d_, 0, B=3, maxd=maxd,
                    n_steps=n, mode="forced")

