"""PyTorch port vs the JAX package: parameters and the teacher-forced
forward.  JAX params are carried across with `params_from_numpy`; the f32
forward must agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.models import forward as jax_forward
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.models import qpnet as JQ
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models import qpnet as TQ

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=2,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=5)


def carried(seed, **kw):
    """(JAX params, the same params as port tensors on the CPU, cfgs)."""
    cfg_j, cfg_t = JaxConfig(**{**TINY, **kw}), ModelConfig(**{**TINY, **kw})
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    pt = TQ.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return pj, pt, cfg_j, cfg_t


def test_default_network_has_24130671_params():
    params = TQ.init_params(0, ModelConfig(), device="cpu")
    assert TQ.count_params(params) == 24130671


def test_init_params_shapes_bounds_and_generator():
    pj, _, cfg_j, cfg = carried(0)
    state = torch.random.get_rng_state()
    a = TQ.init_params(7, cfg, device="cpu")
    b = TQ.init_params(7, cfg, device="cpu")
    c = TQ.init_params(8, cfg, device="cpu")
    # an explicit generator: the global RNG is untouched
    assert torch.equal(torch.random.get_rng_state(), state)
    assert TQ.count_params(a) == JQ.count_params(pj)
    R, S, Q, A = cfg.n_resch, cfg.n_skipch, cfg.n_quantize, cfg.n_aux
    for key in ("embed_cur", "embed_prev", "W_post1", "W_post2", "up_w"):
        assert tuple(a[key].shape) == tuple(pj[key].shape), key
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["W_post1"], c["W_post1"])
    bounds = {"embed_cur": np.sqrt(6 / (2 * Q + 2 * R)),
              "W_post1": np.sqrt(6 / (2 * S)),
              "W_post2": np.sqrt(6 / (S + Q))}
    for key, bound in bounds.items():
        assert float(a[key].abs().max()) <= bound
    for kind, fan in (("fixed", 4 * R), ("adaptive", 2 * R)):
        for pt_, pj_ in zip(a[kind], pj[kind]):
            for key in pj_:
                assert tuple(pt_[key].shape) == tuple(pj_[key].shape)
            assert float(pt_["W_cur"].abs().max()) <= np.sqrt(6 / fan)
            assert float(pt_["W_aux"].abs().max()) <= np.sqrt(6 / (A + R))
            assert float(pt_["W_res"].abs().max()) <= np.sqrt(6 / (2 * R))
            assert not pt_["b_gate"].any() and not pt_["b_res"].any()
    assert torch.equal(a["up_w"], torch.ones(cfg.upsampling_factor))


def test_params_from_numpy_carries_every_leaf():
    pj, pt, _, _ = carried(1)
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    assert len(flat_j) == sum(1 for _ in jax.tree_util.tree_leaves(
        TQ.tree_map(lambda t: t.numpy(), pt)))
    for path, leaf in flat_j:
        node = pt
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_upsample_and_shift_match_jax():
    pj, pt, _, cfg = carried(2)
    rng = np.random.default_rng(2)
    h = rng.normal(size=(2, 6, cfg.n_aux)).astype(np.float32)
    pj = dict(pj, up_w=jnp.asarray(rng.normal(size=cfg.upsampling_factor),
                                   jnp.float32), up_b=jnp.float32(0.2))
    pt = dict(pt, up_w=torch.from_numpy(np.array(pj["up_w"])),
              up_b=torch.tensor(0.2))
    np.testing.assert_array_equal(
        TQ.upsample_aux(pt, torch.from_numpy(h), cfg.upsampling_factor),
        np.asarray(JQ.upsample_aux(pj, jnp.asarray(h),
                                   cfg.upsampling_factor)))
    x = rng.normal(size=(2, 9, 3)).astype(np.float32)
    for d in (0, 1, 4, 9):
        np.testing.assert_array_equal(
            TQ.shift_time(torch.from_numpy(x), d),
            np.asarray(JQ.shift_time(jnp.asarray(x), d)))


def _inputs(cfg, seed, B=2, F=14, d_lo=1.0, d_hi=3.5):
    rng = np.random.default_rng(seed)
    up = cfg.upsampling_factor
    x = rng.integers(0, cfg.n_quantize, (B, F * up)).astype(np.int32)
    h = rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32)
    d = np.repeat(rng.uniform(d_lo, d_hi, (B, F)), up, 1).astype(np.float32)
    return x, h, d


@pytest.mark.parametrize("seed,d_lo,d_hi", [(0, 1.0, 3.5), (1, 0.4, 1.6),
                                            (2, 5.0, 7.4)])
def test_forward_f32_matches_jax(seed, d_lo, d_hi):
    pj, pt, cfg_j, cfg = carried(seed)
    x, h, d = _inputs(cfg, seed, d_lo=d_lo, d_hi=d_hi)
    ref = np.asarray(jax_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(h),
                                 jnp.asarray(d)))
    got = TQ.forward(pt, cfg, torch.from_numpy(x), torch.from_numpy(h),
                     torch.from_numpy(d))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_forward_bf16_close_to_jax():
    """bf16 storage points as in JAX; the two frameworks round some
    intermediates at other places, so 0.03 (the repo's bf16 engine
    tolerance)."""
    pj, pt, cfg_j, cfg = carried(3)
    x, h, d = _inputs(cfg, 3)
    ref = np.asarray(jax_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(h),
                                 jnp.asarray(d), compute_dtype=jnp.bfloat16))
    got = TQ.forward(pt, cfg, torch.from_numpy(x), torch.from_numpy(h),
                     torch.from_numpy(d), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=0.03)


def test_forward_with_sample_rate_aux_matches_jax():
    pj, pt, cfg_j, cfg = carried(4)
    x, h, d = _inputs(cfg, 4)
    h_up = np.repeat(h, cfg.upsampling_factor, 1)
    ref = np.asarray(jax_forward(pj, cfg_j, jnp.asarray(x), None,
                                 jnp.asarray(d), h_up=jnp.asarray(h_up)))
    got = TQ.forward(pt, cfg, torch.from_numpy(x), None, torch.from_numpy(d),
                     h_up=torch.from_numpy(h_up))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_fused_training_engine_is_not_ported():
    """The fused training engine is ported now (tests/
    test_torch_port_train_kernel.py holds it against JAX): on the CPU it
    runs the kernel's twin, which gives the plain engine's logits; an
    unknown engine name is refused."""
    _, pt, _, cfg = carried(5)
    x, h, d = _inputs(cfg, 5)
    args = (pt, cfg, torch.from_numpy(x), torch.from_numpy(h),
            torch.from_numpy(d))
    np.testing.assert_allclose(
        TQ.forward(*args, fixed_engine="pallas").numpy(),
        TQ.forward(*args, fixed_engine="xla").numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="fixed_engine"):
        TQ.forward(*args, fixed_engine="scan")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TQ.init_params(0, ModelConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        TQ.params_from_numpy({"a": np.zeros(2)})


def test_plain_engine_runs_in_float64():
    """The f64 plain engine (the reference for f32 gradients) computes the
    f32 forward's logits in f64."""
    pj, pt, cfg_j, cfg = carried(6)
    x, h, d = _inputs(cfg, 6)
    args = (torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(d))
    p64 = TQ.tree_map(lambda t: t.double(), pt)
    got = TQ.forward(p64, cfg, *args, compute_dtype=torch.float64)
    assert got.dtype == torch.float64
    ref = jax_forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(h),
                      jnp.asarray(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
