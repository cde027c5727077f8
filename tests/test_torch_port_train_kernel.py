"""PyTorch port vs the JAX package: the fused training stack (K2).

The port's plain twins of the forward and backward kernels
(`qpnet_tpu_torch/ops/train_kernel.py`) are held against the JAX package's
Pallas kernels run in interpret mode, and the port's whole-loss gradients
through `forward(fixed_engine="pallas")` against JAX's, on the tiny config
of tests/test_train_kernel.py with the same inputs and weights.  The CUDA
kernels themselves are held against the twins on the card by
chip_smoke.py (phase 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.models import forward as jax_forward
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.ops import train_kernel as JTK
from qpnet_tpu.train.step import masked_ce_loss as jax_masked_ce_loss
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models import qpnet as TQ
from qpnet_tpu_torch.ops import train_kernel as TK
from qpnet_tpu_torch.train.step import masked_ce_loss

TINY = dict(n_quantize=32, n_aux=5, n_resch=16, n_skipch=8,
            dilationF_depth=3, dilationF_repeat=2,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=4)
R, S, UP = 16, 8, 4
DILS_F, DILS_A = (1, 2, 4, 1, 2, 4), (1, 2)


@pytest.fixture(autouse=True)
def small_tile(monkeypatch):
    # the JAX kernel's time tile, small enough for interpret-mode sizes
    monkeypatch.setattr(JTK, "TILE", 64)


def stack_inputs(seed, B, T, fused, d_range=(1.0, 3.0)):
    """Numpy inputs of one stack call: weights, o0, h_up, d_frames."""
    rng = np.random.default_rng(seed)
    L = len(DILS_F) + (len(DILS_A) if fused else 0)
    w = {
        "W_in": rng.normal(size=(L, 2 * R, 2 * R)) / np.sqrt(2 * R),
        "W_aux": rng.normal(size=(L, TK.AUX_PAD, 2 * R)) / np.sqrt(8),
        "b_gate": 0.1 * rng.normal(size=(L, 2 * R)),
        "W_out": rng.normal(size=(L, R, S + R)) / np.sqrt(R),
        "b_res": 0.1 * rng.normal(size=(L, R)),
    }
    w = {k: v.astype(np.float32) for k, v in w.items()}
    o0 = rng.normal(size=(B, T, R)).astype(np.float32)
    h = np.zeros((B, T, TK.AUX_PAD), np.float32)
    h[..., :5] = rng.normal(size=(B, T, 5))
    d = rng.uniform(*d_range, size=(B, -(-T // UP))).astype(np.float32)
    return w, o0, h, d


def static_of(fused, maxd):
    return (DILS_F, DILS_A if fused else (), maxd if fused else 1, UP, R, S)


def jax_fwd(w, o0, h, d, fused, maxd, dtype_name):
    """The JAX forward kernel in interpret mode, T padded to its tile as
    the JAX forward pads it; outputs cut back to T."""
    B, T, _ = o0.shape
    TS = JTK.tile_for(UP)
    Tp = -(-T // TS) * TS
    jd = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    o_p = jnp.pad(jnp.asarray(o0, jd), ((0, 0), (0, Tp - T), (0, 0)))
    h_p = jnp.pad(jnp.asarray(h, jd), ((0, 0), (0, Tp - T), (0, 0)))
    d_p = jnp.pad(jnp.asarray(d), ((0, 0), (0, Tp // UP - d.shape[1])),
                  constant_values=1.0) if fused else None
    out = JTK._fwd_call(
        o_p, h_p, d_p, jnp.asarray(w["W_in"], jd), jnp.asarray(w["W_aux"], jd),
        jnp.asarray(w["b_gate"]), jnp.asarray(w["W_out"], jd),
        jnp.asarray(w["b_res"]), dilsF=DILS_F, dilsA=DILS_A if fused else (),
        maxd=maxd if fused else 1, up=UP, R=R, S=S, TS=TS,
        dtype_name=dtype_name, interpret=True)
    o_out, skip, oall, st = (np.asarray(a, np.float32) for a in out)
    return o_out[:, :T], skip[:, :T], oall[:, :, :T], st[:, :, :T]


def port_fwd(w, o0, h, d, fused, maxd, dtype):
    W = {k: torch.from_numpy(v) for k, v in w.items()}
    out = TK.stack_forward(static_of(fused, maxd), dtype, W,
                           torch.from_numpy(o0).to(dtype),
                           torch.from_numpy(h).to(dtype),
                           torch.from_numpy(d) if fused else None)
    return [t.float().numpy() for t in out]


@pytest.mark.parametrize("fused", [False, True], ids=["fixed", "fused"])
@pytest.mark.parametrize("T", [128, 96 + 12], ids=["tile", "ragged"])
def test_twin_forward_f32_matches_pallas(fused, T):
    w, o0, h, d = stack_inputs(0, 2, T, fused)
    ref = jax_fwd(w, o0, h, d, fused, 4, "float32")
    got = port_fwd(w, o0, h, d, fused, 4, torch.float32)
    for name, a, b in zip(("o_out", "skip", "oall", "st"), ref, got):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("fused", [False, True], ids=["fixed", "fused"])
def test_twin_forward_bf16_matches_pallas(fused):
    w, o0, h, d = stack_inputs(1, 1, 128, fused)
    ref = jax_fwd(w, o0, h, d, fused, 4, "bfloat16")
    got = port_fwd(w, o0, h, d, fused, 4, torch.bfloat16)
    for name, a, b in zip(("o_out", "skip", "oall", "st"), ref, got):
        np.testing.assert_allclose(b, a, atol=5e-2, err_msg=name)
        frob = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-8)
        assert frob <= 1e-2, (name, frob)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1e-8)


@pytest.mark.parametrize("fused,T,maxd,d_range", [
    (False, 128, 4, (1.0, 3.0)),
    (True, 128, 4, (1.0, 3.0)),
    # look-backs up to 2 * 60 = 120 rows: more than one 64-row JAX tile
    (True, 320, 64, (30.0, 60.0)),
], ids=["fixed", "fused", "fused-long-lookback"])
def test_twin_backward_f32_matches_pallas_vjp(fused, T, maxd, d_range):
    w, o0, h, d = stack_inputs(2, 2, T, fused, d_range)
    rng = np.random.default_rng(3)
    do = rng.normal(size=(2, T, R)).astype(np.float32)
    dskip = rng.normal(size=(2, T, S)).astype(np.float32)
    static = static_of(fused, maxd)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jd = jnp.asarray(d) if fused else None

    def f(weights, o0_, h_):
        return JTK.fixed_stack_fused(static, "float32", True, weights, o0_,
                                     h_, jd)

    _, vjp = jax.vjp(f, jw, jnp.asarray(o0), jnp.asarray(h))
    jdw, jdo0, jdh = vjp((jnp.asarray(do), jnp.asarray(dskip)))

    W = {k: torch.from_numpy(v) for k, v in w.items()}
    td = torch.from_numpy(d) if fused else None
    _, _, oall, st = TK.stack_forward(static, torch.float32, W,
                                      torch.from_numpy(o0),
                                      torch.from_numpy(h), td)
    do0, dh, dW = TK.stack_backward(static, torch.float32, W, oall, st,
                                    torch.from_numpy(h), td,
                                    torch.from_numpy(do),
                                    torch.from_numpy(dskip))
    assert _rel(jdo0, do0.numpy()) < 2e-5
    assert _rel(jdh, dh.numpy()) < 2e-5
    for k in TK._WEIGHT_KEYS:
        assert _rel(jdw[k], dW[k].numpy()) < 2e-5, k


def test_autograd_function_matches_twin_backward():
    """FixedStackFused's gradient is the backward twin's, including the
    cotangent types (o0 and h_up in bf16 come back in bf16)."""
    w, o0, h, d = stack_inputs(4, 1, 64, True)
    static = static_of(True, 4)
    W = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    o0_t = torch.from_numpy(o0).to(torch.bfloat16).requires_grad_()
    h_t = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    td = torch.from_numpy(d)
    o_out, skip = TK.fixed_stack_fused(static, torch.bfloat16, W, o0_t, h_t,
                                       td)
    rng = np.random.default_rng(5)
    do = torch.from_numpy(rng.normal(size=o_out.shape).astype(np.float32))
    dskip = torch.from_numpy(rng.normal(size=skip.shape).astype(np.float32))
    torch.autograd.backward([o_out, skip], [do.to(torch.bfloat16), dskip])
    assert o0_t.grad.dtype == torch.bfloat16
    assert h_t.grad.dtype == torch.bfloat16
    _, _, oall, st = TK.stack_forward(static, torch.bfloat16, W, o0_t.detach(),
                                      h_t.detach(), td)
    do0, dh, dW = TK.stack_backward(
        static, torch.bfloat16, {k: v.detach() for k, v in W.items()}, oall,
        st, h_t.detach(), td, do.to(torch.bfloat16).float(), dskip)
    assert torch.equal(o0_t.grad, do0.to(torch.bfloat16))
    assert torch.equal(h_t.grad, dh.to(torch.bfloat16))
    for k in TK._WEIGHT_KEYS:
        assert torch.equal(W[k].grad, dW[k]), k


def test_wrappers_run_the_twin_on_cpu_only():
    TK.reset_launch_counts()
    w, o0, h, d = stack_inputs(6, 1, 32, False)
    W = {k: torch.from_numpy(v) for k, v in w.items()}
    out = TK.stack_forward(static_of(False, 1), torch.float32, W,
                           torch.from_numpy(o0), torch.from_numpy(h), None)
    ref = TK.fixed_stack_reference_fwd(static_of(False, 1), torch.float32, W,
                                       torch.from_numpy(o0),
                                       torch.from_numpy(h), None)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert TK.fwd_launch_count == 0 and TK.bwd_launch_count == 0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TK.stack_forward(static_of(False, 1), torch.float32, W,
                         torch.from_numpy(o0).to("meta"),
                         torch.from_numpy(h).to("meta"), None)


# --- whole-loss gradients through forward(fixed_engine="pallas") -----------

def carried(seed):
    cfg_j, cfg_t = JaxConfig(**TINY), ModelConfig(**TINY)
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    pt = TQ.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return pj, pt, cfg_j, cfg_t


def make_batch(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    F = T // cfg.upsampling_factor
    return {
        "x": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
        "h": rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32),
        "t": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
        "d": np.repeat(rng.uniform(1.0, 3.0, (B, F)), cfg.upsampling_factor,
                       axis=1)[:, :T].astype(np.float32),
        "valid_len": np.int32(T // 2),
    }


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("maxd_bucket", [None, 4], ids=["fixed", "fused"])
def test_loss_gradients_match_jax(maxd_bucket):
    pj, pt, cfg_j, cfg = carried(7)
    batch = make_batch(cfg, 2, 128, 7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        logits = jax_forward(p, cfg_j, jb["x"], jb["h"], jb["d"],
                             compute_dtype=jnp.float32, fixed_engine="pallas",
                             interpret=True, maxd_bucket=maxd_bucket)
        return jax_masked_ce_loss(logits, jb["t"], jb["valid_len"])

    lj, gj = jax.value_and_grad(jloss)(pj)
    for _, p in flat_leaves(pt):
        p.requires_grad_()
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    logits = TQ.forward(pt, cfg, tb["x"], tb["h"], tb["d"],
                        fixed_engine="pallas", maxd_bucket=maxd_bucket)
    lt = masked_ce_loss(logits, tb["t"], tb["valid_len"])
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    gj_flat = dict(flat_leaves(jax.tree_util.tree_map(np.asarray, gj)))
    for name, p in flat_leaves(pt):
        # a leaf that no output depends on (the last block's W_res) has no
        # grad in torch and a zero one in JAX
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert _rel(gj_flat[name], g.numpy()) < 2e-5, name
