"""The training kernels' twins as the Hopper kernels' checks use them.

The CUDA kernels (csrc/train_kernel.cu) sum their products on tensor cores,
bf16 or split TF32, in an order no plain code repeats, so the card holds
the bf16 kernel and the f32-summing twin to the twin summed in float64
(`f64_sums=True`), and the f32 kernel to the f32 twin.  Here, on the CPU,
at R=64: the f64 twin against the JAX kernels in interpret mode (`_fwd_call`
and `jax.vjp(fixed_stack_fused)`), forward and backward, f32 and bf16,
fixed and fused, at a tile-multiple and a ragged T; the f64 twin against
the f32 twin; the transposed and interleaved weights the wrapper builds
for the forward kernel; the bounds chip_smoke.py and the bench report;
and the wrappers' choice of the twin on CPU tensors only.  The kernels themselves
are held against the twins on the card by chip_smoke.py (phase 6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.ops import train_kernel as JTK
from qpnet_tpu_torch import bench
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.ops import train_kernel as TK

R, S, UP = 64, 32, 4
DILS_F, DILS_A = (1, 2, 4), (1, 2)
# f32: the f64 twin and the JAX kernel differ only in the f32 rounding of
# their sums.  bf16: both round at the same storage points, but a sum that
# lands next to a bf16 rounding boundary rounds the other way in one of
# them, and that one-ulp flip moves later layers: a max |d| of a few bf16
# ulps of scale, and a small relative Frobenius distance.
F32_TOL = 1e-5
BF16_ATOL, BF16_FROB = 5e-2, 1e-2
NAMES_FWD = ("o_out", "skip", "oall", "st")


@pytest.fixture(autouse=True)
def small_tile(monkeypatch):
    # the JAX kernel's time tile, small enough for interpret-mode sizes
    monkeypatch.setattr(JTK, "TILE", 64)


def stack_inputs(seed, B, T, fused):
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
    d = rng.uniform(1.0, 3.0, size=(B, -(-T // UP))).astype(np.float32)
    return w, o0, h, d


def deinterleave(W, R):
    """Inverse of TK.interleave_gate_columns on the last axis."""
    H = TK.GATE_HALF
    lead = W.shape[:-1]
    return W.reshape(*lead, R // H, 2, H).transpose(-3, -2).reshape(
        *lead, 2 * R)


def static_of(fused, maxd=4):
    return (DILS_F, DILS_A if fused else (), maxd if fused else 1, UP, R, S)


def jdt(dtype):
    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def jax_fwd(w, o0, h, d, fused, dtype):
    """The JAX forward kernel in interpret mode, T padded to its tile as
    the JAX forward pads it; outputs cut back to T."""
    B, T, _ = o0.shape
    TS = JTK.tile_for(UP)
    Tp = -(-T // TS) * TS
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    o_p = jnp.pad(jnp.asarray(o0, jd), ((0, 0), (0, Tp - T), (0, 0)))
    h_p = jnp.pad(jnp.asarray(h, jd), ((0, 0), (0, Tp - T), (0, 0)))
    d_p = jnp.pad(jnp.asarray(d), ((0, 0), (0, Tp // UP - d.shape[1])),
                  constant_values=1.0) if fused else None
    out = JTK._fwd_call(
        o_p, h_p, d_p, jnp.asarray(w["W_in"], jd), jnp.asarray(w["W_aux"], jd),
        jnp.asarray(w["b_gate"]), jnp.asarray(w["W_out"], jd),
        jnp.asarray(w["b_res"]), dilsF=DILS_F, dilsA=DILS_A if fused else (),
        maxd=4 if fused else 1, up=UP, R=R, S=S, TS=TS,
        dtype_name=jdt(dtype), interpret=True)
    o_out, skip, oall, st = (np.asarray(a, np.float32) for a in out)
    return o_out[:, :T], skip[:, :T], oall[:, :, :T], st[:, :, :T]


def torch_inputs(w, o0, h, d, fused, dtype):
    return ({k: torch.from_numpy(v) for k, v in w.items()},
            torch.from_numpy(o0).to(dtype), torch.from_numpy(h).to(dtype),
            torch.from_numpy(d) if fused else None)


def assert_close(got, ref, dtype, name):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)
        return
    np.testing.assert_allclose(got, ref, atol=BF16_ATOL, err_msg=name)
    frob = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-8)
    assert frob <= BF16_FROB, (name, frob)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fused", [False, True], ids=["fixed", "fused"])
@pytest.mark.parametrize("T", [128, 96 + 12], ids=["tile", "ragged"])
def test_f64_twin_forward_matches_pallas(dtype, fused, T):
    w, o0, h, d = stack_inputs(10, 2, T, fused)
    ref = jax_fwd(w, o0, h, d, fused, dtype)
    W, to0, th, td = torch_inputs(w, o0, h, d, fused, dtype)
    got = TK.fixed_stack_reference_fwd(static_of(fused), dtype, W, to0, th,
                                       td, f64_sums=True)
    for name, a, b in zip(NAMES_FWD, ref, got):
        assert_close(b.float().numpy(), a, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fused", [False, True], ids=["fixed", "fused"])
@pytest.mark.parametrize("T", [128, 96 + 12], ids=["tile", "ragged"])
def test_f64_twin_backward_matches_pallas_vjp(dtype, fused, T):
    """The f64 twin's backward, fed the JAX forward's saved activations,
    against the JAX custom VJP in interpret mode: the gradients of o0,
    h_up and every weight."""
    B = 2
    w, o0, h, d = stack_inputs(11, B, T, fused)
    rng = np.random.default_rng(12)
    do = rng.normal(size=(B, T, R)).astype(np.float32)
    dskip = rng.normal(size=(B, T, S)).astype(np.float32)
    static = static_of(fused)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jdf = jnp.asarray(d) if fused else None
    TS = JTK.tile_for(UP)
    Tp = -(-T // TS) * TS
    pad = ((0, 0), (0, Tp - T), (0, 0))
    jdf_p = (jnp.pad(jdf, ((0, 0), (0, Tp // UP - d.shape[1])),
                     constant_values=1.0) if fused else None)

    def f(weights, o0_, h_):
        return JTK.fixed_stack_fused(static, jdt(dtype), True, weights, o0_,
                                     h_, jdf_p)

    (_, _), vjp = jax.vjp(f, jw, jnp.pad(jnp.asarray(o0, jd), pad),
                          jnp.pad(jnp.asarray(h, jd), pad))
    jdw, jdo0, jdh = vjp((jnp.pad(jnp.asarray(do, jd), pad),
                          jnp.pad(jnp.asarray(dskip), pad)))
    ref = [np.asarray(jdo0, np.float32)[:, :T],
           np.asarray(jdh, np.float32)[:, :T]]
    ref += [np.asarray(jdw[k], np.float32) for k in TK._WEIGHT_KEYS]

    W, to0, th, td = torch_inputs(w, o0, h, d, fused, dtype)
    _, _, oall, st = TK.fixed_stack_reference_fwd(static, dtype, W, to0, th,
                                                  td, f64_sums=True)
    do_t = torch.from_numpy(do).to(dtype).float()
    do0, dh, dW = TK.fixed_stack_reference_bwd(
        static, dtype, W, oall, st, th, td, do_t, torch.from_numpy(dskip),
        f64_sums=True)
    got = [do0, dh] + [dW[k] for k in TK._WEIGHT_KEYS]
    names = ["do0", "dh"] + [f"d{k}" for k in TK._WEIGHT_KEYS]
    for name, a, b in zip(names, ref, got):
        b = b.float().numpy()
        if dtype == torch.float32:
            # weight gradients sum over every row: the f32 rounding of the
            # JAX kernel's sums is relative to their largest terms
            rel = np.abs(b - a).max() / max(np.abs(a).max(), 1e-8)
            assert rel < 2e-5, (name, rel)
        else:
            rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-8)
            assert rel <= BF16_FROB, (name, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fused", [False, True], ids=["fixed", "fused"])
def test_f64_twin_within_the_cards_gate_of_the_f32_twin(dtype, fused):
    """What phase 6 holds the kernel to: the f32-summing twin lies within
    the f32 gate (1e-4 of scale) of the f64 twin, and in bf16 inside the
    2e-2 the kernel is allowed."""
    w, o0, h, d = stack_inputs(13, 1, 128, fused)
    W, to0, th, td = torch_inputs(w, o0, h, d, fused, dtype)
    static = static_of(fused)
    f32 = TK.fixed_stack_reference_fwd(static, dtype, W, to0, th, td)
    f64 = TK.fixed_stack_reference_fwd(static, dtype, W, to0, th, td,
                                       f64_sums=True)
    rng = np.random.default_rng(14)
    do = torch.from_numpy(rng.normal(size=(1, 128, R)).astype(np.float32))
    dsk = torch.from_numpy(rng.normal(size=(1, 128, S)).astype(np.float32))
    b32 = TK.fixed_stack_reference_bwd(static, dtype, W, f64[2], f64[3], th,
                                       td, do, dsk)
    b64 = TK.fixed_stack_reference_bwd(static, dtype, W, f64[2], f64[3], th,
                                       td, do, dsk, f64_sums=True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    pairs = list(zip(f32, f64)) + [(b32[0], b64[0]), (b32[1], b64[1])]
    pairs += [(b32[2][k], b64[2][k]) for k in TK._WEIGHT_KEYS]
    for a, b in pairs:
        rel = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max())
        assert rel <= tol


def test_forward_weights_unpack_exactly():
    """The forward kernel's weights (`forward_weights`): the gate's is the
    transpose of [W_in; W_aux] with interleaved columns, out's the
    transpose of W_out; both unpack to the stacked weights bit for bit."""
    rng = np.random.default_rng(18)
    L, Rw, Sw = 2, 128, 64
    W = {"W_in": rng.normal(size=(L, 2 * Rw, 2 * Rw)),
         "W_aux": rng.normal(size=(L, TK.AUX_PAD, 2 * Rw)),
         "W_out": rng.normal(size=(L, Rw, Sw + Rw))}
    W = {k: torch.from_numpy(v.astype(np.float32)) for k, v in W.items()}
    for dtype in (torch.float32, torch.bfloat16):
        gate_t, out_t = TK.forward_weights(W, dtype, Rw)
        assert gate_t.shape == (L, 2 * Rw, 2 * Rw + TK.AUX_PAD)
        assert out_t.shape == (L, Sw + Rw, Rw)
        assert gate_t.is_contiguous() and out_t.is_contiguous()
        cat = torch.cat([W["W_in"], W["W_aux"]], 1).to(dtype)
        assert torch.equal(
            deinterleave(gate_t.transpose(1, 2), Rw), cat)
        assert torch.equal(out_t.transpose(1, 2), W["W_out"].to(dtype))


def test_gate_columns_interleave_and_back_exactly():
    """The forward kernel's gate weights: tile p of 128 columns holds
    columns [64p, 64p + 64) of the s half, then the same of the t half, and
    unpacks to torch.cat([W_in, W_aux], 1) bit for bit."""
    rng = np.random.default_rng(15)
    L, Rw = 3, 512
    W_in = torch.from_numpy(rng.normal(size=(L, 2 * Rw, 2 * Rw)).astype(
        np.float32))
    W_aux = torch.from_numpy(rng.normal(size=(L, TK.AUX_PAD, 2 * Rw)).astype(
        np.float32))
    W_cat = torch.cat([W_in, W_aux], 1)
    for dtype in (torch.float32, torch.bfloat16):
        packed = TK.interleave_gate_columns(W_cat.to(dtype), Rw)
        assert packed.shape == W_cat.shape
        assert torch.equal(deinterleave(packed, Rw),
                           W_cat.to(dtype))
        H = TK.GATE_HALF
        for p in range(Rw // H):
            tile = packed[..., 2 * H * p: 2 * H * (p + 1)]
            assert torch.equal(tile[..., :H],
                               W_cat[..., H * p: H * (p + 1)].to(dtype))
            assert torch.equal(tile[..., H:],
                               W_cat[..., Rw + H * p: Rw + H * (p + 1)].to(
                                   dtype))


def test_stack_bounds_at_the_default_shape():
    """Phase 8's bounds at the default net's 12 fixed layers, B=1,
    T=30030: f32 by split TF32 on the tensor cores (3 products each at 495
    TFLOP/s, below the 67 TFLOP/s of f32 outside them), bf16 at 989."""
    cfg = ModelConfig()
    static = (tuple(cfg.dilationsF), (), 1, cfg.upsampling_factor,
              cfg.n_resch, cfg.n_skipch)
    f32 = bench.stack_bounds(static, 1, 30030, torch.float32)
    bf16 = bench.stack_bounds(static, 1, 30030, torch.bfloat16)
    assert round(f32["fwd"][0], 2) == 6.51 and round(f32["bwd"][0], 2) == 13.02
    assert round(bf16["fwd"][0], 3) == 1.087
    assert round(bf16["bwd"][0], 3) == 2.173
    for b in (f32, bf16):
        for name in ("fwd", "bwd"):
            assert b[name][1] == "operations"
    assert "split TF32" in f32["fwd"][4] and "bf16" in bf16["fwd"][4]


def test_wrappers_run_the_twin_on_cpu_tensors_only():
    TK.reset_launch_counts()
    w, o0, h, d = stack_inputs(16, 1, 40, True)
    W, to0, th, td = torch_inputs(w, o0, h, d, True, torch.bfloat16)
    static = static_of(True)
    out = TK.stack_forward(static, torch.bfloat16, W, to0, th, td)
    ref = TK.fixed_stack_reference_fwd(static, torch.bfloat16, W, to0, th, td)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    rng = np.random.default_rng(17)
    do = torch.from_numpy(rng.normal(size=(1, 40, R)).astype(np.float32))
    dsk = torch.from_numpy(rng.normal(size=(1, 40, S)).astype(np.float32))
    got = TK.stack_backward(static, torch.bfloat16, W, out[2], out[3], th, td,
                            do, dsk)
    want = TK.fixed_stack_reference_bwd(static, torch.bfloat16, W, out[2],
                                        out[3], th, td, do, dsk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(got[2][k], want[2][k]) for k in TK._WEIGHT_KEYS)
    assert TK.fwd_launch_count == 0 and TK.bwd_launch_count == 0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TK.stack_backward(static, torch.bfloat16, W, out[2].to("meta"),
                          out[3].to("meta"), th.to("meta"), None,
                          do.to("meta"), dsk.to("meta"))
