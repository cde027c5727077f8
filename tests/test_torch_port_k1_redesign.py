"""The generation kernel's twin as the Hopper kernel's checks use it.

The CUDA kernel sums its bf16 W_in and W_out products on tensor cores, in
an order the twin cannot repeat, so the card holds both the kernel and
the f32 twin to the twin summed in float64 (`f64_sums=True`).  Here, on
the CPU: the f64 twin against the JAX kernel `pallas_generate(interpret=
True)` in both branches, the f64 twin against the f32 twin under the
card's gate, chunked f64 and w8a8 runs against one-shot runs (a chunk's
first step loads E_prev from x), and the host-launch arithmetic and
kernel names that chip_smoke.py and the bench report.  The kernel itself
is held against the twin on the card by chip_smoke.py."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.models import generate as JG
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.ops.gen_kernel import pallas_generate
from qpnet_tpu_torch import bench
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models import generate as TG
from qpnet_tpu_torch.models import qpnet as TQ
from qpnet_tpu_torch.ops import gen_kernel as TK

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=2,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=5)
UP = TINY["upsampling_factor"]
FORCED_ATOL = 1e-2      # bf16 storage points, sums in another order
F64_TOL = 2e-2          # chip_smoke.py's gate: max |dlogit| to the f64 twin
ARGMAX_AGREE_MIN = 0.98


def case(seed, quantize, B=3, F=6):
    """One chunk's inputs in the JAX kernel's and the port's layout, from
    the same parameters, with a forced stream."""
    cfg_j, cfg = JaxConfig(**TINY), ModelConfig(**TINY)
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    pt = TQ.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    rng = np.random.default_rng(seed)
    n = F * UP
    h = rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32)
    d = np.repeat(rng.uniform(1.0, 4.0, (B, F)), UP, 1).astype(np.float32)
    x0 = np.full((B, 1), cfg.n_quantize // 2, np.int32)
    maxd, x_seed, d_gen = TG._seed_and_d(cfg, x0, d[:, :n - 1], n)
    hj, dj, _ = JG._pallas_host_prep(cfg_j, h, d_gen, n)
    jstate = JG._pallas_prologue(pj, cfg_j, jnp.asarray(x_seed),
                                 jnp.asarray(hj[0]), maxd=maxd,
                                 quantize=quantize, const_seed=True)
    ht, dt, _ = TG._pallas_host_prep(cfg, h, d_gen, n, "cpu")
    tstate = TG._prologue(pt, cfg, torch.from_numpy(x_seed), ht[0], maxd,
                          const_seed=True, quantize=quantize)
    xf = rng.integers(0, cfg.n_quantize, (n, 1, B)).astype(np.int32)
    return dict(cfg_j=cfg_j, cfg=cfg, B=B, F=F, n=n, maxd=maxd,
                jstate=jstate, jh=(jnp.asarray(hj[:F]), jnp.asarray(dj[:F])),
                tstate=tstate, th=(ht[:F], dt[:F]), xf=xf)


def twin(c, quantize, mode, f64_sums, **kw):
    packed, bF, bA, x0 = c["tstate"]
    kw = dict(dict(B=c["B"], maxd=c["maxd"], n_steps=c["n"]), **kw)
    return TK.generate_reference(
        packed, c["cfg"], bF, bA, x0, *c["th"], 11, mode=mode,
        x_forced=torch.from_numpy(c["xf"]) if mode == "forced" else None,
        quantize=quantize, f64_sums=f64_sums, **kw)


@pytest.mark.parametrize("quantize", ["none", "w8a8"])
@pytest.mark.parametrize("seed", [0, 3])
def test_f64_twin_matches_jax_kernel(seed, quantize):
    """Forced logits of the f64 twin against JAX's kernel in interpret mode
    at every step, at a non-zero step and batch offset; the carried x
    state equal and the rings within the bf16 storage tolerance."""
    c = case(seed, quantize)
    kw = dict(step_offset=2 * c["n"], b_offset=4)
    packed, bF, bA, x0 = c["jstate"]
    jout = pallas_generate(packed, c["cfg_j"], bF, bA, x0, *c["jh"], 11,
                           interpret=True, quantize=quantize, mode="forced",
                           x_forced=jnp.asarray(c["xf"]), B=c["B"],
                           maxd=c["maxd"], n_steps=c["n"], **kw)
    tout = twin(c, quantize, "forced", True, **kw)
    assert tout[0].shape == jout[0].shape
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               atol=FORCED_ATOL, rtol=0)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    for a, b in zip(tout[1:3], jout[1:3]):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   atol=FORCED_ATOL)


@pytest.mark.parametrize("quantize", ["none", "w8a8"])
def test_f32_twin_meets_the_f64_gate(quantize):
    """chip_smoke.py's bf16 gate, with the f32 twin in the kernel's place:
    within max(F64_TOL, 2 x its own distance) of the f64 twin, and argmax
    agreement >= ARGMAX_AGREE_MIN with itself summed in f64."""
    c = case(5, quantize, B=4, F=8)
    f32 = twin(c, quantize, "forced", False)[0]
    f64 = twin(c, quantize, "forced", True)[0]
    assert torch.isfinite(f64).all()
    err = float((f32 - f64).abs().max())
    assert err <= F64_TOL, err
    agree = float((f32.argmax(-1) == f64.argmax(-1)).float().mean())
    assert agree >= ARGMAX_AGREE_MIN, agree


@pytest.mark.parametrize("quantize,f64_sums", [("none", True),
                                               ("w8a8", False)])
@pytest.mark.parametrize("mode", ["forced", "sampling"])
def test_chunked_twin_equals_one_shot(quantize, f64_sums, mode):
    """A chunk's first step loads E_prev from x (the kernel's t == 0 flag),
    so 1 + 2 + 3-frame chunks carry the state exactly."""
    c = case(8, quantize, B=3, F=6)
    one = twin(c, quantize, mode, f64_sums)
    packed, *state = c["tstate"]
    ht, dt = c["th"]
    xf = torch.from_numpy(c["xf"])
    pieces = []
    for f0, f1 in ((0, 1), (1, 3), (3, 6)):
        out, *state = TK.generate_reference(
            packed, c["cfg"], *state, ht[f0:f1], dt[f0:f1], 11, B=c["B"],
            maxd=c["maxd"], n_steps=(f1 - f0) * UP, mode=mode,
            step_offset=f0 * UP, quantize=quantize, f64_sums=f64_sums,
            x_forced=xf[f0 * UP:f1 * UP] if mode == "forced" else None)
        pieces.append(out)
    assert torch.equal(torch.cat(pieces), one[0])
    for a, b in zip(state, one[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("network,layers", [("default", 16),
                                            ("Rd10Rr3Ed4Er1", 34)])
def test_host_launches_per_call(network, layers):
    cfg = ModelConfig.from_network_name(network)
    for frames in (1, 4, 10):
        h = TK.host_launches(cfg, frames * cfg.upsampling_factor)
        assert h == {"host_launches": 1 + frames,
                     "kernels_per_step": 2 * layers + 4}


def test_bench_kernel_names_are_the_sources():
    """Every kernel that bench and chip_smoke.py report by name is a kernel
    of csrc/gen_kernel.cu, and every kernel there is reported."""
    src = (Path(TK.__file__).resolve().parent.parent / "csrc"
           / "gen_kernel.cu").read_text()
    defined = set(re.findall(r"^__global__ void (?:__launch_bounds__\(\w+\)\s*)?(\w+)\(",
                             src, re.M))
    defined |= set(re.findall(r"^(\w+)\(const Ctx\* ctx", src, re.M))
    reported = {v.split("<")[0] for v in bench.KERNELS.values()}
    assert reported == defined
    inst = set(re.findall(r"prod_kernel<(k\w+), (true|false)>", src))
    prods = {"kGate": 0, "kOut": 1, "kPost1": 2, "kPost2": 3}
    assert {f"prod_kernel<{prods[p]},{q}>" for p, q in inst} == {
        v for v in bench.KERNELS.values() if v.startswith("prod_kernel")}
