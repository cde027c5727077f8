"""The reference against the port's CPU paths on a tiny configuration."""

import numpy as np
import pytest
import torch

from qpbench import corpus
from qpbench.runners.decode import model_config
from qpbench.reference import model as M
from qpbench.tests import tiny
from qpbench.weights import make_params

CFG = {**tiny.TINY, "dense_factor": 8, "kernel_size": 2}


def inputs(seed, B=2, F=12):
    g = corpus.rng(seed)
    up = CFG["upsampling_factor"]
    h = g.standard_normal((B, F, CFG["n_aux"])).astype(np.float32)
    f0 = np.stack([corpus.f0_track(g, F, 90, 300) for _ in range(B)])
    d = corpus.dilation(f0, 8).astype(np.float32)
    x = g.integers(0, CFG["n_quantize"], (B, F * up))
    return h, d, x


def test_forward_equals_the_ports_plain_forward():
    from qpnet_tpu_torch.models import qpnet
    params = make_params(CFG, 3, "cpu")
    h, d, x = inputs(4)
    up = CFG["upsampling_factor"]
    ht, dt = torch.as_tensor(h), torch.as_tensor(np.repeat(d, up, 1))
    xt = torch.as_tensor(x)
    ref = M.forward(params, CFG, xt, M.upsample(params, ht, up), dt)
    port = qpnet.forward(params, model_config(CFG), xt, ht, dt)
    assert torch.allclose(ref, port, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("engine,tol", [("xla", 1e-4), ("pallas", 0.05)])
def test_generation_logits_equal_the_ports_forced_logits(engine, tol):
    """Teacher-forced generation: the scan engine in f32 to rounding, the
    kernel's CPU twin (bf16) to bf16's."""
    from qpnet_tpu_torch.models import generate as G
    params = make_params(CFG, 5, "cpu")
    h, d, x = inputs(6)
    up = CFG["upsampling_factor"]
    n = x.shape[1]
    mid = np.full((2, 1), CFG["n_quantize"] // 2)
    port = G.teacher_forced_logits(
        params, model_config(CFG), mid, h, x, np.repeat(d, up, 1),
        engine=engine, compute_dtype=torch.float32, device="cpu")
    for b in range(2):
        ref = M.generation_logits(params, CFG, torch.as_tensor(h[b]),
                                  torch.as_tensor(d[b]),
                                  torch.as_tensor(x[b]))
        assert ref.shape == (n, CFG["n_quantize"])
        assert float((ref - torch.as_tensor(port[b])).abs().max()) < tol


def test_training_reference_follows_the_ports_steps():
    """A whole tiny train run: its first three losses, first gradient and
    change agree with the reference's to f32 rounding."""
    run = tiny.run("default.train.f32", seconds=0.3)
    assert run.correct
    assert run.checks["loss_gap"].value < 1e-5
    assert run.checks["grad_gap"].value < 1e-4
    assert run.checks["change_gap"].value < 1e-3
    assert run.counts["kept_leaves"] >= run.counts["leaves"] - 4


def test_sampled_excess_tells_a_sound_sampler_from_broken_ones():
    """Tokens the port samples read near 0; uniform draws, the same tokens
    shifted by one class, and greedy tokens read far from it."""
    from qpnet_tpu_torch.models import generate as G
    from qpbench.reference import judge as J
    params = make_params(CFG, 7, "cpu")
    B, F = 4, 100
    h, d, _ = inputs(8, B, F)
    up, Q = CFG["upsampling_factor"], CFG["n_quantize"]
    n = F * up - 1

    def tokens(mode):
        out = G.batch_fast_generate(
            params, model_config(CFG), np.full((B, 1), Q // 2), h, [n] * B,
            np.repeat(d, up, 1), seed=9, mode=mode, device="cpu")
        return [torch.as_tensor(np.asarray(o)) for o in out]

    def excess(toks):
        return J.sampled_excess(params, CFG, [
            (torch.as_tensor(h[b]), torch.as_tensor(d[b]), toks[b])
            for b in range(B)])
    sampled = tokens("sampling")
    g = torch.Generator().manual_seed(10)
    sound = excess(sampled)
    assert sound < 0.05
    assert excess([torch.randint(0, Q, (n,), generator=g)
                   for _ in range(B)]) > 4 * sound
    assert excess([(t + 1) % Q for t in sampled]) > 4 * sound
    assert excess(tokens("argmax")) > 4 * sound
