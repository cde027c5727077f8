"""Seeded QPNet weights made on the device, in the parameter tree that the
program and the reference both take (keys and shapes of the JAX package's
layout).

One draw of uniforms for the whole tree on a torch.Generator of the
device, cut into leaves: the matrices scaled to Xavier-uniform bounds over
the reference convolutions' fans, the biases to +-0.1, and the upsampler's
per-phase scale to 1 +- 0.1 and its bias to +-0.05, so that every bias and
the upsampler take part in the products that are checked.
"""

from __future__ import annotations

import math

import torch

from qpbench.flops import dilations


def leaf_specs(cfg):
    """[(path, shape, low, high)] of every leaf, in a fixed order."""
    Q, A = cfg["n_quantize"], cfg["n_aux"]
    R, S = cfg["n_resch"], cfg["n_skipch"]
    up = cfg["upsampling_factor"]

    def xav(fan_in, fan_out):
        b = math.sqrt(6.0 / (fan_in + fan_out))
        return -b, b

    bias = (-0.1, 0.1)
    specs = [(("embed_prev",), (Q, R), *xav(2 * Q, 2 * R)),
             (("embed_cur",), (Q, R), *xav(2 * Q, 2 * R)),
             (("b_causal",), (R,), *bias),
             (("up_w",), (up,), 0.9, 1.1),
             (("up_b",), (), -0.05, 0.05)]
    fixed, adaptive = dilations(cfg)
    for kind, n in (("fixed", len(fixed)), ("adaptive", len(adaptive))):
        fan = 2 * R if kind == "fixed" else R
        for i in range(n):
            specs += [((kind, i, "W_cur"), (R, 2 * R), *xav(fan, fan)),
                      ((kind, i, "W_prev"), (R, 2 * R), *xav(fan, fan)),
                      ((kind, i, "W_aux"), (A, 2 * R), *xav(A, R)),
                      ((kind, i, "b_gate"), (2 * R,), *bias),
                      ((kind, i, "W_skip"), (R, S), *xav(R, S)),
                      ((kind, i, "b_skip"), (S,), *bias),
                      ((kind, i, "W_res"), (R, R), *xav(R, R)),
                      ((kind, i, "b_res"), (R,), *bias)]
    specs += [(("W_post1",), (S, S), *xav(S, S)),
              (("b_post1",), (S,), *bias),
              (("W_post2",), (S, Q), *xav(S, Q)),
              (("b_post2",), (Q,), *bias)]
    return specs


def make_params(cfg, seed: int, device) -> dict:
    """The weights of `seed`, f32 on `device`."""
    specs = leaf_specs(cfg)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(sum(sizes), generator=gen, device=device)
    fixed, adaptive = dilations(cfg)
    tree = {"fixed": [{} for _ in fixed], "adaptive": [{} for _ in adaptive]}
    off = 0
    for (path, shape, lo, hi), n in zip(specs, sizes):
        leaf = (u[off:off + n] * (hi - lo) + lo).reshape(shape)
        off += n
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    return tree


def count(cfg) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in leaf_specs(cfg))
