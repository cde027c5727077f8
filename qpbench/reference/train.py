"""The reference of the training cell: the first windows of the corpus, the
masked cross-entropy, its gradient and Adam, in float32.

`windows` cuts the reference recipe's training windows from the stream of
utterances again (bigpon/QPNet `qpnet_train.py`'s generator: the
utterances concatenated, each window its receptive field of history plus
`batch_length` samples shrunk to fit `max_length` and a whole number of
frames, the next window `batch_length` further, left-padded to one length
with mid-scale classes, zero aux and d = 1; the loss on the last
`batch_length` positions).  `init_params` draws the same weights from the
same seed as the program's initializer (Xavier-uniform over the
convolutions' fans from a torch.Generator on the device, biases zero, the
upsampler a repetition), so the reference starts where the program does
without reading the program's weights.  `adam_steps` follows Adam (0.9,
0.999, 1e-8) over them.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from qpbench.reference import model


def init_params(seed: int, cfg, device) -> dict:
    Q, A = cfg["n_quantize"], cfg["n_aux"]
    R, S = cfg["n_resch"], cfg["n_skipch"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def xav(shape, fan_in, fan_out):
        bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        return u * (2 * bound) - bound

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def res_block(fan):
        return {"W_cur": torch.cat([xav((R, R), fan, fan) for _ in "ab"], 1),
                "W_prev": torch.cat([xav((R, R), fan, fan) for _ in "ab"], 1),
                "W_aux": torch.cat([xav((A, R), A, R) for _ in "ab"], 1),
                "b_gate": zeros(2 * R),
                "W_skip": xav((R, S), R, S), "b_skip": zeros(S),
                "W_res": xav((R, R), R, R), "b_res": zeros(R)}

    fixed, adaptive = model.dilations(cfg)
    causal = xav((2, Q, R), Q * 2, R * 2)
    return {"embed_prev": causal[0], "embed_cur": causal[1],
            "b_causal": zeros(R),
            "up_w": torch.ones(cfg["upsampling_factor"], device=device),
            "up_b": zeros(),
            "fixed": [res_block(2 * R) for _ in fixed],
            "adaptive": [res_block(R) for _ in adaptive],
            "W_post1": xav((S, S), S, S), "b_post1": zeros(S),
            "W_post2": xav((S, Q), S, Q), "b_post2": zeros(Q)}


def mu_law(x: np.ndarray, mu: int) -> np.ndarray:
    m = mu - 1
    fx = np.sign(x) * np.log1p(m * np.abs(x)) / np.log1p(m)
    return np.floor((fx + 1) / 2 * m + 0.5).astype(np.int64)


def windows(utterances, cfg, transform, n: int):
    """The first n windows of (fs, x, h_raw, f0) utterances: dicts of x, t
    (B=1, Tp) classes, h (1, Tp / up, A) transformed aux, d (1, Tp) and
    valid_len."""
    up, dense = cfg["upsampling_factor"], cfg["dense_factor"]
    bl0, max_len = cfg["batch_length"], cfg["max_length"]
    Tp = -(-max_len // up) * up
    fixed, adaptive = model.dilations(cfg)
    xs, hs, ds, out = [], [], [], []
    for fs, x, h, f0 in utterances:
        xs.append(np.asarray(x, np.float32))
        hs.append(np.asarray(h))
        ds.append(np.repeat(fs / np.asarray(f0, np.float64) / dense, up))
        xb, hb, db = (np.concatenate(v) for v in (xs, hs, ds))
        rf = sum(fixed) + sum(adaptive) * math.ceil(db.max()) + 1
        bl = bl0 - max(rf + bl0 - max_len, 0)
        bl -= (rf + bl) % up
        h_bs = (rf + bl) // up
        x_bs = h_bs * up + 1
        while len(hb) > h_bs and len(xb) > x_bs:
            T = h_bs * up
            xq = mu_law(xb[:x_bs], cfg["n_quantize"])
            w = {"x": np.full(Tp, cfg["n_quantize"] // 2),
                 "t": np.full(Tp, cfg["n_quantize"] // 2),
                 "h": np.zeros((Tp // up, h.shape[1]), np.float32),
                 "d": np.ones(Tp, np.float32), "valid_len": bl}
            w["x"][Tp - T:], w["t"][Tp - T:] = xq[:-1], xq[1:]
            w["h"][Tp // up - h_bs:] = transform(hb[:h_bs])
            w["d"][Tp - T:] = db[:x_bs - 1]
            out.append(w)
            if len(out) == n:
                return out
            xb, hb, db = xb[bl // up * up:], hb[bl // up:], db[bl // up * up:]
        xs, hs, ds = [xb], [hb], [db]
    raise ValueError(f"the utterances hold fewer than {n} windows")


def loss(params, cfg, w, device, mm=model.f32_mm) -> torch.Tensor:
    """Mean cross-entropy of the window's last valid_len targets."""
    x = torch.as_tensor(w["x"], device=device)[None]
    t = torch.as_tensor(w["t"], device=device)[None]
    h = torch.as_tensor(w["h"], device=device)[None]
    d = torch.as_tensor(w["d"], device=device)[None]
    h_up = model.upsample(params, h, cfg["upsampling_factor"])
    logits = model.forward(params, cfg, x, h_up, d, mm)
    nll = F.cross_entropy(logits[0], t[0].long(), reduction="none")
    return nll[-int(w["valid_len"]):].mean()


def leaves(tree, path=()):
    """[(path, tensor)] in a fixed order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves(v, path + (i,))]
    return [(path, tree)]


def adam_steps(params, cfg, wins, device, lr: float, mm=model.f32_mm):
    """Adam over the windows from `params` (left unchanged): (losses,
    first gradient {path: tensor}, change after the last step {path:
    tensor})."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p0 = leaves(params)
    cur = {k: v.detach().clone().requires_grad_(True) for k, v in p0}
    tree = _rebuild(params, cur)
    m = {k: torch.zeros_like(v) for k, v in cur.items()}
    v2 = {k: torch.zeros_like(v) for k, v in cur.items()}
    losses, first = [], {}
    for i, w in enumerate(wins, 1):
        L = loss(tree, cfg, w, device, mm)
        grads = torch.autograd.grad(L, list(cur.values()),
                                    allow_unused=True)
        losses.append(float(L.detach()))
        with torch.no_grad():
            for (k, p), g in zip(cur.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                if i == 1:
                    first[k] = g.clone()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** i)
                vh = v2[k] / (1 - b2 ** i)
                p.sub_(lr * mh / (vh.sqrt() + eps))
    change = {k: (cur[k].detach() - v.detach()) for k, v in p0}
    return losses, first, change


def _rebuild(tree, flat, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, flat, path + (i,)) for i, v in enumerate(tree)]
    return flat[path]


def leaf_gap(prog: dict, ref: dict, keep):
    """The worst leaf's |norm(prog) - norm(ref)| over the larger of its
    reference norm and the median leaf's, over the leaves in `keep`."""
    norms = {k: float(ref[k].norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    worst, at = 0.0, None
    for k in keep:
        g = abs(float(prog[k].float().norm()) - norms[k]) / max(norms[k], med)
        if g > worst:
            worst, at = g, k
    return worst, at


def kept_leaves(first_grad: dict):
    """Leaves whose reference gradient is not nought to rounding: its norm
    at least a thousandth of the median leaf's."""
    norms = {k: float(g.norm()) for k, g in first_grad.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= 1e-3 * med]
