"""The plain QPNet reference: the teacher-forced forward of Wu et al.,
"Quasi-Periodic WaveNet" (IEEE/ACM TASLP 2021; bigpon/QPNet
`src/nets/qpnet.py`), in float32 PyTorch operations.

Channels last: x (B, T) mu-law classes, h_up (B, T, A) aux at sample rate,
d (B, T) dilation factors.  The causal input layer is a k=2 convolution
over one-hot classes (two embedding tables); each residual block is a
gated k=2 dilated convolution ([s | t] halves, sigmoid(s) * tanh(t)) whose
look-back is t - dil in the fixed blocks and t - round(d(t) dil), half to
even, in the pitch-adaptive ones, with the aux added through its own 1x1
convolution; skip and residual are 1x1 convolutions; the post-net is
relu, 1x1, relu, 1x1.  Sequences are end-aligned with zero fill before
the first sample (the gather clips its index at 0).

Every product of a weight goes through `mm(a, w, kind)` (kind "main" for
the gate's W_cur/W_prev and the W_skip/W_res outputs, "rest" for the aux
and the post-net), so the control can run the same forward at a lower
precision (`precision.py`).  Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def f32_mm(a, w, kind=None):
    return a @ w


def dilations(cfg):
    return ([2 ** i for i in range(cfg["dilationF_depth"])]
            * cfg["dilationF_repeat"],
            [2 ** i for i in range(cfg["dilationA_depth"])]
            * cfg["dilationA_repeat"])


def shift(x: torch.Tensor, n: int) -> torch.Tensor:
    """x[:, t - n], zero for t < n."""
    return F.pad(x, (0, 0, n, 0))[:, : x.shape[1]]


def look_back(o: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """o[:, max(t - r, 0)] per row."""
    B, T, C = o.shape
    t = torch.arange(T, device=o.device)[None, :]
    idx = (t - r).clamp(min=0).long()
    return torch.gather(o, 1, idx[..., None].expand(B, T, C))


def upsample(params, h: torch.Tensor, up: int) -> torch.Tensor:
    """(B, F, A) frames -> (B, F up, A): each frame repeated, scaled by a
    learned weight per phase, plus a learned bias."""
    B, F_, _ = h.shape
    phase = params["up_w"].repeat(F_)
    return h.repeat_interleave(up, 1) * phase[None, :, None] + params["up_b"]


def block(p, o, past, h_up, mm):
    R = p["W_res"].shape[0]
    z = (mm(o, p["W_cur"], "main") + mm(past, p["W_prev"], "main")
         + mm(h_up, p["W_aux"], "rest") + p["b_gate"])
    g = torch.sigmoid(z[..., :R]) * torch.tanh(z[..., R:])
    return (o + mm(g, p["W_res"], "main") + p["b_res"],
            mm(g, p["W_skip"], "main") + p["b_skip"])


def forward(params, cfg, x, h_up, d, mm=f32_mm) -> torch.Tensor:
    """(B, T, Q) logits; logits[:, t] is the distribution of x[:, t + 1]."""
    x = x.long()
    o = (params["embed_cur"][x] + shift(params["embed_prev"][x], 1)
         + params["b_causal"])
    fixed, adaptive = dilations(cfg)
    skip = 0.0
    for p, dil in zip(params["fixed"], fixed):
        o, s = block(p, o, shift(o, dil), h_up, mm)
        skip = skip + s
    for p, dil in zip(params["adaptive"], adaptive):
        r = torch.round(d * dil)
        o, s = block(p, o, look_back(o, r), h_up, mm)
        skip = skip + s
    u = F.relu(skip)
    u = F.relu(mm(u, params["W_post1"], "rest") + params["b_post1"])
    return mm(u, params["W_post2"], "rest") + params["b_post2"]


def receptive(cfg, dmax: float) -> int:
    """Samples a generated sample's logits can reach back."""
    fixed, adaptive = dilations(cfg)
    return 1 + sum(fixed) + int(torch.tensor(dmax).ceil()) * sum(adaptive)


def generation_logits(params, cfg, h, d_frames, tokens, mm=f32_mm,
                      mid=None) -> torch.Tensor:
    """(n, Q) logits of the n generated samples `tokens` of one utterance,
    teacher-forced: the generator starts from a mid-scale seed sample after
    a mid-scale history whose aux is the first frame's (phase 0) and whose
    dilation factors are 1, and its step t reads frame t // up of h (F, A)
    and d_frames (F,).  logits[t] is what step t chose tokens[t] from."""
    up = cfg["upsampling_factor"]
    dev = h.device
    n = tokens.shape[0]
    mid = cfg["n_quantize"] // 2 if mid is None else mid
    H = 2 * receptive(cfg, float(d_frames.max())) + 16
    x = torch.cat([torch.full((H + 1,), mid, device=dev),
                   tokens[:-1].long().to(dev)])[None]
    h_gen = upsample(params, h[None], up)[:, :n]
    h_hist = (h[0] * params["up_w"][0] + params["up_b"]).expand(1, H, -1)
    d = torch.cat([torch.ones(H, device=dev),
                   d_frames.float().repeat_interleave(up)[:n]])[None]
    logits = forward(params, cfg, x, torch.cat([h_hist, h_gen], 1), d, mm)
    return logits[0, H:]
