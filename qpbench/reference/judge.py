"""What decides `correct` for the generating cells (decode and serve).

A served token is judged by the reference's logits at its position,
teacher-forced on the tokens served before it: its gap is how far its
logit lies below the reference's best.  A greedy generator that computes
what the model states picks the best token up to rounding, so its widest
gap over every position is small; one that drifts, skips a step, drops
rows or alters a token picks tokens the reference ranks far lower.  The
control reads the same positions: the gap of the token that the reference
at a lower precision puts first.

A sampled token cannot be judged one by one, so the sampled tokens are
judged together: teacher-forced the same way, a token drawn from the
model's distribution p has an expected -log p(token) of p's entropy at its
position.  The mean of -log p_ref(token) - H(p_ref) over the positions
(`sampled_excess`) is near 0 for a sampler that draws from what the model
states; one that draws uniformly, shifts or alters tokens reads above it,
and one that takes the best token reads below it.
"""

from __future__ import annotations

import torch

from qpbench.reference import model


def full_f32():
    """Products in full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def widest_gaps(params, cfg, items, control_mm=None):
    """(widest gap of the served tokens, widest gap of the control's first
    choices or None) over items [(h (F, A), d_frames (F,), tokens (n,))],
    each a tensor on the params' device.  One utterance at a time."""
    full_f32()
    served, control = 0.0, None
    for h, d_frames, tokens in items:
        ref = model.generation_logits(params, cfg, h, d_frames, tokens)
        best = ref.max(-1).values
        tok = tokens.long().to(ref.device)
        gap = best - ref.gather(-1, tok[:, None])[:, 0]
        served = max(served, float(gap.max()))
        if control_mm is not None:
            low = model.generation_logits(params, cfg, h, d_frames, tokens,
                                          control_mm)
            pick = low.argmax(-1)
            cg = float((best - ref.gather(-1, pick[:, None])[:, 0]).max())
            control = cg if control is None else max(control, cg)
        del ref
    return served, control


@torch.no_grad()
def sampled_excess(params, cfg, items):
    """|mean over every position of -log p_ref(token) - H(p_ref)|, in
    nats, over items [(h (F, A), d_frames (F,), tokens (n,))] as in
    widest_gaps."""
    full_f32()
    total, n = 0.0, 0
    for h, d_frames, tokens in items:
        ref = model.generation_logits(params, cfg, h, d_frames, tokens)
        logp = torch.log_softmax(ref.double(), -1)
        tok = tokens.long().to(ref.device)
        nll = -logp.gather(-1, tok[:, None])[:, 0]
        ent = -(logp.exp() * logp).sum(-1)
        total += float((nll - ent).sum())
        n += len(tok)
        del ref, logp
    return abs(total / n)


def pick_sample(rng, lengths, n: int):
    """Indices of up to n items drawn from rng, the longest always in."""
    order = list(rng.permutation(len(lengths)))
    longest = max(range(len(lengths)), key=lambda i: lengths[i])
    order.remove(longest)
    return [longest] + order[: max(0, n - 1)]
