"""Faults planted under a run's timed path, each a context manager that
patches the program while it is open.  The check has to find every one of
them: `python -m qpbench.control --fault <name>` reads them on the card,
and the CPU tests at a tiny size.

  state_unchanged  decode and serve: each generation call hands back the
                   ring and sample state it was given, so the next chunk
                   or feed starts from stale state; train: each step puts
                   the parameters back as they were.
  drop_half        decode: the call returns the first half of its rows;
                   serve: a group serves the first half of its streams and
                   ends the rest with no audio; train: the loss is the mean
                   over the later half of the valid positions.
  alter_tokens     decode and serve: every 64th generated sample is moved
                   half the classes round where the kernel produces it.
"""

from __future__ import annotations

import contextlib

KINDS = {"decode": ("state_unchanged", "drop_half", "alter_tokens"),
         "serve": ("state_unchanged", "drop_half", "alter_tokens"),
         "train": ("state_unchanged", "drop_half")}


@contextlib.contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _generate(old, fault, Q):
    def generate(packed, cfg, bufF0, bufA0, x0, *a, **kw):
        out, bufF, bufA, x = old(packed, cfg, bufF0, bufA0, x0, *a, **kw)
        if fault == "state_unchanged":
            return out, bufF0.clone(), bufA0.clone(), x0.clone()
        if kw.get("mode") != "forced":
            out = out.clone()
            out[::64] = (out[::64] + Q // 2) % Q
        return out, bufF, bufA, x
    return generate


def plant(kind: str, fault: str, cfg: dict, chunk_frames: int = None):
    """The context manager of `fault` for a cell of runner `kind`.
    chunk_frames: the decode call's chunk (frames), shortened in small
    tests so that a call carries its state across chunks."""
    from qpnet_tpu_torch.models import generate as G
    from qpnet_tpu_torch.ops import gen_kernel
    if fault not in KINDS[kind]:
        raise ValueError(f"{kind} cells have no fault {fault!r}")
    stack = contextlib.ExitStack()
    if chunk_frames:
        stack.enter_context(_patched(G, "DECODE_CHUNK_FRAMES",
                                     lambda _: chunk_frames))
    if kind in ("decode", "serve") and fault != "drop_half":
        stack.enter_context(_patched(
            gen_kernel, "generate",
            lambda old: _generate(old, fault, cfg["n_quantize"])))
    elif kind == "decode":
        stack.enter_context(_patched(
            G, "batch_fast_generate",
            lambda old: lambda *a, **kw: old(*a, **kw)[
                : (len(a[4]) + 1) // 2]))
    elif kind == "serve":
        from qpnet_tpu_torch.serve import StreamingService

        def half(old):
            def run_group(self, group, *a):
                keep = (len(group) + 1) // 2
                for req in group[keep:]:
                    req.handle._q.put(None)
                return old(self, group[:keep], *a)
            return run_group
        stack.enter_context(_patched(StreamingService, "_run_group", half))
    elif fault == "drop_half":
        from qpnet_tpu_torch.train import step as S

        def half_loss(old):
            def loss(logits, targets, valid_len, *a, **kw):
                return old(logits, targets, int(valid_len) // 2, *a, **kw)
            return loss
        stack.enter_context(_patched(S, "masked_ce_loss", half_loss))
    else:
        from qpnet_tpu_torch.train import trainer

        def frozen(make):
            def make_step(*a, **kw):
                step = make(*a, **kw)

                def run(state, batch, *b):
                    import torch
                    from qpbench.reference.train import leaves
                    keep = [(p, p.detach().clone())
                            for _, p in leaves(state.params)]
                    state, loss = step(state, batch, *b)
                    with torch.no_grad():
                        for p, v in keep:
                            p.copy_(v)
                    return state, loss
                return run
            return make_step
        stack.enter_context(_patched(trainer, "make_train_step", frozen))
    return stack
