"""Products of the reference at the precisions of the controls.

Each returns an `mm(a, w, kind)` for `model.forward`: the operands rounded
to the lower type (activations per row, weights per output column, each
scaled by its largest magnitude, as a quantized deployment scales them),
then multiplied and summed in float32; the backward passes the gradient
straight through the rounding.  TF32 is emulated by rounding the operands'
mantissas to 10 bits, so it reads the same on any device.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0   # largest finite float8 e4m3fn


def _scaled(x: torch.Tensor, dim: int, top: float, cast) -> torch.Tensor:
    s = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / top
    return _through(x, cast(x.detach() / s) * s)


def _through(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """q in the forward, x's gradient in the backward (straight through)."""
    return x + (q - x).detach()


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _scaled(x, dim, FP8_MAX,
                   lambda v: v.to(torch.float8_e4m3fn).to(torch.float32))


def int4(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _scaled(x, dim, 7.0, lambda v: torch.round(v).clamp(-7, 7))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its mantissa rounded to TF32's 10 bits, to nearest even."""
    b = x.detach().float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return _through(x, b.view(torch.float32))


def make_mm(name: str):
    """"fp8": every product in float8 e4m3 (the control of bf16);
    "int4": the main products in int4 and the rest in float8 (the control
    of w8a8, whose int8 products are the main ones); "tf32": every product
    in TF32 (the control of float32)."""
    if name == "fp8":
        return lambda a, w, kind=None: fp8(a, -1) @ fp8(w, 0)
    if name == "int4":
        def mm(a, w, kind=None):
            if kind == "main":
                return int4(a, -1) @ int4(w, 0)
            return fp8(a, -1) @ fp8(w, 0)
        return mm
    if name == "tf32":
        return lambda a, w, kind=None: tf32(a) @ tf32(w)
    raise ValueError(f"unknown control precision {name!r}")
