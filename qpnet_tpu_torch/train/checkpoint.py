"""Checkpoint loading for the port (pickle backend only).

The JAX package writes `checkpoint-final.pkl` as `{"model": numpy tree}` and
`checkpoint-<iter>.pkl` as `{"model", "optimizer", "iterations"}`, where the
optimizer state holds optax's NamedTuple classes.  The port reads both with
no JAX or optax installed: classes from those packages unpickle as inert
placeholders, so `model` and `iterations` come out intact and the optimizer
state is opaque.  Orbax checkpoints stay with the JAX package.
"""

from __future__ import annotations

import os
import pickle

_FOREIGN = ("jax", "jaxlib", "optax")


class InertObject:
    """Stand-in for a class of a package the port does not import."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN:
            return type(name, (InertObject,), {"__module__": module})
        return super().find_class(module, name)


def load_checkpoint(path: str) -> dict:
    """Load a pickle checkpoint written by either package."""
    if os.path.isdir(path) or path.endswith(".orbax"):
        raise NotImplementedError(
            "orbax checkpoints are read by the JAX package only "
            "(ROADMAP.md, Queue 1 item 3)")
    with open(path, "rb") as f:
        return _PortUnpickler(f).load()
