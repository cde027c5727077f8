"""Checkpoints of the port (pickle backend only), in the JAX package's
file contract: `checkpoint-<iter>.pkl` holds {"model", "optimizer",
"iterations"} and `checkpoint-final.pkl` {"model"}, with `model` the
parameter tree in the JAX layout (dicts and lists of numpy arrays), so the
JAX package loads the port's files and the other way round.

The port writes `optimizer` as {"count": int, "mu": tree, "nu": tree}:
Adam's step count and first and second moments, numpy arrays in the
parameters' layout.  The JAX package's own iteration pickles hold optax's
state objects instead; the port reads them with no JAX or optax installed
(classes of those packages unpickle as inert placeholders) and
`adam_state_from_optax` takes the Adam moments out of them.  Orbax
checkpoints stay with the JAX package.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

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
        raise NotImplementedError(ORBAX)
    with open(path, "rb") as f:
        return _PortUnpickler(f).load()


ORBAX = ("orbax checkpoints are read and written by the JAX package only; "
         "the port reads and writes the pickle format")


def checkpoint_backend(backend: str = None) -> str:
    """The effective backend name: "pickle", the only one the port has."""
    name = backend or os.environ.get("QPNET_CKPT_BACKEND", "pickle")
    if name != "pickle":
        raise NotImplementedError(ORBAX)
    return name


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _dump(path: str, payload: dict) -> str:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)
    return path


def save_checkpoint(checkpoint_dir: str, params, opt_state: dict,
                    iterations: int, backend: str = None) -> str:
    """Write checkpoint-<iterations>.pkl.  params: the parameter tree
    (tensors or arrays); opt_state: {"count", "mu", "nu"}."""
    checkpoint_backend(backend)
    os.makedirs(checkpoint_dir, exist_ok=True)
    payload = {"model": _to_numpy(params),
               "optimizer": {"count": int(opt_state["count"]),
                             "mu": _to_numpy(opt_state["mu"]),
                             "nu": _to_numpy(opt_state["nu"])},
               "iterations": int(iterations)}
    return _dump(os.path.join(checkpoint_dir,
                              f"checkpoint-{iterations}.pkl"), payload)


def save_final(checkpoint_dir: str, params, backend: str = None) -> str:
    """Write the weights-only checkpoint-final.pkl."""
    checkpoint_backend(backend)
    os.makedirs(checkpoint_dir, exist_ok=True)
    return _dump(os.path.join(checkpoint_dir, "checkpoint-final.pkl"),
                 {"model": _to_numpy(params)})


def adam_state_from_optax(state) -> dict:
    """{"count", "mu", "nu"} from an optimizer state as either package
    stores it: the port's dict; optax's ScaleByAdamState (live, or as the
    inert placeholder a pickle gives, whose `args` are (count, mu, nu));
    or an optax chain's tuple of states, where the decay and scale steps
    hold empty states around it."""
    if isinstance(state, dict) and {"count", "mu", "nu"} <= set(state):
        return {"count": int(np.asarray(state["count"])), "mu": state["mu"],
                "nu": state["nu"]}
    if all(hasattr(state, k) for k in ("count", "mu", "nu")):
        return {"count": int(np.asarray(state.count)), "mu": state.mu,
                "nu": state.nu}
    if isinstance(state, InertObject) and len(state.args) == 3:
        count, mu, nu = state.args
        return {"count": int(np.asarray(count)), "mu": mu, "nu": nu}
    if isinstance(state, (tuple, list)) and not isinstance(state, InertObject):
        found = []
        for part in state:
            try:
                found.append(adam_state_from_optax(part))
            except ValueError:
                pass
        if len(found) == 1:
            return found[0]
    raise ValueError(f"no Adam state found in {type(state).__name__}")
