"""Checkpoints of the port, in the JAX package's file contract: the pickle
backend writes `checkpoint-<iter>.pkl` holding {"model", "optimizer",
"iterations"} and `checkpoint-final.pkl` {"model"}, with `model` the
parameter tree in the JAX layout (dicts and lists of numpy arrays), so the
JAX package loads the port's files and the other way round.

The port's pickles hold `optimizer` as {"count": int, "mu": tree, "nu":
tree}: Adam's step count and first and second moments, numpy arrays in the
parameters' layout.  The JAX package's own iteration pickles hold optax's
state objects instead; the port reads them with no JAX or optax installed
(classes of those packages unpickle as inert placeholders) and
`adam_state_from_optax` takes the Adam moments out of them.

The orbax backend (`backend="orbax"`, or QPNET_CKPT_BACKEND=orbax) writes
`checkpoint-<iter>.orbax/` and `checkpoint-final.orbax/` directories in
orbax's format, without orbax (`train/orbax_format.py`): the optimizer as
the list orbax makes of optax's chain, [{"count", "mu", "nu"}, None] (with
a leading None under weight decay), so the JAX trainer restores it into its
optax state.  `load_checkpoint` reads either backend's files from either
package, orbax's OCDBT layout included, and a `.pkl` path whose file is
missing falls back to its `.orbax` twin.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from qpnet_tpu_torch.train import orbax_format

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
    """Load a checkpoint of either backend written by either package;
    `path` may also name the .pkl while only the .orbax twin exists."""
    if os.path.isdir(path) or path.endswith(".orbax"):
        return orbax_format.read_checkpoint(path)
    twin = path[:-len(".pkl")] + ".orbax"
    if (path.endswith(".pkl") and not os.path.exists(path)
            and os.path.isdir(twin)):
        return load_checkpoint(twin)
    with open(path, "rb") as f:
        return _PortUnpickler(f).load()


def checkpoint_backend(backend: str = None) -> str:
    """The effective backend name ("pickle" or "orbax")."""
    return backend or os.environ.get("QPNET_CKPT_BACKEND", "pickle")


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
                    iterations: int, backend: str = None,
                    weight_decay: float = 0.0) -> str:
    """Write checkpoint-<iterations>.pkl, or .orbax under the orbax
    backend.  params: the parameter tree (tensors or arrays); opt_state:
    {"count", "mu", "nu"}; weight_decay: the optimizer's, which decides
    the layout of optax's chain in an orbax checkpoint."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    model = _to_numpy(params)
    mu, nu = _to_numpy(opt_state["mu"]), _to_numpy(opt_state["nu"])
    if checkpoint_backend(backend) == "orbax":
        adam = {"count": np.asarray(int(opt_state["count"]), np.int32),
                "mu": mu, "nu": nu}
        chain = ([None] if weight_decay else []) + [adam, None]
        return orbax_format.write_checkpoint(
            os.path.join(checkpoint_dir, f"checkpoint-{iterations}.orbax"),
            {"model": model, "optimizer": chain,
             "iterations": int(iterations)})
    payload = {"model": model,
               "optimizer": {"count": int(opt_state["count"]), "mu": mu,
                             "nu": nu},
               "iterations": int(iterations)}
    return _dump(os.path.join(checkpoint_dir,
                              f"checkpoint-{iterations}.pkl"), payload)


def save_final(checkpoint_dir: str, params, backend: str = None) -> str:
    """Write the weights-only checkpoint-final.pkl, or .orbax under the
    orbax backend."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    if checkpoint_backend(backend) == "orbax":
        return orbax_format.write_checkpoint(
            os.path.join(checkpoint_dir, "checkpoint-final.orbax"),
            {"model": _to_numpy(params)})
    return _dump(os.path.join(checkpoint_dir, "checkpoint-final.pkl"),
                 {"model": _to_numpy(params)})


def adam_state_from_optax(state) -> dict:
    """{"count", "mu", "nu"} from an optimizer state as either package
    stores it: the port's dict; optax's ScaleByAdamState (live, or as the
    inert placeholder a pickle gives, whose `args` are (count, mu, nu));
    or an optax chain's tuple of states, where the decay and scale steps
    hold empty states around it, also as orbax stores the chain: a list,
    or a dict keyed "0", "1", ..., with None for the empty states."""
    if isinstance(state, dict) and state and all(
            isinstance(k, str) and k.isdigit() for k in state):
        state = [state[k] for k in sorted(state, key=int)]
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
