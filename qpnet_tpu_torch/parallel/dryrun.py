"""The dp dryrun: one full data-parallel training step over n spawned gloo
ranks on tiny shapes, beside one process's step on the same global batch.
The port's counterpart of the dp leg of the JAX package's
`__graft_entry__.py::dryrun_multichip` (a tiny model with the full layer
structure: the sharding pattern, a dp batch split, replicated parameters
and one gradient all-reduce, is the flagship's).

    python -m qpnet_tpu_torch.parallel.dryrun [n] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import shutil
import tempfile
import time

import numpy as np

from qpnet_tpu_torch.config import ModelConfig

CFG = dict(n_quantize=64, n_aux=8, n_resch=32, n_skipch=16,
           dilationF_depth=4, dilationF_repeat=3,
           dilationA_depth=4, dilationA_repeat=1,
           kernel_size=2, upsampling_factor=10)


def dryrun_batch(n: int, cfg: ModelConfig) -> dict:
    """One window per rank: B = n, F = 12 frames, the JAX dryrun's batch."""
    B, F = n, 12
    T = F * cfg.upsampling_factor
    rng = np.random.default_rng(0)
    return {
        "x": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
        "h": rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32),
        "t": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
        "d": np.full((B, T), 2.0, np.float32),
        "valid_len": np.int32(T // 2),
    }


def _params(cfg: ModelConfig, device, params_np=None):
    from qpnet_tpu_torch.models.qpnet import init_params, params_from_numpy
    if params_np is None:
        return init_params(0, cfg, device=device)
    return params_from_numpy(params_np, device)


def steps(cfg: ModelConfig, batches, device, mesh=None, params_np=None,
          lr: float = 1e-4, engine: str = "auto"):
    """(losses, final parameter leaves as numpy) of training steps from the
    parameters of seed 0 (or `params_np`), one per batch: the whole batch,
    or under a mesh this rank's rows of it."""
    from qpnet_tpu_torch.parallel.distributed import make_global_batch
    from qpnet_tpu_torch.train.step import (TrainState, batch_to_device,
                                            make_optimizer, make_train_step,
                                            tree_leaves)
    tx = make_optimizer(lr=lr)
    params = _params(cfg, device, params_np)
    state = TrainState(params, tx.init(params), 0)
    step = make_train_step(cfg, tx, mesh=mesh, remat=False,
                           fixed_engine=engine)
    losses = []
    for b in batches:
        b = (batch_to_device(b, device) if mesh is None
             else make_global_batch(mesh, b))
        state, loss = step(state, b)
        losses.append(float(loss))
    if not np.all(np.isfinite(losses)) or state.iterations != len(batches):
        raise RuntimeError(f"dp steps: losses {losses}, iteration "
                           f"{state.iterations}")
    return losses, [p.detach().cpu().numpy()
                    for p in tree_leaves(state.params)]


def _rank(local_rank: int, n: int, store: str, device: str, job) -> None:
    from qpnet_tpu_torch.parallel import distributed as PD
    dev = f"cuda:{local_rank}" if device == "cuda" else "cpu"
    PD.init_world("file://" + os.path.join(store, "rendezvous"), 0, 1,
                  local_rank, n, dev)
    try:
        out = steps(ModelConfig(**job["cfg"]), job["batches"], dev,
                    PD.rank_mesh(), **job["kw"])
        with open(os.path.join(store, f"rank{local_rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        PD.shutdown()


def run_dp_steps(n: int, cfg: ModelConfig, batches, device: str = "cpu",
                 timeout: float = 300.0, **kw):
    """`steps` over n spawned ranks of one host (one card each with
    device="cuda"), each on its rows of every global batch; returns each
    rank's (losses, final parameter leaves).  A failed or late rank ends
    the others and raises."""
    import torch.multiprocessing as tmp
    if device == "cuda":
        from qpnet_tpu_torch.parallel.mesh import make_mesh
        make_mesh(n, "cuda")
    store = tempfile.mkdtemp(prefix="qpnet_dp_")
    job = {"cfg": dataclasses.asdict(cfg), "batches": list(batches),
           "kw": kw}
    try:
        ctx = tmp.start_processes(_rank, args=(n, store, device, job),
                                  nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            # join returns as each rank ends, and raises if one failed
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"dp steps: {n} ranks did not "
                                       f"finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(n):
            with open(os.path.join(store, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(store, ignore_errors=True)


def dryrun_multichip(n: int, device: str = "cpu") -> dict:
    """One dp step over n gloo ranks on the tiny net; returns
    {"dp_losses": each rank's loss, "single_loss": one process's step on
    the whole batch}."""
    cfg = ModelConfig(**CFG)
    batch = dryrun_batch(n, cfg)
    ranks = run_dp_steps(n, cfg, [batch], device)
    single = steps(cfg, [batch], device)[0][0]
    return {"dp_losses": [losses[0] for losses, _ in ranks],
            "single_loss": single}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("n", nargs="?", default=2, type=int)
    parser.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = parser.parse_args(argv)
    out = dryrun_multichip(args.n, args.device)
    print(out)
    if max(abs(x - out["single_loss"]) for x in out["dp_losses"]) \
            > 1e-6 * abs(out["single_loss"]):
        raise SystemExit("dp dryrun: the dp loss differs from one process's")


if __name__ == "__main__":
    main()
