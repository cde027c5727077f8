"""The multi-rank dryrun: one full data-parallel training step over n
spawned gloo ranks on tiny shapes, beside one process's step on the same
global batch, then the same step on a (dp = n / 2, tp = 2) mesh.  The
port's counterpart of the dp and tp legs of the JAX package's
`__graft_entry__.py::dryrun_multichip` (a tiny model with the full layer
structure: the sharding pattern, a dp batch split, replicated or
channel-sharded parameters and the collectives, is the flagship's).

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
          lr: float = 1e-4, engine: str = "auto", report=None):
    """(losses, final parameter leaves as numpy) of training steps from the
    parameters of seed 0 (or `params_np`), one per batch: the whole batch,
    or under a mesh this rank's rows of it.  Under tp the parameters are
    the shards gathered into the JAX layout.  `report` (a dict) receives
    the first step's gradient leaves in that layout ("grads"), each step's
    wall in ms to its loss on the host ("step_ms"), the shape of this
    rank's W_cur ("W_cur") and the checkpoint payload of the final state
    ("checkpoint")."""
    from qpnet_tpu_torch.parallel.distributed import make_global_batch
    from qpnet_tpu_torch.train import step as TS
    tx = TS.make_optimizer(lr=lr)
    params = _params(cfg, device, params_np)
    state = TS.shard_train_state(mesh, TS.TrainState(params, tx.init(params),
                                                     0))
    step = TS.make_train_step(cfg, tx, mesh=mesh, remat=False,
                              fixed_engine=engine)
    losses, step_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        b = (TS.batch_to_device(b, device) if mesh is None
             else make_global_batch(mesh, b))
        state, loss = step(state, b)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if report is not None and "grads" not in report:
            grads = TS.tree_map(lambda p: p.grad, state.params)
            report["grads"] = [g.cpu().numpy() for g in TS.tree_leaves(
                TS.gather_params(mesh, grads))]
    if not np.all(np.isfinite(losses)) or state.iterations != len(batches):
        raise RuntimeError(f"dp steps: losses {losses}, iteration "
                           f"{state.iterations}")
    whole = TS.gather_params(mesh, state.params)
    if report is not None:
        report["step_ms"] = step_ms
        report["W_cur"] = tuple(state.params["fixed"][0]["W_cur"].shape)
        report["checkpoint"] = {
            "model": TS.tree_map(lambda t: t.detach().cpu().numpy(), whole),
            "optimizer": TS.full_optimizer_state(mesh, state.opt_state,
                                                 state.params)}
    return losses, [p.detach().cpu().numpy() for p in TS.tree_leaves(whole)]


def _rank(local_rank: int, n: int, store: str, devices, job) -> None:
    from qpnet_tpu_torch.parallel import distributed as PD
    dev = devices[local_rank]
    PD.init_world("file://" + os.path.join(store, "rendezvous"), 0, 1,
                  local_rank, n, dev, tp=job["tp"])
    try:
        report = {} if job["report"] else None
        out = steps(ModelConfig(**job["cfg"]), job["batches"], dev,
                    PD.rank_mesh(), report=report, **job["kw"])
        if report is not None:
            out = out + (report,)
        with open(os.path.join(store, f"rank{local_rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        PD.shutdown()


def run_dp_steps(n: int, cfg: ModelConfig, batches, device: str = "cpu",
                 timeout: float = 300.0, tp: int = 1, devices=None,
                 report: bool = False, **kw):
    """`steps` over n spawned ranks of one host on a (dp = n / tp, tp)
    mesh (one card each with device="cuda", or the given `devices`, which
    may repeat a card), each on its dp index's rows of every global batch;
    returns each rank's (losses, final parameter leaves), with `report`
    also its report dict (see `steps`).  A failed or late rank ends the
    others and raises."""
    import torch.multiprocessing as tmp
    if devices is None:
        if device == "cuda":
            from qpnet_tpu_torch.parallel.mesh import make_mesh
            make_mesh(n, "cuda", tp=tp)
        devices = [f"cuda:{r}" if device == "cuda" else "cpu"
                   for r in range(n)]
    store = tempfile.mkdtemp(prefix="qpnet_dp_")
    job = {"cfg": dataclasses.asdict(cfg), "batches": list(batches),
           "kw": kw, "tp": tp, "report": report}
    try:
        ctx = tmp.start_processes(_rank, args=(n, store, list(devices), job),
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
    """One dp step over n gloo ranks on the tiny net, and with n >= 2 the
    same step on a (dp = n / 2, tp = 2) mesh; returns {"dp_losses": each
    rank's loss, "single_loss": one process's step on the whole batch,
    "tp_losses": each tp rank's loss, "tp_W_cur": each tp rank's shape of
    its first gate shard}."""
    cfg = ModelConfig(**CFG)
    batch = dryrun_batch(n, cfg)
    ranks = run_dp_steps(n, cfg, [batch], device)
    out = {"dp_losses": [losses[0] for losses, _ in ranks],
           "single_loss": steps(cfg, [batch], device)[0][0]}
    if n >= 2:
        if n % 2:
            raise ValueError(f"the tp leg runs tp=2: n={n} must be even")
        tp_ranks = run_dp_steps(n, cfg, [batch], device, tp=2, report=True)
        out["tp_losses"] = [losses[0] for losses, _, _ in tp_ranks]
        out["tp_W_cur"] = [rep["W_cur"] for _, _, rep in tp_ranks]
    return out


def check_dryrun(out: dict, cfg: ModelConfig) -> None:
    """The dryrun's gates: the dp losses within 1e-6 of one process's, and
    the tp leg's within 1e-4 of the dp loss (`__graft_entry__.py`), each
    rank's gate shard holding 2R/tp paired columns."""
    single = out["single_loss"]
    if max(abs(x - single) for x in out["dp_losses"]) > 1e-6 * abs(single):
        raise SystemExit("dryrun: the dp loss differs from one process's")
    if "tp_losses" in out:
        if max(abs(x - out["dp_losses"][0]) for x in out["tp_losses"]) \
                >= 1e-4:
            raise SystemExit(f"dryrun: the tp step diverged: "
                             f"{out['tp_losses']} vs {out['dp_losses'][0]}")
        want = (cfg.n_resch, 2 * cfg.n_resch // 2)
        if any(shape != want for shape in out["tp_W_cur"]):
            raise SystemExit(f"dryrun: gate weights not tensor-sharded: "
                             f"{out['tp_W_cur']}, expected {want}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("n", nargs="?", default=2, type=int)
    parser.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = parser.parse_args(argv)
    out = dryrun_multichip(args.n, args.device)
    print(out)
    check_dryrun(out, ModelConfig(**CFG))


if __name__ == "__main__":
    main()
