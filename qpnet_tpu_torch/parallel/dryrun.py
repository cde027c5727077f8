"""The multi-rank dryrun: one full data-parallel training step over n
spawned gloo ranks on tiny shapes, beside one process's step on the same
global batch, then the same step on (dp = n / 2, tp = 2), (dp = n / 2,
sp = 2) and (dp = n / 2, pp = 2, 2 microbatches) meshes.  The port's
counterpart of the dp, tp, sp and pp legs of the JAX package's
`__graft_entry__.py::dryrun_multichip` (a tiny model with the full layer
structure: the sharding pattern, a dp batch split, replicated,
channel-sharded, time-sharded or staged parameters and the collectives,
is the flagship's).

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
          lr: float = 1e-4, engine: str = "auto", report=None,
          n_microbatches=None, remat: bool = False):
    """(losses, final parameter leaves as numpy) of training steps from the
    parameters of seed 0 (or `params_np`), one per batch: the whole batch,
    or under a mesh this rank's rows of it.  Under tp the parameters are
    the shards gathered into the JAX layout.  `report` (a dict) receives
    the first step's gradient leaves in that layout ("grads"), each step's
    wall in ms to its loss on the host ("step_ms"), the shape of this
    rank's W_cur ("W_cur"), the shape of its x ("x"), under sp each
    block's halo length as the group agrees it for the last batch
    ("halos") and the checkpoint payload of the final state
    ("checkpoint")."""
    from qpnet_tpu_torch.parallel.distributed import make_global_batch
    from qpnet_tpu_torch.train import step as TS
    tx = TS.make_optimizer(lr=lr)
    params = _params(cfg, device, params_np)
    state = TS.shard_train_state(mesh, TS.TrainState(params, tx.init(params),
                                                     0))
    step = TS.make_train_step(cfg, tx, mesh=mesh, remat=remat,
                              fixed_engine=engine,
                              n_microbatches=n_microbatches)
    losses, step_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        b = (TS.batch_to_device(b, device) if mesh is None
             else make_global_batch(mesh, b))
        state, loss = step(state, b)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if report is not None and "grads" not in report:
            report["x"] = tuple(b["x"].shape)
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
        if mesh is not None and mesh.sp > 1:
            from qpnet_tpu_torch.models.qpnet import sp_tables
            report["halos"] = sp_tables(cfg, b["d"])[1]
        report["checkpoint"] = {
            "model": TS.tree_map(lambda t: t.detach().cpu().numpy(), whole),
            "optimizer": TS.full_optimizer_state(mesh, state.opt_state,
                                                 state.params)}
    return losses, [p.detach().cpu().numpy() for p in TS.tree_leaves(whole)]


def _rank(local_rank: int, store: str, devices) -> None:
    from qpnet_tpu_torch.parallel import distributed as PD
    with open(os.path.join(store, "legs.pkl"), "rb") as f:
        legs = pickle.load(f)
    out = []
    for i, (n, axes, fn, job) in enumerate(legs):
        if local_rank >= n:
            out.append(None)
            continue
        PD.init_world("file://" + os.path.join(store, f"rendezvous{i}"), 0,
                      1, local_rank, n, devices[local_rank], **axes)
        try:
            out.append(fn(job))
        finally:
            PD.shutdown()
    with open(os.path.join(store, f"rank{local_rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_legs(n: int, legs, devices, timeout: float = 300.0) -> list:
    """Each leg (ranks, axes, fn, job) in turn on n spawned ranks of one
    host, rank r on devices[r] (a device may repeat): the leg's first
    `ranks` ranks form a world on the (dp, tp, sp) or (dp, pp) mesh of
    `axes` (a dict of tp, sp, pp) and run fn(job), the others go on to the
    next leg.  One spawn for several meshes: a rank pays its start-up
    (torch, the optimizer's first import, the first products) once.
    Returns, per leg, its ranks' results in rank order.  fn must be
    importable by name (a spawned rank imports its module) and its result
    picklable.  A failed or late rank ends the others and raises."""
    import torch.multiprocessing as tmp
    store = tempfile.mkdtemp(prefix="qpnet_dp_")
    try:
        # the legs go through a file: spawn blocks on each rank until it
        # has read its arguments, and a rank reads them only after it has
        # imported torch, so large arguments would start the ranks in turn
        with open(os.path.join(store, "legs.pkl"), "wb") as f:
            pickle.dump(list(legs), f)
        ctx = tmp.start_processes(_rank, args=(store, list(devices)),
                                  nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            # join returns as each rank ends, and raises if one failed
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{n} ranks did not finish in "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(n):
            with open(os.path.join(store, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return [[out[r][i] for r in range(leg[0])]
                for i, leg in enumerate(legs)]
    finally:
        shutil.rmtree(store, ignore_errors=True)


def run_ranks(n: int, fn, job, devices, timeout: float = 300.0,
              tp: int = 1, sp: int = 1, pp: int = 1) -> list:
    """fn(job) on each of n spawned ranks of one host that form a world on
    a (dp, tp, sp) or (dp, pp) mesh (`run_legs` with one leg); returns
    each rank's result in rank order."""
    return run_legs(n, [(n, dict(tp=tp, sp=sp, pp=pp), fn, job)], devices,
                    timeout)[0]


def steps_job(job):
    """`steps` on this rank of the world, from a `steps_args` dict."""
    from qpnet_tpu_torch.parallel import distributed as PD
    report = {} if job["report"] else None
    out = steps(ModelConfig(**job["cfg"]), job["batches"], PD._world.device,
                PD.rank_mesh(), report=report, **job["kw"])
    return out if report is None else out + (report,)


def run_dp_steps(n: int, cfg: ModelConfig, batches, device: str = "cpu",
                 timeout: float = 300.0, tp: int = 1, sp: int = 1,
                 pp: int = 1, devices=None, report: bool = False, **kw):
    """`steps` over n spawned ranks of one host on a (dp, tp, sp) or (dp,
    pp) mesh, dp = n / (tp sp pp) (one card each with device="cuda", or
    the given `devices`, which may repeat a card), each on its part of
    every global batch (`make_global_batch`); `kw` goes to `steps`
    (n_microbatches among them); returns each rank's (losses, final
    parameter leaves), with `report` also its report dict (see `steps`).
    A failed or late rank ends the others and raises."""
    if devices is None:
        if device == "cuda":
            from qpnet_tpu_torch.parallel.mesh import make_mesh
            make_mesh(n, "cuda", tp=tp, sp=sp, pp=pp)
        devices = [f"cuda:{r}" if device == "cuda" else "cpu"
                   for r in range(n)]
    return run_ranks(n, steps_job, steps_args(cfg, batches, report, **kw),
                     devices, timeout, tp, sp, pp)


def steps_args(cfg: ModelConfig, batches, report: bool = False,
               **kw) -> dict:
    """The job of `steps_job`: `steps` of cfg on the batches, `kw` to it,
    returning the report dict too with `report`."""
    return {"cfg": dataclasses.asdict(cfg), "batches": list(batches),
            "kw": kw, "report": report}


def halo_check(job) -> dict:
    """On each rank of an sp group: the gather-form look-back of a
    float64 (2, T, 3) sequence through `sp_halo`, and the gradient of o,
    against the unsharded `shift_time` or `gather_past` and autograd, from
    seed 0.  job = (T, "fixed", dil) or (T, "adaptive", maxr): look-backs
    drawn in [0, maxr], the last rank's first row reaching maxr.  Returns
    the agreed halo length, the halo's shape and the largest differences
    of the values and of the gradient."""
    import torch

    from qpnet_tpu_torch.models import qpnet as Q
    from qpnet_tpu_torch.parallel import distributed as PD
    T, kind, amount = job
    torch.manual_seed(0)
    w = PD._world
    B, C = 2, 3
    T_l = T // w.sp
    t0 = w.sp_rank * T_l
    o_full = torch.randn(B, T, C, dtype=torch.float64, requires_grad=True)
    g_full = torch.randn(B, T, C, dtype=torch.float64)
    t = torch.arange(T)[None, :].expand(B, T)
    if kind == "fixed":
        idx, mask = (t - amount).clamp(min=0), t >= amount
        ref = Q.shift_time(o_full, amount)
    else:
        r = torch.from_numpy(np.random.default_rng(1).integers(
            0, amount + 1, (B, T)))
        r[:, (w.sp - 1) * T_l] = amount
        idx, mask = torch.clamp(t - r, 0, T - 1), None
        ref = Q.gather_past(o_full, r)
    (ref * g_full).sum().backward()
    idx = idx[:, t0:t0 + T_l]
    mask = None if mask is None else mask[:, t0:t0 + T_l]
    # the model's reaches (models/qpnet.py::sp_tables)
    need = min(amount, t0) if kind == "fixed" else t0 - int(idx.min())
    H = int(PD.sp_max([need])[0])
    o = o_full.detach()[:, t0:t0 + T_l].clone().requires_grad_()
    halo = PD.sp_halo(o, H)
    past = Q.gather_rows(torch.cat([halo, o], 1), idx - (t0 - H), mask)
    (past * g_full[:, t0:t0 + T_l]).sum().backward()
    return {"H": H, "halo": tuple(halo.shape),
            "value": float((past - ref[:, t0:t0 + T_l]).abs().max()),
            "grad": float((o.grad - o_full.grad[:, t0:t0 + T_l]).abs().max())}


def pp_logits(job) -> dict:
    """On each stage of a pp group: `pipeline_forward` of job["batch"]
    (x, h, d arrays) over job["M"] microbatches with job["params"] (a
    numpy tree) for each of job["dtypes"] ("float32", "bfloat16"); the
    last stage returns {dtype: (pipelined logits, `forward`'s logits on
    the same inputs)} as numpy, the others {}."""
    import torch

    from qpnet_tpu_torch.models import qpnet as Q
    from qpnet_tpu_torch.parallel import distributed as PD
    from qpnet_tpu_torch.train.pipeline import pipeline_forward
    cfg = ModelConfig(**job["cfg"])
    dev = PD._world.device
    params = Q.params_from_numpy(job["params"], dev)
    x, h, d = (torch.as_tensor(job["batch"][k]).to(dev)
               for k in ("x", "h", "d"))
    out = {}
    for name in job["dtypes"]:
        dtype = getattr(torch, name)
        got = pipeline_forward(params, cfg, x, h, d, PD.rank_mesh(),
                               job["M"], dtype)
        if got is not None:
            with torch.no_grad():
                ref = Q.forward(params, cfg, x, h, d, compute_dtype=dtype)
            out[name] = (got.float().cpu().numpy(), ref.float().cpu().numpy())
    return out


def dryrun_multichip(n: int, device: str = "cpu") -> dict:
    """One dp step over n gloo ranks on the tiny net, and with n >= 2 the
    same step on (dp = n / 2, tp = 2), (dp = n / 2, sp = 2) and (dp = n /
    2, pp = 2, 2 microbatches) meshes, remat on as in JAX's dryrun;
    returns {"dp_losses": each rank's loss, "single_loss": one process's
    step on the whole batch, "tp_losses", "sp_losses", "pp_losses": each
    rank's loss per leg, "tp_W_cur": each tp rank's shape of its first
    gate shard, "sp_x": each sp rank's shape of its x}."""
    cfg = ModelConfig(**CFG)
    batch = dryrun_batch(n, cfg)
    ranks = run_dp_steps(n, cfg, [batch], device)
    out = {"dp_losses": [losses[0] for losses, _ in ranks],
           "single_loss": steps(cfg, [batch], device)[0][0]}
    if n >= 2:
        if n % 2:
            raise ValueError(f"the tp, sp and pp legs run 2-rank groups: "
                             f"n={n} must be even")
        for axis, kw in (("tp", {}), ("sp", {}), ("pp", {"n_microbatches":
                                                         2})):
            legs = run_dp_steps(n, cfg, [batch], device, report=True,
                                remat=True, **{axis: 2}, **kw)
            out[f"{axis}_losses"] = [losses[0] for losses, _, _ in legs]
            out[f"{axis}_reports"] = [rep for _, _, rep in legs]
        out["tp_W_cur"] = [rep["W_cur"] for rep in out.pop("tp_reports")]
        out["sp_x"] = [rep["x"] for rep in out.pop("sp_reports")]
        out.pop("pp_reports")
    return out


def check_dryrun(out: dict, cfg: ModelConfig) -> None:
    """The dryrun's gates: the dp losses within 1e-6 of one process's, and
    the tp, sp and pp legs' within 1e-4 of the dp loss
    (`__graft_entry__.py`), each tp rank's gate shard holding 2R/tp paired
    columns and each sp rank's x T/2 samples."""
    single = out["single_loss"]
    if max(abs(x - single) for x in out["dp_losses"]) > 1e-6 * abs(single):
        raise SystemExit("dryrun: the dp loss differs from one process's")
    if "tp_losses" in out:
        for axis in ("tp", "sp", "pp"):
            got = out[f"{axis}_losses"]
            if max(abs(x - out["dp_losses"][0]) for x in got) >= 1e-4:
                raise SystemExit(f"dryrun: the {axis} step diverged: {got} "
                                 f"vs {out['dp_losses'][0]}")
        T = 12 * cfg.upsampling_factor
        if any(shape[1] != T // 2 for shape in out["sp_x"]):
            raise SystemExit(f"dryrun: time axis not sp-sharded: "
                             f"{out['sp_x']}, expected {T // 2} samples")
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
