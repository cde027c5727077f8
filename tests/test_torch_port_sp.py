"""PyTorch port vs the JAX package: sequence parallelism (sp) in training.

The time shards (`parallel/mesh.py::time_slice`, JAX's `batch_sharding`
"sp" entry, its divisibility error), the halo exchange alone over spawned
gloo ranks against the unsharded shift and gather and their autograd, the
sp step over 8 ranks against one process and JAX's sp step (the gate of
tests/test_train.py:359-394), and the train CLI's --sp against one process
and JAX's CLI.  Spawned ranks start with one intra-op thread each."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.data.stats import calc_stats
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.parallel import make_mesh as jax_make_mesh
from qpnet_tpu.parallel import shard_batch as jax_shard_batch
from qpnet_tpu.train import checkpoint as JC
from qpnet_tpu.train.step import TrainState as JaxTrainState
from qpnet_tpu.train.step import make_optimizer as jax_make_optimizer
from qpnet_tpu.train.step import make_train_step as jax_make_train_step
from qpnet_tpu.train.step import shard_train_state as jax_shard_train_state
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models import qpnet as TQ
from qpnet_tpu_torch.parallel import Mesh, dryrun
from qpnet_tpu_torch.parallel import distributed as PD
from qpnet_tpu_torch.parallel import mesh as PM
from qpnet_tpu_torch.train import step as TS
from qpnet_tpu_torch.train import trainer as TT

from helpers import make_synthetic_corpus

# tests/test_train.py::tiny_cfg
TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=1,
            dilationA_depth=2, dilationA_repeat=1, upsampling_factor=10)


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Spawned ranks start with one intra-op thread each: the tests share
    the host's cores with other test workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def synth_batch(cfg, B, T, seed=0, d=2.0):
    """tests/test_train.py::synth_batch (a repeating pattern, d = 2), or
    with d a (low, high) range: frame-constant d drawn from it."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, cfg.n_quantize, size=50)
    seq = np.tile(pat, T // 50 + 2)
    x = np.stack([seq[i: i + T] for i in range(B)]).astype(np.int32)
    t = np.stack([seq[i + 1: i + T + 1] for i in range(B)]).astype(np.int32)
    up = cfg.upsampling_factor
    h = rng.normal(size=(B, T // up, cfg.n_aux)).astype(np.float32)
    if np.ndim(d) == 0:
        dd = np.full((B, T), d, np.float32)
    else:
        dd = np.repeat(rng.uniform(*d, (B, T // up)), up, 1).astype(
            np.float32)
    return {"x": x, "h": h, "t": t, "d": dd, "valid_len": np.int32(T // 2)}


# --- the shards --------------------------------------------------------------

def test_time_slices_and_the_divisibility_error():
    """Rank k of an sp group holds samples [k T/sp, (k+1) T/sp) of x, t
    and d, frames [k F/sp, (k+1) F/sp) of h, and the sample of x before
    them; a frame count that sp does not divide raises ValueError, as
    JAX's shard_batch does on the same shape (273 frames, sp=2)."""
    cfg = ModelConfig(**TINY)
    b = synth_batch(cfg, 4, 200, d=(1.0, 3.0))
    shards = PM.shard_batch(Mesh(["cpu"] * 8, sp=4), b)
    for r, part in enumerate(shards):
        dp, k = r // 4, r % 4
        rows = slice(2 * dp, 2 * dp + 2)
        assert part["x"].shape == (2, 50) and part["h"].shape == (2, 5, 4)
        np.testing.assert_array_equal(part["x"].numpy(),
                                      b["x"][rows, 50 * k:50 * (k + 1)])
        np.testing.assert_array_equal(part["d"].numpy(),
                                      b["d"][rows, 50 * k:50 * (k + 1)])
        np.testing.assert_array_equal(part["h"].numpy(),
                                      b["h"][rows, 5 * k:5 * (k + 1)])
        want = b["x"][rows, 50 * k - 1:50 * k] if k else \
            np.zeros((2, 1), np.int32)
        np.testing.assert_array_equal(part["x_prev"].numpy(), want)
        assert part["valid_len"] == 100
    odd = {"h": np.zeros((4, 273, 4), np.float32)}
    with pytest.raises(ValueError, match="should be divisible by 2"):
        PM.time_slice(odd, 2, 0)
    with pytest.raises(ValueError, match="should be divisible by 2"):
        jax_shard_batch(jax_make_mesh(8, sp=2), odd)
    for make in (lambda: PM.make_mesh(1, "cpu", sp=2),
                 lambda: jax_make_mesh(1, sp=2)):
        with pytest.raises(ValueError, match="must divide"):
            make()
    assert Mesh(["cpu"] * 8, rank=5, tp=2, sp=2).coords(5) == {
        "dp": 1, "pp": 0, "sp": 0, "tp": 1}
    assert Mesh(["cpu"] * 8, tp=2, sp=2).axis_names == \
        jax_make_mesh(8, tp=2, sp=2).axis_names


# --- the halo, alone ---------------------------------------------------------

@pytest.mark.parametrize("kind,amount,H", [
    ("fixed", 3, 3), ("fixed", 16, 16), ("adaptive", 24, 24)],
    ids=["dil-below-a-shard", "dil-above-a-shard",
         "adaptive-spans-two-predecessors"])
def test_halo_matches_the_unsharded_lookback(one_thread_ranks, kind, amount,
                                             H):
    """sp_halo over 4 gloo ranks (10 rows each, float64,
    `dryrun.halo_check`): the look-back values and the gradients of o are
    the unsharded shift_time's or gather_past's and autograd's exactly;
    the agreed halo is dil rows for a fixed block (16 > 10 rows: two
    predecessors and zeros before t = 0) and the largest reach for an
    adaptive one (24 rows: the look-backs of rank 3 reach into rank 1)."""
    out = dryrun.run_ranks(4, dryrun.halo_check, (40, kind, amount),
                           ["cpu"] * 4, timeout=120, sp=4)
    assert [o["H"] for o in out] == [H] * 4
    assert all(o["halo"] == (2, H, 3) for o in out)
    for o in out:
        assert o["value"] == 0.0 and o["grad"] <= 1e-12, o


def test_forward_rejects_the_kernel_engine_under_sp(monkeypatch):
    """K2 runs the whole window: 'pallas' under sp raises ValueError, in
    the step and in the forward, and nothing falls back."""
    world = PD.World(0, 1, 0, 2, [torch.device("cpu")] * 2, "gloo", sp=2)
    monkeypatch.setattr(PD, "require_world", lambda mesh: world)
    cfg = ModelConfig(**TINY)
    with pytest.raises(ValueError, match="slice of the window"):
        TS.make_train_step(cfg, TS.make_optimizer(),
                           mesh=Mesh(["cpu"] * 2, rank=0, sp=2),
                           fixed_engine="pallas")
    with pytest.raises(ValueError, match="plain engine only"):
        TQ.forward({}, cfg, torch.zeros(1, 10), None, None,
                   fixed_engine="pallas", sp=True)


# --- the sp step (tests/test_train.py:359-394) -------------------------------

def carried(seed):
    cfg_j, cfg = JaxConfig(**TINY), ModelConfig(**TINY)
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    return pj, jax.tree_util.tree_map(np.asarray, pj), cfg_j, cfg


def jax_losses(cfg_j, pj, batch, steps, lr, mesh=None, tp=False):
    tx = jax_make_optimizer(lr=lr)
    step = jax_make_train_step(cfg_j, tx, mesh=mesh, remat=False)
    clone = jax.tree_util.tree_map(jnp.array, pj)
    state = JaxTrainState(clone, tx.init(clone), jnp.int32(0))
    if tp:
        state = jax_shard_train_state(mesh, state)
    if mesh is None:
        b = {k: jnp.asarray(v) for k, v in batch.items()}
    else:
        b = jax_shard_batch(mesh, {k: v for k, v in batch.items()
                                   if np.ndim(v) > 0})
        b["valid_len"] = jnp.asarray(batch["valid_len"])
    out = []
    for _ in range(steps):
        state, loss = step(state, b)
        out.append(float(loss))
    return out


@pytest.mark.parametrize("axes", [{"sp": 4}, {"tp": 2, "sp": 2}],
                         ids=["dp2-sp4", "dp2-tp2-sp2"])
def test_sp_step_matches_one_process_and_jax(one_thread_ranks, axes):
    """(dp=2, sp=4) and (dp=2, tp=2, sp=2) over 8 gloo ranks, 3 f32 steps
    on JAX's gate batch (B=2, T=200, lr 5e-3): losses within rtol 2e-5 of
    one process's and of JAX's sp step on make_mesh(8, **axes), the final
    parameters within rtol 1e-4, atol 1e-6 of one process's, each local x
    holding T/sp samples."""
    pj, pnp, cfg_j, cfg = carried(0)
    batch = synth_batch(cfg, 2, 200)
    ranks = dryrun.run_dp_steps(8, cfg, [batch] * 3, params_np=pnp, lr=5e-3,
                                report=True, timeout=240, **axes)
    one_losses, one_params = dryrun.steps(cfg, [batch] * 3, "cpu",
                                          params_np=pnp, lr=5e-3)
    mesh = jax_make_mesh(8, **axes)
    theirs = jax_losses(cfg_j, pj, batch, 3, 5e-3, mesh, "tp" in axes)
    np.testing.assert_allclose(theirs, one_losses, rtol=2e-5)
    for losses, leaves, rep in ranks:
        assert rep["x"] == (1, 200 // axes["sp"])
        np.testing.assert_allclose(losses, one_losses, rtol=2e-5)
        np.testing.assert_allclose(losses, theirs, rtol=2e-5)
        for a, b in zip(leaves, one_params):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_sp_step_with_reach_past_a_shard(one_thread_ranks):
    """The model's halos where an adaptive block reaches past its
    predecessor: d in [30, 40) on 50-sample shards (sp=4, T=200), so the
    second adaptive block (dilation 2) looks back up to 80 samples, into
    the shard before its predecessor; 2 f32 steps equal to one process's
    within rtol 2e-5 and JAX's single-device step within rtol 1e-4 (the
    port's train-step gate)."""
    pj, pnp, cfg_j, cfg = carried(1)
    batch = synth_batch(cfg, 1, 200, seed=3, d=(30.0, 40.0))
    ranks = dryrun.run_dp_steps(4, cfg, [batch] * 2, params_np=pnp, lr=5e-3,
                                timeout=240, sp=4)
    one_losses, _ = dryrun.steps(cfg, [batch] * 2, "cpu", params_np=pnp,
                                 lr=5e-3)
    theirs = jax_losses(cfg_j, pj, batch, 2, 5e-3)
    for losses, _ in ranks:
        np.testing.assert_allclose(losses, one_losses, rtol=2e-5)
        np.testing.assert_allclose(losses, theirs, rtol=1e-4)


# --- the CLI -----------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp_corpus")
    wavs, feats = make_synthetic_corpus(str(root), n_utts=3, fs=1000, up=10,
                                        n_aux=4)
    stats = str(root / "stats.h5")
    calc_stats(feats, stats)
    wav_scp, feat_scp = str(root / "wav.scp"), str(root / "feat.scp")
    for path, lines in ((wav_scp, wavs), (feat_scp, feats)):
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    # both packages start from JAX's initial weights (the draws differ)
    pretrain = JC.save_final(str(root / "si"), jax_init_params(
        jax.random.PRNGKey(11), JaxConfig(**TINY)))
    return {"wav": wav_scp, "feat": feat_scp, "stats": stats,
            "pretrain": pretrain}


def train_argv(corpus, expdir, *extra):
    return ["--waveforms", corpus["wav"], "--feats", corpus["feat"],
            "--stats", corpus["stats"], "--expdir", expdir,
            "--config", os.path.join(expdir, "model.conf"),
            "--n_quantize", "32", "--n_aux", "4", "--n_resch", "16",
            "--n_skipch", "8", "--dilationF_depth", "2",
            "--dilationF_repeat", "1", "--dilationA_depth", "2",
            "--dilationA_repeat", "1", "--upsampling_factor", "10",
            "--batch_length", "200", "--max_length", "300", "--lr", "2e-3",
            "--batch_size", "2", "--iters", "4", "--checkpoint_interval",
            "2", "--intervals", "1", "--pretrain", corpus["pretrain"],
            "--verbose", "0", *extra]


def test_cli_sp_trains_beside_jax(corpus, tmp_path, one_thread_ranks):
    """--sp 2 on the CPU is a (dp=1, sp=2) mesh of 2 ranks, each on 150 of
    the 300-sample window: its losses are one process's within rtol 2e-5
    and JAX's --sp 2 CLI's within rtol 1e-4 (the port's train-step gate),
    and JAX's load_checkpoint reads its checkpoints, equal to one
    process's within rtol 1e-4, atol 1e-6."""
    from qpnet_tpu.bin import qpnet_train as jax_cli
    from qpnet_tpu_torch.bin import qpnet_train as cli
    one, sp, jx = (str(tmp_path / n) for n in ("one", "sp", "jax"))
    cli.main(train_argv(corpus, one, "--device", "cpu"))
    cli.main(train_argv(corpus, sp, "--device", "cpu", "--sp", "2"))
    jax_cli.main(train_argv(corpus, jx, "--sp", "2"))
    got = TT.read_loss_record(os.path.join(sp, "loss-final.yml"))
    np.testing.assert_allclose(
        got, TT.read_loss_record(os.path.join(one, "loss-final.yml")),
        rtol=2e-5)
    np.testing.assert_allclose(
        got, TT.read_loss_record(os.path.join(jx, "loss-final.yml")),
        rtol=1e-4)
    ck = JC.load_checkpoint(os.path.join(sp, "checkpoint-4.pkl"))
    assert ck["iterations"] == 4 and ck["optimizer"]["count"] == 4
    ref = JC.load_checkpoint(os.path.join(one, "checkpoint-4.pkl"))
    for a, b in zip(jax.tree_util.tree_leaves(ck["model"]),
                    jax.tree_util.tree_leaves(ref["model"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
