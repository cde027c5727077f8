"""PyTorch port vs the JAX package: pipeline parallelism (pp) in training.

The gates of tests/test_pipeline.py on the port's GPipe schedule
(`train/pipeline.py`) over spawned gloo ranks: logits bit-equal to the
port's own `forward` in f32 and bf16 (torch's CPU products at these shapes
do not depend on the row count, so the microbatches change no bit) and
within f32 rounding of JAX's `pipeline_forward`; the (dp=2, pp=2) step's
gradients and 3 steps' losses against one process; the four shape errors
in JAX's words; and the train CLI's --pp/--pp_microbatches beside one
process and JAX's CLI, its checkpoints read by JAX's `load_checkpoint`.
Spawned ranks start with one intra-op thread each."""

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
from qpnet_tpu.train import checkpoint as JC
from qpnet_tpu.train.pipeline import pipeline_forward as jax_pipeline_forward
from qpnet_tpu.train.step import TrainState as JaxTrainState
from qpnet_tpu.train.step import make_optimizer as jax_make_optimizer
from qpnet_tpu.train.step import make_train_step as jax_make_train_step
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models import qpnet as TQ
from qpnet_tpu_torch.parallel import Mesh, dryrun
from qpnet_tpu_torch.parallel import distributed as PD
from qpnet_tpu_torch.train import pipeline as PL
from qpnet_tpu_torch.train import step as TS
from qpnet_tpu_torch.train import trainer as TT

from helpers import make_synthetic_corpus

# tests/test_pipeline.py::CFG: the full 12 + 4 block structure
CFG = dict(n_quantize=64, n_aux=8, n_resch=32, n_skipch=16,
           dilationF_depth=4, dilationF_repeat=3,
           dilationA_depth=4, dilationA_repeat=1,
           kernel_size=2, upsampling_factor=10)


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Spawned ranks start with one intra-op thread each: the tests share
    the host's cores with other test workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def inputs(seed=0, B=8, F=12):
    """tests/test_pipeline.py::_inputs, with targets."""
    rng = np.random.default_rng(seed)
    T = F * CFG["upsampling_factor"]
    return {"x": rng.integers(0, CFG["n_quantize"], (B, T)).astype(np.int32),
            "h": rng.normal(size=(B, F, CFG["n_aux"])).astype(np.float32),
            "d": rng.uniform(1.0, 3.0, (B, T)).astype(np.float32),
            "t": rng.integers(0, CFG["n_quantize"], (B, T)).astype(np.int32),
            "valid_len": np.int32(T // 2)}


def carried(seed=0):
    pj = jax_init_params(jax.random.PRNGKey(seed), JaxConfig(**CFG))
    return pj, jax.tree_util.tree_map(np.asarray, pj)


# --- the pipelined forward (tests/test_pipeline.py:39-66) --------------------

@pytest.mark.parametrize("pp,M", [(2, 2), (4, 4)], ids=["pp2-M2", "pp4-M4"])
def test_pipeline_logits_bitwise(one_thread_ranks, pp, M):
    """pp gloo ranks as GPipe stages over M microbatches of B=8 windows:
    the last stage's logits equal `forward`'s bit for bit in f32 and bf16
    (every other stage returns None; `dryrun.pp_logits`; the bf16 logits
    compared as f32), and lie within f32 rounding (rtol
    1e-5, atol 1e-5, the port's forward-vs-JAX gate) of JAX's
    pipeline_forward on make_mesh(pp, pp=pp)."""
    pj, pnp = carried(0)
    batch = inputs()
    out = dryrun.run_ranks(pp, dryrun.pp_logits, {
        "cfg": CFG, "params": pnp, "batch": batch, "M": M,
        "dtypes": ("float32", "bfloat16")}, ["cpu"] * pp, timeout=180, pp=pp)
    assert all(o == {} for o in out[:-1])
    for name in ("float32", "bfloat16"):
        got, ref = out[-1][name]
        assert np.array_equal(got, ref), (
            f"pp={pp} {name} logits diverged: max|diff|="
            f"{np.abs(got - ref).max():.3e}")
    mesh = jax_make_mesh(pp, pp=pp)
    x, h, d = (jnp.asarray(batch[k]) for k in ("x", "h", "d"))
    theirs = jax.jit(lambda p, x, h, d: jax_pipeline_forward(
        p, JaxConfig(**CFG), x, h, d, mesh, M))(pj, x, h, d)
    np.testing.assert_allclose(out[-1]["float32"][0], np.asarray(theirs),
                               rtol=1e-5, atol=1e-5)


# --- the pp step (tests/test_pipeline.py:69-126) -----------------------------

def test_pipeline_step_gradients_and_losses(one_thread_ranks):
    """(dp=2, pp=2) over 4 gloo ranks, 2 microbatches of each dp shard's
    4 rows, remat on, lr 1e-4: step 1's gradients per leaf within rtol
    1e-4, atol 2e-6 of one process's, 3 steps' losses within rtol 1e-5,
    atol 1e-6 of one process's (and within the port's train-step gate,
    rtol 1e-4, of JAX's single-device step), equal on every rank."""
    pj, pnp = carried(0)
    cfg = ModelConfig(**CFG)
    batch = inputs()
    ranks = dryrun.run_dp_steps(4, cfg, [batch] * 3, params_np=pnp,
                                lr=1e-4, report=True, timeout=240, pp=2,
                                n_microbatches=2, remat=True)
    one_rep = {}
    one_losses, _ = dryrun.steps(cfg, [batch] * 3, "cpu", params_np=pnp,
                                 lr=1e-4, report=one_rep, remat=True)
    for losses, _, rep in ranks:
        assert losses == ranks[0][0]
        np.testing.assert_allclose(losses, one_losses, rtol=1e-5, atol=1e-6)
        for a, b in zip(rep["grads"], one_rep["grads"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-6)
    tx = jax_make_optimizer(lr=1e-4)
    step = jax_make_train_step(JaxConfig(**CFG), tx, remat=True)
    state = JaxTrainState(pj, tx.init(pj), jnp.int32(0))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    for mine in ranks[0][0]:
        state, loss = step(state, b)
        np.testing.assert_allclose(mine, float(loss), rtol=1e-4)


# --- the shape errors (tests/test_pipeline.py:129-139) -----------------------

def test_pipeline_rejects_bad_shapes_in_jax_words():
    """pp must divide the 16 blocks, M the dp shard's rows; a mesh
    without pp, or with tp or sp beside it, raises: the port's errors hold
    JAX's words, raised before any rank is needed."""
    pj, pnp = carried(0)
    cfg, cfg_j = ModelConfig(**CFG), JaxConfig(**CFG)
    params = TQ.params_from_numpy(pnp, "cpu")
    b = inputs()
    x, h, d = (torch.from_numpy(b[k]) for k in ("x", "h", "d"))
    xj, hj, dj = (jnp.asarray(b[k]) for k in ("x", "h", "d"))
    for match, mesh, jmesh, M, rows in (
            ("must divide the 16-block", Mesh(["cpu"] * 3, pp=3),
             jax_make_mesh(3, pp=3), None, 8),
            ("microbatches", Mesh(["cpu"] * 8, pp=2),
             jax_make_mesh(8, pp=2), 16, 2),
            ("pp axis", Mesh(["cpu"] * 8), jax_make_mesh(8), None, 1),
            ("dp only", Mesh(["cpu"] * 8, pp=2, tp=2),
             jax_make_mesh(8, pp=2, tp=2), None, 4)):
        with pytest.raises(ValueError, match=match):
            PL.pipeline_forward(params, cfg, x[:rows], h[:rows], d[:rows],
                                mesh, M)
        with pytest.raises(ValueError, match=match):
            jax_pipeline_forward(pj, cfg_j, xj, hj, dj, jmesh, M)
    assert PL.bubble_share(2, 2) == 1 / 3 and PL.bubble_share(4, 4) == 3 / 7


def test_kernel_engine_and_microbatches_without_pp(monkeypatch):
    """'pallas' under pp raises ValueError (K2 runs the whole stack);
    n_microbatches without a pp axis is ignored, as in JAX."""
    cfg = ModelConfig(**CFG)
    world = PD.World(0, 1, 0, 2, [torch.device("cpu")] * 2, "gloo", pp=2)
    monkeypatch.setattr(PD, "require_world", lambda mesh: world)
    with pytest.raises(ValueError, match="a stage of the stack"):
        TS.make_train_step(cfg, TS.make_optimizer(),
                           mesh=Mesh(["cpu"] * 2, rank=0, pp=2),
                           fixed_engine="pallas")
    monkeypatch.undo()
    pj, pnp = carried(0)
    batch = inputs(B=2)
    a = dryrun.steps(cfg, [batch], "cpu", params_np=pnp)
    b = dryrun.steps(cfg, [batch], "cpu", params_np=pnp, n_microbatches=2)
    assert a[0] == b[0]


# --- the CLI -----------------------------------------------------------------

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=1,
            dilationA_depth=2, dilationA_repeat=1, upsampling_factor=10)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp_corpus")
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


def test_cli_pp_trains_beside_jax(corpus, tmp_path, one_thread_ranks):
    """--pp 2 --pp_microbatches 2 on the CPU: 2 ranks as 2 GPipe stages
    over the 2-window batch.  Its losses are one process's within rtol
    1e-5, atol 1e-6, and JAX's CLI's with the same argv within rtol 1e-4
    (the port's train-step gate); JAX's load_checkpoint reads its
    checkpoints, equal to one process's within rtol 1e-4, atol 1e-6."""
    from qpnet_tpu.bin import qpnet_train as jax_cli
    from qpnet_tpu_torch.bin import qpnet_train as cli
    pp = ("--pp", "2", "--pp_microbatches", "2")
    one, mine, jx = (str(tmp_path / n) for n in ("one", "pp", "jax"))
    cli.main(train_argv(corpus, one, "--device", "cpu"))
    cli.main(train_argv(corpus, mine, "--device", "cpu", *pp))
    jax_cli.main(train_argv(corpus, jx, *pp))
    got = TT.read_loss_record(os.path.join(mine, "loss-final.yml"))
    np.testing.assert_allclose(
        got, TT.read_loss_record(os.path.join(one, "loss-final.yml")),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, TT.read_loss_record(os.path.join(jx, "loss-final.yml")),
        rtol=1e-4)
    for name in ("checkpoint-4.pkl", "checkpoint-final.pkl"):
        ck = JC.load_checkpoint(os.path.join(mine, name))
        ref = JC.load_checkpoint(os.path.join(one, name))
        for a, b in zip(jax.tree_util.tree_leaves(ck["model"]),
                        jax.tree_util.tree_leaves(ref["model"])):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert JC.load_checkpoint(os.path.join(mine, "checkpoint-4.pkl"))[
        "optimizer"]["count"] == 4
