"""PyTorch port vs the JAX package: tensor parallelism (tp) in training.

The shard layout (`param_sharding_tree`: the gate's columns paired per
rank, W_skip and W_res by rows, the embeddings by channels), the tp step
over spawned gloo ranks on the CPU against one process and against JAX's
single-device trajectory (the gates of tests/test_train.py), checkpoints
that a tp run writes in the JAX layout and the train CLI's --tp (the
dryrun's tp leg: tests/test_torch_port_parallel.py).  Spawned ranks start
with one intra-op thread each."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.data.stats import calc_stats
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.train import checkpoint as JC
from qpnet_tpu.train.step import TrainState as JaxTrainState
from qpnet_tpu.train.step import make_optimizer as jax_make_optimizer
from qpnet_tpu.train.step import make_train_step as jax_make_train_step
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models import qpnet as TQ
from qpnet_tpu_torch.parallel import Mesh, dryrun
from qpnet_tpu_torch.parallel import distributed as PD
from qpnet_tpu_torch.parallel import mesh as PM
from qpnet_tpu_torch.train import checkpoint as TC
from qpnet_tpu_torch.train import step as TS
from qpnet_tpu_torch.train import trainer as TT

from helpers import make_synthetic_corpus

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=1,
            dilationA_depth=2, dilationA_repeat=1, upsampling_factor=10)


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Spawned ranks start with one intra-op thread each: the tests share
    the host's cores with other test workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def carried(seed, **over):
    kw = dict(TINY, **over)
    cfg_j, cfg = JaxConfig(**kw), ModelConfig(**kw)
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    return pj, jax.tree_util.tree_map(np.asarray, pj), cfg_j, cfg


def synth_batch(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    F = T // cfg.upsampling_factor
    return {
        "x": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
        "h": rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32),
        "t": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
        "d": np.repeat(rng.uniform(1.0, 3.0, (B, F)), cfg.upsampling_factor,
                       1).astype(np.float32),
        "valid_len": np.int32(T // 2)}


# --- the layout --------------------------------------------------------------

def test_mesh_has_a_tp_axis():
    m = Mesh(["cpu"] * 8, rank=5, tp=4)
    assert m.shape == {"dp": 2, "tp": 4} and m.axis_names == ("dp", "tp")
    w = PD.World(1, 2, 1, 4, [torch.device("cpu")] * 8, "gloo", tp=4)
    assert (w.rank, w.dp, w.dp_rank, w.tp_rank) == (5, 2, 1, 1)
    assert Mesh(["cpu"] * 2).axis_names == ("dp",)
    with pytest.raises(ValueError, match="must divide"):
        Mesh(["cpu"] * 6, tp=4)
    with pytest.raises(ValueError, match="must divide"):
        PM.make_mesh(1, "cpu", tp=2)
    assert PM.make_mesh(1, "cpu", tp=1).tp == 1
    for kw in ({"sp": 2}, {"pp": 2}):
        with pytest.raises(ValueError, match="must divide"):
            PM.make_mesh(1, "cpu", **kw)
    assert PM.make_mesh(1, "cpu", tp=1, sp=1, pp=1).axis_names == ("dp",)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_shards_pair_the_gate_columns_and_rejoin(tp):
    """A rank's gate shard holds 2R/tp columns: s and t of its R/tp
    channels; W_skip and W_res their rows; every leaf rejoins exactly
    (the JAX layout)."""
    _, pnp, _, cfg = carried(0)
    params = TQ.params_from_numpy(pnp, "cpu")
    R = cfg.n_resch
    spec = TS.param_sharding_tree(Mesh(["cpu"] * tp, tp=tp), params)
    assert spec["fixed"][0]["W_cur"] == 1 and spec["fixed"][0]["W_res"] == 0
    assert spec["W_post1"] is None and spec["fixed"][0]["b_skip"] is None
    shards = [TS.map_sharded(
        lambda t, axis, paired: TS.shard_leaf(t, axis, paired, k, tp),
        params, spec) for k in range(tp)]
    w = R // tp
    for k, sh in enumerate(shards):
        W = sh["adaptive"][1]["W_cur"]
        assert W.shape == (R, 2 * R // tp)
        full = params["adaptive"][1]["W_cur"]
        assert torch.equal(W[:, :w], full[:, k * w:(k + 1) * w])
        assert torch.equal(W[:, w:], full[:, R + k * w:R + (k + 1) * w])
        assert sh["fixed"][0]["W_skip"].shape == (w, cfg.n_skipch)
        assert sh["embed_cur"].shape == (cfg.n_quantize, w)
    parts = list(zip(*[TS.tree_leaves(s) for s in shards]))
    pairs = TS.tree_leaves(TS.map_sharded(lambda t, a, p: [p], spec, spec))
    for orig, leaf_parts, axis, paired in zip(
            TS.tree_leaves(params), parts, TS.tree_leaves(spec), pairs):
        assert torch.equal(TS.unshard_leaf(leaf_parts, axis, paired), orig)


def test_tp_must_divide_the_channels():
    """(tests/test_train.py:338-356) tp=8 with R=16 passes; R=12 raises."""
    _, pnp, _, _ = carried(0)
    TS.param_sharding_tree(Mesh(["cpu"] * 8, tp=8),
                           TQ.params_from_numpy(pnp, "cpu"))
    _, p12, _, _ = carried(0, n_resch=12, n_skipch=8)
    with pytest.raises(ValueError, match="must divide"):
        TS.param_sharding_tree(Mesh(["cpu"] * 8, tp=8),
                               TQ.params_from_numpy(p12, "cpu"))


def test_kernel_engine_under_tp_raises(monkeypatch):
    """K2 runs the whole residual width: 'pallas' under tp raises, and
    nothing falls back to the plain engine."""
    world = PD.World(0, 1, 0, 2, [torch.device("cpu")] * 2, "gloo", tp=2)
    monkeypatch.setattr(PD, "require_world", lambda mesh: world)
    cfg = ModelConfig(**TINY)
    with pytest.raises(ValueError, match="whole residual width"):
        TS.make_train_step(cfg, TS.make_optimizer(),
                           mesh=Mesh(["cpu"] * 2, rank=0, tp=2),
                           fixed_engine="pallas")
    TS.make_train_step(cfg, TS.make_optimizer(),
                       mesh=Mesh(["cpu"] * 2, rank=0, tp=2),
                       fixed_engine="auto")


# --- the tp step ---------------------------------------------------------------

def test_tp_step_matches_one_process_and_jax(one_thread_ranks):
    """(dp=2, tp=4) over 8 gloo ranks, 4 f32 steps, against one process
    on the same global batches: losses within rtol 2e-5, parameters within
    rtol 1e-4, atol 1e-6 (tests/test_train.py:293-335); the losses are
    JAX's single-device trajectory's within the port's train-step
    tolerance (1e-4); every rank's gate shard holds 2R/4 columns, and the
    first step's gradients, gathered, are one process's."""
    pj, pnp, cfg_j, cfg = carried(0)
    batches = [synth_batch(cfg, 2, 200, 30 + i) for i in range(4)]
    ranks = dryrun.run_dp_steps(8, cfg, batches, tp=4, params_np=pnp,
                                lr=5e-3, report=True, timeout=240)
    one_rep = {}
    one_losses, one_params = dryrun.steps(cfg, batches, "cpu", params_np=pnp,
                                          lr=5e-3, report=one_rep)
    for losses, leaves, rep in ranks:
        np.testing.assert_allclose(losses, one_losses, rtol=2e-5)
        for a, b in zip(leaves, one_params):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        assert rep["W_cur"] == (cfg.n_resch, 2 * cfg.n_resch // 4)
        for a, b in zip(rep["grads"], one_rep["grads"]):
            assert np.linalg.norm(a - b) <= 1e-4 * max(np.linalg.norm(b),
                                                       1e-30)
    assert all(r[0] == ranks[0][0] for r in ranks)
    txj = jax_make_optimizer(lr=5e-3)
    step_j = jax_make_train_step(cfg_j, txj, remat=False)
    sj = JaxTrainState(pj, txj.init(pj), jnp.int32(0))
    for b, mine in zip(batches, ranks[0][0]):
        sj, lj = step_j(sj, {k: jnp.asarray(v) for k, v in b.items()})
        np.testing.assert_allclose(mine, float(lj), rtol=1e-4)


# --- checkpoints and the CLI ----------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_corpus")
    wavs, feats = make_synthetic_corpus(str(root), n_utts=3, fs=1000, up=10,
                                        n_aux=4)
    stats = str(root / "stats.h5")
    calc_stats(feats, stats)
    wav_scp, feat_scp = str(root / "wav.scp"), str(root / "feat.scp")
    for path, lines in ((wav_scp, wavs), (feat_scp, feats)):
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return {"wav": wav_scp, "feat": feat_scp, "stats": stats}


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
            "2", "--intervals", "1", "--device", "cpu", "--verbose", "0",
            *extra]


def leaves_of(path):
    return [np.asarray(a) for a in TS.tree_leaves(TC.load_checkpoint(path)
                                                  ["model"])]


def test_cli_tp_trains_and_saves_the_jax_layout(corpus, tmp_path,
                                                one_thread_ranks):
    """--tp 2 --n_devices 4 on the CPU is a (dp=2, tp=2) mesh: it logs one
    process's losses (within rtol 2e-5), and its checkpoints hold whole
    arrays in the JAX layout: JAX's load_checkpoint reads them, shaped as
    JAX's init_params, and the port's values are one process's."""
    from qpnet_tpu_torch.bin import qpnet_train as cli
    one, tp = str(tmp_path / "one"), str(tmp_path / "tp")
    cli.main(train_argv(corpus, one))
    cli.main(train_argv(corpus, tp, "--tp", "2", "--n_devices", "4"))
    np.testing.assert_allclose(
        TT.read_loss_record(os.path.join(tp, "loss-final.yml")),
        TT.read_loss_record(os.path.join(one, "loss-final.yml")), rtol=2e-5)
    ck = JC.load_checkpoint(os.path.join(tp, "checkpoint-4.pkl"))
    want = jax_init_params(jax.random.PRNGKey(0), JaxConfig(**TINY))
    assert jax.tree_util.tree_structure(ck["model"]) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(ck["model"]),
                    jax.tree_util.tree_leaves(want)):
        assert np.shape(a) == np.shape(b)
    assert ck["iterations"] == 4 and ck["optimizer"]["count"] == 4
    for name in ("checkpoint-2.pkl", "checkpoint-4.pkl",
                 "checkpoint-final.pkl"):
        for a, b in zip(leaves_of(os.path.join(tp, name)),
                        leaves_of(os.path.join(one, name))):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    mine, theirs = (TC.load_checkpoint(os.path.join(d, "checkpoint-4.pkl"))
                    ["optimizer"] for d in (tp, one))
    for k in ("mu", "nu"):
        for a, b in zip(TS.tree_leaves(mine[k]), TS.tree_leaves(theirs[k])):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-9)


def test_tp_run_resumes_a_tp1_checkpoint(corpus, tmp_path, one_thread_ranks):
    """A tp=1 checkpoint resumes under --tp 2 (the state sharded after the
    resume): iterations 3-4 log what one process resumed from it logs."""
    from qpnet_tpu_torch.bin import qpnet_train as cli
    first = str(tmp_path / "first")
    cli.main(train_argv(corpus, first, "--iters", "2"))
    ckpt = os.path.join(first, "checkpoint-2.pkl")
    one, tp = str(tmp_path / "one"), str(tmp_path / "tp")
    cli.main(train_argv(corpus, one, "--resume", ckpt))
    cli.main(train_argv(corpus, tp, "--tp", "2", "--resume", ckpt))
    got = TT.read_loss_record(os.path.join(tp, "loss-final.yml"))
    ref = TT.read_loss_record(os.path.join(one, "loss-final.yml"))
    assert len(got) == len(ref) == 2
    np.testing.assert_allclose(got, ref, rtol=2e-5)
    ck = TC.load_checkpoint(os.path.join(tp, "checkpoint-4.pkl"))
    assert ck["iterations"] == 4 and ck["optimizer"]["count"] == 4


@pytest.mark.parametrize("extra,err,match", [
    (["--tp", "3", "--n_devices", "4"], ValueError, "must divide the 4"),
    (["--tp", "2", "--n_devices", "2", "--batch_size", "3"], None, None),
    (["--sp", "4", "--n_devices", "4"], ValueError,
     "30 frames should be divisible by 4"),
    (["--pp", "3"], ValueError, "pp=3 must divide the 4-block stack"),
    (["--pp", "2", "--pp_microbatches", "3"], ValueError,
     "per-dp-shard batch 2//1 must split into 3 microbatches"),
], ids=["tp3-of-4", "tp-batch-indivisible-by-dp1", "sp", "pp",
        "microbatches"])
def test_cli_rejects_what_does_not_fit(corpus, tmp_path, extra, err, match):
    """tp must divide a host's ranks; sp must divide the window's frames
    (JAX's device_put words), pp the block count and the microbatches a dp
    shard's rows (JAX's pipeline words), all before model.conf is written.
    batch_size divides over dp, not over the ranks: 3 rows at (dp=1,
    tp=2) are accepted by the layout."""
    from qpnet_tpu_torch.bin import qpnet_train as cli
    args = cli.get_arguments(train_argv(corpus, str(tmp_path), *extra))
    if err is None:
        assert cli.dp_layout(args) == (None, 2)
        return
    with pytest.raises(err, match=match):
        cli.main(train_argv(corpus, str(tmp_path), *extra))
    assert not os.path.exists(str(tmp_path / "model.conf"))
