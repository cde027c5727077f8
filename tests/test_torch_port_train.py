"""PyTorch port vs the JAX package: the training slice.

Adam against optax, the train step, the batcher (bit for bit), checkpoints
in both directions, the trainer's loop (loss record, preemption and
resume) and the training CLI against the JAX CLI, on tiny configs with the
same weights and data.  The kernel engine ("pallas") runs its plain twin
here on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.data.batcher import \
    train_window_generator as jax_train_window_generator
from qpnet_tpu.data.stats import calc_stats
from qpnet_tpu.data.stats import load_scaler as jax_load_scaler
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.train import checkpoint as JC
from qpnet_tpu.train.step import TrainState as JaxTrainState
from qpnet_tpu.train.step import make_optimizer as jax_make_optimizer
from qpnet_tpu.train.step import make_train_step as jax_make_train_step
from qpnet_tpu_torch.config import ModelConfig, TrainConfig
from qpnet_tpu_torch.data import batcher as TB
from qpnet_tpu_torch.data.stats import load_scaler
from qpnet_tpu_torch.models import qpnet as TQ
from qpnet_tpu_torch.train import checkpoint as TC
from qpnet_tpu_torch.train import step as TS
from qpnet_tpu_torch.train import trainer as TT

from helpers import make_synthetic_corpus

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=1,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=10)


def configs():
    return JaxConfig(**TINY), ModelConfig(**TINY)


def carried(seed):
    cfg_j, cfg = configs()
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    pt = TQ.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return pj, pt, cfg_j, cfg


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1e-30)


def leaves_np(tree):
    return [np.asarray(x) for x in TS.tree_leaves(tree)]


def make_batch(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    F = T // cfg.upsampling_factor
    return {
        "x": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
        "h": rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32),
        "t": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
        "d": np.repeat(rng.uniform(1.0, 3.0, (B, F)), cfg.upsampling_factor,
                       axis=1).astype(np.float32),
        "valid_len": np.int32(T // 2),
    }


# --- optimizer and step ----------------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_torch_adam_is_the_optax_chain(wd):
    """torch.optim.Adam(weight_decay=wd) updates as the JAX package's
    add_decayed_weights + scale_by_adam + scale(-lr) chain."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": [rng.normal(size=(4,)).astype(np.float32)]}
    tx = jax_make_optimizer(lr=1e-2, weight_decay=wd)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    sj = tx.init(pj)
    pt = TQ.params_from_numpy(p0, "cpu")
    opt = TS.make_optimizer(lr=1e-2, weight_decay=wd).init(pt)
    for _ in range(4):
        g = {"a": rng.normal(size=(5, 3)).astype(np.float32),
             "b": [rng.normal(size=(4,)).astype(np.float32)]}
        up, sj = tx.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        pj = jax.tree_util.tree_map(lambda p, u: p + u, pj, up)
        for p, gg in zip(TS.tree_leaves(pt), TS.tree_leaves(g)):
            p.grad = torch.from_numpy(gg)
        opt.step()
    for a, b in zip(leaves_np(jax.tree_util.tree_map(np.asarray, pj)),
                    leaves_np(TQ.tree_map(lambda t: t.detach().numpy(), pt))):
        # four updates of size ~lr = 1e-2 each, equal to 1e-4 of that size
        # (the two round the bias corrections differently)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    mine = TS.optimizer_state(opt, pt)
    theirs = TC.adam_state_from_optax(sj)
    assert mine["count"] == theirs["count"] == 4
    for k in ("mu", "nu"):
        for a, b in zip(leaves_np(theirs[k]), leaves_np(mine[k])):
            assert rel(a, b) < 1e-6, k


@pytest.mark.parametrize("engine,wd", [("xla", 0.0), ("xla", 1e-2),
                                       ("pallas", 0.0), ("pallas", 1e-2)])
def test_train_step_matches_jax(engine, wd):
    pj, pt, cfg_j, cfg = carried(3)
    txj = jax_make_optimizer(lr=2e-3, weight_decay=wd)
    step_j = jax_make_train_step(cfg_j, txj, fixed_engine="xla", remat=False)
    sj = JaxTrainState(pj, txj.init(pj), jnp.int32(0))
    tx = TS.make_optimizer(lr=2e-3, weight_decay=wd)
    st = TS.TrainState(pt, tx.init(pt), 0)
    step_t = TS.make_train_step(cfg, tx, fixed_engine=engine, remat=False)
    for i in range(3):
        b = make_batch(cfg, 1, 120, 10 + i)
        sj, lj = step_j(sj, {k: jnp.asarray(v) for k, v in b.items()})
        st, lt = step_t(st, TS.batch_to_device(b, "cpu"))
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
        if i == 0:
            mine = TS.optimizer_state(st.opt_state, st.params)
            theirs = TC.adam_state_from_optax(sj.opt_state)
            # Frobenius-relative: the two frameworks' gradients differ by
            # float sum order; the kernel engine's agree to 2e-5 (its gate)
            tol = 1e-6 if engine == "xla" else 2e-5
            for k in ("mu", "nu"):
                for a, c in zip(leaves_np(theirs[k]), leaves_np(mine[k])):
                    a, c = a.astype(np.float64), c.astype(np.float64)
                    err = np.linalg.norm(a - c) / max(np.linalg.norm(a),
                                                      1e-30)
                    assert err < tol, (k, err)
    assert st.iterations == 3


def test_step_rejects_multi_device_and_eval_step():
    """A dp mesh needs the dp world it spans (one process per rank:
    tests/test_torch_port_parallel.py); GPipe microbatches without a pp
    axis are ignored, as in JAX (tests/test_torch_port_pp.py)."""
    from qpnet_tpu_torch.parallel import Mesh
    _, pt, _, cfg = carried(4)
    with pytest.raises(ValueError, match="dp world"):
        TS.make_train_step(cfg, TS.make_optimizer(), mesh=Mesh(["cpu"] * 2))
    b = TS.batch_to_device(make_batch(cfg, 1, 120, 0), "cpu")
    losses = []
    for M in (None, 2):
        params = TQ.tree_map(lambda t: t.detach().clone(), pt)
        tx = TS.make_optimizer()
        step = TS.make_train_step(cfg, tx, n_microbatches=M)
        _, loss = step(TS.TrainState(params, tx.init(params), 0), b)
        losses.append(float(loss))
    assert losses[0] == losses[1]
    loss = TS.make_eval_step(cfg)(pt, b)
    ref = TS.masked_ce_loss(TQ.forward(pt, cfg, b["x"], b["h"], b["d"]),
                            b["t"], b["valid_len"])
    assert float(loss) == float(ref)
    assert TS.resolve_fixed_engine("auto", cfg, 1, 120, torch.float32) == "xla"


def test_remat_gives_the_same_gradients():
    _, pt, _, cfg = carried(5)
    b = TS.batch_to_device(make_batch(cfg, 1, 120, 5), "cpu")
    grads = []
    for remat in (False, True):
        p = TQ.tree_map(lambda t: t.clone().requires_grad_(), pt)
        TS._loss_fn(p, cfg, b, torch.float32, remat).backward()
        grads.append([x.grad for x in TS.tree_leaves(p)])
    for a, c in zip(*grads):
        assert (a is None and c is None) or torch.equal(a, c)


# --- batcher ---------------------------------------------------------------

def test_batcher_is_bit_equal_to_jax(tmp_path):
    _, cfg = configs()
    cfg_j, _ = configs()
    wavs, feats = make_synthetic_corpus(str(tmp_path), n_utts=3, fs=1000,
                                        up=10, n_aux=4)
    stats = str(tmp_path / "stats.h5")
    calc_stats(feats, stats)
    kw = dict(batch_length=200, batch_size=2, max_length=300,
              shuffle=True, seed=3, loop=True)
    gj = jax_train_window_generator(
        wavs, feats, cfg_j, feat_transform=jax_load_scaler(stats).transform,
        **kw)
    gt = TB.train_window_generator(
        wavs, feats, cfg, feat_transform=load_scaler(stats).transform, **kw)
    for _ in range(12):        # past one pass: the reshuffle is drawn too
        a, b = next(gj), next(gt)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_background_generator_reraises():
    def bad():
        yield 1
        raise KeyError("boom")

    g = TB.background(1)(bad)()
    assert g.next() == 1
    with pytest.raises(RuntimeError, match="worker failed"):
        g.next()
    assert TB.padded_shape(30000, 110) == 30030


# --- checkpoints -----------------------------------------------------------

def test_jax_reads_the_ports_checkpoints(tmp_path):
    _, pt, cfg_j, cfg = carried(6)
    opt = TS.make_optimizer().init(pt)
    st = TS.TrainState(pt, opt, 0)
    st, _ = TS.make_train_step(cfg, TS.make_optimizer())(
        st, TS.batch_to_device(make_batch(cfg, 1, 120, 6), "cpu"))
    path = TC.save_checkpoint(str(tmp_path), pt, TS.optimizer_state(opt, pt),
                              1)
    final = TC.save_final(str(tmp_path), pt)
    for p in (path, final):
        ck = JC.load_checkpoint(p)
        flat = jax.tree_util.tree_leaves(ck["model"])
        mine = TS.tree_leaves(pt)
        assert len(flat) == len(mine)
        for a, b in zip(flat, mine):
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, b.detach().numpy())
    ck = JC.load_checkpoint(path)
    assert ck["iterations"] == 1 and ck["optimizer"]["count"] == 1
    assert set(ck["optimizer"]) == {"count", "mu", "nu"}
    # the JAX package's structure: the JAX forward takes the loaded tree
    from qpnet_tpu.models import forward as jax_forward
    b = make_batch(cfg, 1, 120, 7)
    out = jax_forward(jax.tree_util.tree_map(jnp.asarray, ck["model"]),
                      cfg_j, jnp.asarray(b["x"]), jnp.asarray(b["h"]),
                      jnp.asarray(b["d"]))
    ref = TQ.forward(pt, cfg, torch.from_numpy(b["x"]),
                     torch.from_numpy(b["h"]), torch.from_numpy(b["d"]))
    np.testing.assert_allclose(np.asarray(out), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    # the orbax backend: JAX reads the port's directory bit for bit
    orb = TC.save_final(str(tmp_path), pt, backend="orbax")
    assert orb.endswith("checkpoint-final.orbax") and os.path.isdir(orb)
    flat = jax.tree_util.tree_leaves(JC.load_checkpoint(orb)["model"])
    for a, b in zip(flat, TS.tree_leaves(pt), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


def test_port_resumes_from_a_jax_checkpoint(tmp_path):
    """optax state (decay + Adam + scale chain) from a JAX pickle: the
    port's next step equals JAX's next step."""
    pj, _, cfg_j, cfg = carried(8)
    txj = jax_make_optimizer(lr=2e-3, weight_decay=1e-2)
    step_j = jax_make_train_step(cfg_j, txj, fixed_engine="xla", remat=False)
    sj = JaxTrainState(pj, txj.init(pj), jnp.int32(0))
    b1, b2 = make_batch(cfg, 1, 120, 1), make_batch(cfg, 1, 120, 2)
    sj, _ = step_j(sj, {k: jnp.asarray(v) for k, v in b1.items()})
    path = JC.save_checkpoint(str(tmp_path), sj.params, sj.opt_state, 1)
    ck = TC.load_checkpoint(path)
    adam = TC.adam_state_from_optax(ck["optimizer"])
    assert adam["count"] == 1
    pt = TQ.params_from_numpy(ck["model"], "cpu")
    tx = TS.make_optimizer(lr=2e-3, weight_decay=1e-2)
    opt = tx.init(pt)
    TS.load_optimizer_state(opt, pt, adam)
    st = TS.TrainState(pt, opt, ck["iterations"])
    st, lt = TS.make_train_step(cfg, tx, fixed_engine="xla", remat=False)(
        st, TS.batch_to_device(b2, "cpu"))
    sj, lj = step_j(sj, {k: jnp.asarray(v) for k, v in b2.items()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for a, c in zip(leaves_np(jax.tree_util.tree_map(np.asarray, sj.params)),
                    leaves_np(TQ.tree_map(lambda t: t.detach().numpy(),
                                          st.params))):
        np.testing.assert_allclose(c, a, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="no Adam state"):
        TC.adam_state_from_optax((TC.InertObject(),))


# --- trainer ---------------------------------------------------------------

@pytest.mark.parametrize("losses", [[], [1.5, 2.0e-20, 3.25], [float("nan"),
                                                               1e16, -0.0]])
def test_loss_record_is_yaml(tmp_path, losses):
    path = str(tmp_path / "loss-final.yml")
    TT.write_loss_record(path, losses)
    with open(path) as f:
        text = f.read()
    assert text == yaml.safe_dump([float(x) for x in losses])
    back = TT.read_loss_record(path)
    np.testing.assert_array_equal(np.asarray(back, np.float64),
                                  np.asarray(losses, np.float64))


def memory_batches(cfg, seed, max_length=300):
    """The batcher's windowing over an in-memory corpus (no h5 files)."""
    rng = np.random.default_rng(seed)
    utts = []
    for i in range(3):
        n = 100 * int(rng.integers(8, 12))
        f0 = np.repeat(rng.uniform(60, 120), n // 10)
        h = rng.normal(size=(n // 10, cfg.n_aux)).astype(np.float32)
        h[:, 1] = f0
        x = (0.3 * np.sin(np.arange(n) * 0.3) + 0.05 * rng.normal(size=n))
        utts.append((1000, x.astype(np.float32), h))
    stream = TB.utterance_stream(utts, lambda u: u, seed=seed)
    return TB.window_batches(stream, cfg, batch_length=200, batch_size=1,
                             max_length=max_length)


def test_preemption_saves_and_auto_resume_continues(tmp_path, monkeypatch):
    _, cfg = configs()
    tcfg = TrainConfig(lr=2e-3, iters=5, checkpoint_interval=10, intervals=1,
                       batch_length=200, max_length=300, seed=2,
                       fixed_engine="pallas")
    whole = str(tmp_path / "whole")
    TT.train_loop(cfg, tcfg, memory_batches(cfg, 0), whole, device="cpu")
    cut = str(tmp_path / "cut")
    monkeypatch.setenv("QPNET_PREEMPT_AFTER", "2")
    TT.train_loop(cfg, tcfg, memory_batches(cfg, 0), cut, device="cpu")
    assert os.path.exists(os.path.join(cut, "checkpoint-2.pkl"))
    assert not os.path.exists(os.path.join(cut, "checkpoint-final.pkl"))
    assert len(TT.read_loss_record(os.path.join(cut, "loss-final.yml"))) == 2
    monkeypatch.delenv("QPNET_PREEMPT_AFTER")
    batches = memory_batches(cfg, 0)
    for _ in range(2):          # the stream position the cut run reached
        next(batches)
    TT.train_loop(cfg, tcfg, batches, cut, resume="auto", device="cpu")
    a = TT.read_loss_record(os.path.join(whole, "loss-final.yml"))
    b = TT.read_loss_record(os.path.join(cut, "loss-final.yml"))
    assert len(a) == len(b) == 5
    np.testing.assert_allclose(b, a, rtol=1e-6)
    fa = TC.load_checkpoint(os.path.join(whole, "checkpoint-final.pkl"))
    fb = TC.load_checkpoint(os.path.join(cut, "checkpoint-final.pkl"))
    for x, y in zip(leaves_np(fa["model"]), leaves_np(fb["model"])):
        np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-7)
    with pytest.raises(FileNotFoundError):
        TT.train_loop(cfg, tcfg, batches, cut, resume=str(tmp_path / "no"),
                      device="cpu")


# --- the CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_corpus")
    wavs, feats = make_synthetic_corpus(str(root), n_utts=3, fs=1000, up=10,
                                        n_aux=4)
    stats = str(root / "stats.h5")
    calc_stats(feats, stats)
    wav_scp, feat_scp = str(root / "wav.scp"), str(root / "feat.scp")
    for path, lines in ((wav_scp, wavs), (feat_scp, feats)):
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    cfg_j, _ = configs()
    pretrain = JC.save_final(str(root / "si"),
                             jax_init_params(jax.random.PRNGKey(11), cfg_j))
    return {"root": root, "wav": wav_scp, "feat": feat_scp, "stats": stats,
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
            "--iters", "4", "--checkpoint_interval", "2", "--intervals", "1",
            "--pretrain", corpus["pretrain"], "--verbose", "0", *extra]


def test_cli_matches_the_jax_cli(corpus, tmp_path):
    from qpnet_tpu.bin import qpnet_train as jax_cli
    from qpnet_tpu_torch.bin import qpnet_train as cli
    jdir = str(tmp_path / "jax")
    jax_cli.main(train_argv(corpus, jdir, "--fixed_engine", "xla"))
    with open(os.path.join(jdir, "loss-final.yml")) as f:
        ref = yaml.safe_load(f)
    assert len(ref) == 4
    for engine in ("pallas", "xla"):
        tdir = str(tmp_path / engine)
        cli.main(train_argv(corpus, tdir, "--fixed_engine", engine,
                            "--device", "cpu"))
        with open(os.path.join(tdir, "loss-final.yml")) as f:
            got = yaml.safe_load(f)
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=engine)
        for name in ("checkpoint-2.pkl", "checkpoint-4.pkl",
                     "checkpoint-final.pkl"):
            assert os.path.exists(os.path.join(tdir, name)), name
    with open(os.path.join(jdir, "model.conf")) as f, \
            open(os.path.join(str(tmp_path / "xla"), "model.conf")) as g:
        assert f.read() == g.read()
    # the port resumes the JAX run from its iteration-2 checkpoint
    rdir = str(tmp_path / "resumed")
    cli.main(train_argv(corpus, rdir, "--fixed_engine", "pallas",
                        "--device", "cpu", "--resume",
                        os.path.join(jdir, "checkpoint-2.pkl")))
    got = TT.read_loss_record(os.path.join(rdir, "loss-final.yml"))
    assert len(got) == 2
    ck = TC.load_checkpoint(os.path.join(rdir, "checkpoint-4.pkl"))
    assert ck["iterations"] == 4 and ck["optimizer"]["count"] == 4


def test_cli_defaults_to_cuda(corpus, tmp_path):
    from qpnet_tpu_torch.bin import qpnet_train as cli
    args = cli.get_arguments(train_argv(corpus, str(tmp_path)))
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(train_argv(corpus, str(tmp_path / "e")))
    assert not os.path.exists(str(tmp_path / "e" / "model.conf"))


@pytest.mark.parametrize("extra", [
    ["--n_devices", "2"], ["--tp", "2"], ["--sp", "2"],
    ["--pp", "2", "--batch_size", "2"],
    ["--coordinator", "localhost:1234"], ["--n_hosts", "2"],
    ["--host_id", "0"]])
def test_cli_rejects_what_is_not_ported(corpus, tmp_path, extra, monkeypatch):
    """dp, tp, sp and pp are ported: --n_devices, and --tp (a host runs
    max(n_devices, tp*sp*pp) ranks), with --device cuda need that many
    cards (asked for one more than the host has: ValueError; CPU ranks:
    tests/test_torch_port_multihost.py and tests/test_torch_port_tp.py);
    --sp 2 and --pp 2 (2 GPipe microbatches of the 2-window batch) train
    on 2 CPU ranks (tests/test_torch_port_sp.py, test_torch_port_pp.py);
    and a lone --coordinator, --n_hosts or --host_id is a single-host run,
    as in the JAX CLI (initialize_multihost returns False)."""
    from qpnet_tpu_torch.bin import qpnet_train as cli
    for k in ("QPNET_COORDINATOR", "QPNET_NUM_HOSTS", "QPNET_HOST_ID"):
        monkeypatch.delenv(k, raising=False)
    argv = train_argv(corpus, str(tmp_path), "--device", "cpu", *extra)
    if extra[0] in ("--n_devices", "--tp"):
        more = max(2, torch.cuda.device_count() + 1)
        with pytest.raises(ValueError, match=f"{more} cuda devices requested"):
            cli.main(argv + [extra[0], str(more), "--device", "cuda"])
        assert not os.path.exists(str(tmp_path / "model.conf"))
    else:
        cli.main(argv)
        got = TT.read_loss_record(str(tmp_path / "loss-final.yml"))
        assert len(got) == 4 and np.all(np.isfinite(got))
        assert os.path.exists(str(tmp_path / "checkpoint-final.pkl"))


def test_orbax_backend_is_not_ported(corpus, tmp_path, monkeypatch):
    """QPNET_CKPT_BACKEND=orbax: the train and update CLIs write .orbax
    directories (and no pickle), which both packages read."""
    from qpnet_tpu_torch.bin import qpnet_train as cli
    from qpnet_tpu_torch.bin import qpnet_update as upd
    monkeypatch.setenv("QPNET_CKPT_BACKEND", "orbax")
    si = str(tmp_path / "si")
    cli.main(train_argv(corpus, si, "--device", "cpu"))
    names = sorted(n for n in os.listdir(si) if n.startswith("checkpoint"))
    assert names == ["checkpoint-2.orbax", "checkpoint-4.orbax",
                     "checkpoint-final.orbax"]
    ck = TC.load_checkpoint(os.path.join(si, "checkpoint-4.pkl"))
    jck = JC.load_checkpoint(os.path.join(si, "checkpoint-4.orbax"))
    assert ck["iterations"] == jck["iterations"] == 4
    assert TC.adam_state_from_optax(ck["optimizer"])["count"] == 4
    for a, b in zip(jax.tree_util.tree_leaves(jck),
                    jax.tree_util.tree_leaves(ck), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sd = str(tmp_path / "sd")
    upd.main(["--waveforms", corpus["wav"], "--feats", corpus["feat"],
              "--stats", corpus["stats"], "--expdir", sd,
              "--config", os.path.join(si, "model.conf"),
              "--pretrain", os.path.join(si, "checkpoint-final.orbax"),
              "--batch_length", "200", "--max_length", "300",
              "--iters", "2", "--checkpoint_interval", "2",
              "--intervals", "1", "--device", "cpu", "--verbose", "0"])
    assert sorted(n for n in os.listdir(sd) if n.startswith("checkpoint")) \
        == ["checkpoint-2.orbax", "checkpoint-final.orbax"]
    final = JC.load_checkpoint(os.path.join(sd, "checkpoint-final.pkl"))
    assert jax.tree_util.tree_structure(final["model"]) == \
        jax.tree_util.tree_structure(TC.load_checkpoint(
            os.path.join(sd, "checkpoint-final.orbax"))["model"])


def test_update_cli_fine_tunes_from_si(corpus, tmp_path):
    from qpnet_tpu_torch.bin import qpnet_train as cli
    from qpnet_tpu_torch.bin import qpnet_update as upd
    si = str(tmp_path / "si")
    cli.main(train_argv(corpus, si, "--device", "cpu", "--iters", "2"))
    sd = str(tmp_path / "sd")
    upd.main(["--waveforms", corpus["wav"], "--feats", corpus["feat"],
              "--stats", corpus["stats"], "--expdir", sd,
              "--config", os.path.join(si, "model.conf"),
              "--pretrain", os.path.join(si, "checkpoint-final.pkl"),
              "--batch_length", "200", "--max_length", "300",
              "--iters", "2", "--checkpoint_interval", "2",
              "--intervals", "1", "--fixed_engine", "pallas",
              "--device", "cpu", "--verbose", "0"])
    assert os.path.exists(os.path.join(sd, "checkpoint-final.pkl"))
    with open(os.path.join(sd, "model.conf")) as f:
        assert json.load(f)["model"]["n_resch"] == 16
    assert len(TT.read_loss_record(os.path.join(sd, "loss-final.yml"))) == 2
