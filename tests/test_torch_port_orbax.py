"""The port's orbax checkpoint backend against the JAX package's, both
ways, on tiny configs:

- the JAX package's orbax checkpoints (OCDBT, zstd) read by the port bit
  for bit against the JAX package's pickle of the same state, optax's chain
  with and without weight decay, the .pkl-to-.orbax fallback, and the port
  trainer resuming from a JAX .orbax as from its pickle;
- the port's .orbax directories (plain layout) read by the JAX package with
  and without the JAX trainer's template, and the JAX trainer resuming from
  them;
- both train CLIs and the port's update CLI under QPNET_CKPT_BACKEND=orbax;
- the committed fixture (`tests/data/orbax_fixture`, written by
  `tests/torch_port_orbax_fixture.py`): the JAX package reads its .orbax
  equal to its .pkl, the port too, with the C++ zstd decoder equal to the
  plain one on every frame in it;
- a process where jax, orbax, tensorstore, zstandard and qpnet_tpu cannot
  be imported saves and loads both backends through the port.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.config import TrainConfig as JaxTrainConfig
from qpnet_tpu.data.stats import calc_stats
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.train import checkpoint as JC
from qpnet_tpu.train.step import TrainState as JaxTrainState
from qpnet_tpu.train.step import make_optimizer as jax_make_optimizer
from qpnet_tpu.train.step import make_train_step as jax_make_train_step
from qpnet_tpu.train.trainer import run_training as jax_run_training
from qpnet_tpu_torch.config import ModelConfig, TrainConfig
from qpnet_tpu_torch.train import checkpoint as TC
from qpnet_tpu_torch.train import orbax_format as OF
from qpnet_tpu_torch.train import trainer as TT
from qpnet_tpu_torch.train import zstd as Z
from qpnet_tpu_torch.train import zstd_native as N

from helpers import make_synthetic_corpus
from torch_port_orbax_fixture import CONFIG as FIXTURE_CONFIG
from torch_port_orbax_fixture import FIXTURE
from torch_port_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=1,
            dilationA_depth=1, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=10)


def flat(tree, path=()):
    """{path: leaf} of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, path + (str(i),)))
        return out
    return {path: tree}


def assert_bit_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=str(k))


def jax_state(wd, seed=0):
    """Tiny params and an optax state after one step (nonzero moments)."""
    cfg = JaxConfig(**TINY)
    params = jax_init_params(jax.random.PRNGKey(seed), cfg)
    tx = jax_make_optimizer(lr=2e-3, weight_decay=wd)
    step = jax_make_train_step(cfg, tx, fixed_engine="xla", remat=False)
    rng = np.random.default_rng(seed)
    T = 120
    batch = {"x": rng.integers(0, 32, (1, T)).astype(np.int32),
             "h": rng.standard_normal((1, T // 10, 4)).astype(np.float32),
             "t": rng.integers(0, 32, (1, T)).astype(np.int32),
             "d": np.full((1, T), 2.0, np.float32),
             "valid_len": np.int32(T)}
    st, _ = step(JaxTrainState(params, tx.init(params), jnp.int32(0)),
                 {k: jnp.asarray(v) for k, v in batch.items()})
    return st.params, st.opt_state, tx


# --- JAX writes, the port reads ----------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_port_reads_jax_orbax(tmp_path, wd):
    params, opt, _ = jax_state(wd)
    orb = JC.save_checkpoint(str(tmp_path / "o"), params, opt, 3,
                             backend="orbax")
    pkl = JC.save_checkpoint(str(tmp_path / "p"), params, opt, 3,
                             backend="pickle")
    fin = JC.save_final(str(tmp_path / "o"), params, backend="orbax")
    got, ref = TC.load_checkpoint(orb), TC.load_checkpoint(pkl)
    assert got["iterations"] == ref["iterations"] == 3
    assert isinstance(got["iterations"], int)
    assert_bit_equal(got["model"], ref["model"])
    assert_bit_equal(TC.load_checkpoint(fin), {"model": ref["model"]})
    # optax's chain as orbax flattens it: lists, None for empty states
    chain = got["optimizer"]
    assert isinstance(chain, list)
    assert [c is None for c in chain] == ([True] if wd else []) + [False,
                                                                   True]
    a, b = (TC.adam_state_from_optax(x) for x in (chain, ref["optimizer"]))
    assert a["count"] == b["count"] == 1
    assert_bit_equal(a, b)
    # the dict form orbax gives where nothing rebuilds the lists
    d = TC.adam_state_from_optax({str(i): c for i, c in enumerate(chain)})
    assert_bit_equal(d, b)


def test_pkl_path_falls_back_to_orbax_twin(tmp_path):
    params, opt, _ = jax_state(0.0)
    JC.save_final(str(tmp_path), params, backend="orbax")
    JC.save_checkpoint(str(tmp_path), params, opt, 5, backend="orbax")
    assert not os.path.exists(tmp_path / "checkpoint-final.pkl")
    ck = TC.load_checkpoint(str(tmp_path / "checkpoint-final.pkl"))
    assert_bit_equal(ck["model"], jax.tree_util.tree_map(np.asarray,
                                                         params))
    assert TC.load_checkpoint(str(tmp_path / "checkpoint-5.pkl"))[
        "iterations"] == 5
    with pytest.raises(FileNotFoundError):
        TC.load_checkpoint(str(tmp_path / "checkpoint-6.pkl"))


@pytest.fixture(scope="module")
def fixture_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax_corpus")
    wavs, feats = make_synthetic_corpus(str(root), n_utts=2, fs=1000, up=10,
                                        n_aux=FIXTURE_CONFIG["n_aux"])
    stats = str(root / "stats.h5")
    calc_stats(feats, stats)
    return wavs, feats, stats


def test_port_trainer_resumes_from_jax_orbax(tmp_path, fixture_corpus):
    """The committed JAX .orbax and its pickle twin, each auto-resumed by
    the port's trainer to 4 iterations: the same result bit for bit."""
    wavs, feats, stats = fixture_corpus
    tcfg = TrainConfig(lr=2e-3, iters=4, checkpoint_interval=2,
                       batch_length=300, batch_size=1, max_length=900,
                       intervals=1)
    out = {}
    for name in ("checkpoint-2.orbax", "checkpoint-2.pkl"):
        expdir = tmp_path / name.split(".")[1]
        os.makedirs(expdir)
        src = os.path.join(FIXTURE, name)
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(
            src, expdir / name)
        TT.run_training(ModelConfig(**FIXTURE_CONFIG), tcfg, wavs, feats,
                        stats, str(expdir), resume="auto", device="cpu")
        out[name] = TC.load_checkpoint(str(expdir / "checkpoint-4.pkl"))
        assert TT.read_loss_record(str(expdir / "loss-final.yml"))
    a, b = out.values()
    assert a["iterations"] == b["iterations"] == 4
    assert a["optimizer"]["count"] == 4
    assert_bit_equal(a, b)


# --- the port writes, JAX reads ----------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_jax_reads_port_orbax(tmp_path, wd):
    pj, opt_j, tx = jax_state(wd, seed=3)
    params = jax.tree_util.tree_map(np.asarray, pj)
    adam = TC.adam_state_from_optax(jax.tree_util.tree_map(
        lambda a: np.asarray(a), opt_j))
    orb = TC.save_checkpoint(str(tmp_path), params, adam, 7,
                             backend="orbax", weight_decay=wd)
    fin = TC.save_final(str(tmp_path), params, backend="orbax")
    assert os.path.basename(orb) == "checkpoint-7.orbax"
    assert os.path.basename(fin) == "checkpoint-final.orbax"
    # without a template: dicts and lists, as from JAX's own .orbax
    ref = JC.save_checkpoint(str(tmp_path / "j"), pj, opt_j, 7,
                             backend="orbax")
    assert_bit_equal(JC.load_checkpoint(orb), JC.load_checkpoint(ref))
    assert_bit_equal(JC.load_checkpoint(fin)["model"], params)
    # with the JAX trainer's template: optax's own state, ready for update
    template = {"model": pj, "optimizer": tx.init(pj), "iterations": 0}
    ck = JC.load_checkpoint(orb, template=template)
    assert ck["iterations"] == 7
    assert (jax.tree_util.tree_structure(ck["optimizer"])
            == jax.tree_util.tree_structure(opt_j))
    for x, y in zip(jax.tree_util.tree_leaves(ck["optimizer"]),
                    jax.tree_util.tree_leaves(opt_j), strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    tx.update(jax.tree_util.tree_map(jnp.zeros_like, pj), ck["optimizer"],
              ck["model"])
    # the port reads its own back
    assert_bit_equal(TC.load_checkpoint(orb)["model"], params)


def test_jax_trainer_resumes_from_port_orbax(tmp_path, monkeypatch):
    """The port trains 2 iterations under the orbax backend; the JAX
    trainer auto-resumes from its checkpoint-2.orbax to 4."""
    monkeypatch.setenv("QPNET_CKPT_BACKEND", "orbax")
    cfg = dict(TINY, dilationA_depth=1)
    wavs, feats = make_synthetic_corpus(str(tmp_path), n_utts=2, fs=1000,
                                        up=10, n_aux=4)
    stats = str(tmp_path / "stats.h5")
    calc_stats(feats, stats)
    expdir = str(tmp_path / "exp")
    kw = dict(lr=1e-3, checkpoint_interval=2, batch_length=300,
              batch_size=1, max_length=900, intervals=1)
    TT.run_training(ModelConfig(**cfg), TrainConfig(iters=2, **kw), wavs,
                    feats, stats, expdir, device="cpu")
    assert sorted(os.listdir(expdir)) == [
        "checkpoint-2.orbax", "checkpoint-final.orbax", "loss-final.yml"]
    jax_run_training(JaxConfig(**cfg), JaxTrainConfig(iters=4, **kw), wavs,
                     feats, stats, expdir, resume="auto")
    ck = JC.load_checkpoint(os.path.join(expdir, "checkpoint-4.orbax"))
    assert ck["iterations"] == 4
    assert int(np.asarray(ck["optimizer"][0]["count"])) == 4
    # and the port reads JAX's checkpoint-4 and final back
    assert TC.load_checkpoint(os.path.join(expdir, "checkpoint-4.pkl"))[
        "iterations"] == 4
    assert_bit_equal(
        TC.load_checkpoint(os.path.join(expdir, "checkpoint-final.orbax")),
        JC.load_checkpoint(os.path.join(expdir, "checkpoint-final.orbax")))


# --- the CLIs ----------------------------------------------------------------

def test_train_and_update_clis_beside_jax(tmp_path, fixture_corpus,
                                          monkeypatch):
    from qpnet_tpu.bin import qpnet_train as jax_cli
    from qpnet_tpu_torch.bin import qpnet_train as cli
    from qpnet_tpu_torch.bin import qpnet_update as upd
    monkeypatch.setenv("QPNET_CKPT_BACKEND", "orbax")
    wavs, feats, stats = fixture_corpus
    wav_scp, feat_scp = str(tmp_path / "wav.scp"), str(tmp_path / "f.scp")
    for path, lines in ((wav_scp, wavs), (feat_scp, feats)):
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    def argv(expdir, *extra):
        net = [x for k, v in FIXTURE_CONFIG.items()
               for x in (f"--{k}", str(v))]
        return ["--waveforms", wav_scp, "--feats", feat_scp, "--stats",
                stats, "--expdir", expdir, "--config",
                os.path.join(expdir, "model.conf"), *net,
                "--batch_length", "200", "--max_length", "300", "--lr",
                "2e-3", "--iters", "2", "--checkpoint_interval", "2",
                "--intervals", "1", "--verbose", "0", *extra]

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cli.main(argv(jdir, "--fixed_engine", "xla"))
    cli.main(argv(tdir, "--device", "cpu"))

    def ckpts(d):
        return sorted(n for n in os.listdir(d) if n.startswith("checkpoint"))

    assert ckpts(jdir) == ckpts(tdir) == ["checkpoint-2.orbax",
                                          "checkpoint-final.orbax"]
    for name in ckpts(jdir):
        mine = TC.load_checkpoint(os.path.join(jdir, name))
        theirs = JC.load_checkpoint(os.path.join(tdir, name))
        assert sorted(flat(mine)) == sorted(flat(theirs)), name
    # the port's update CLI fine-tunes from JAX's final .orbax
    sd = str(tmp_path / "sd")
    upd.main(["--waveforms", wav_scp, "--feats", feat_scp, "--stats", stats,
              "--expdir", sd, "--config", os.path.join(jdir, "model.conf"),
              "--pretrain", os.path.join(jdir, "checkpoint-final.orbax"),
              "--batch_length", "200", "--max_length", "300", "--iters",
              "2", "--checkpoint_interval", "2", "--intervals", "1",
              "--device", "cpu", "--verbose", "0"])
    assert ckpts(sd) == ["checkpoint-2.orbax", "checkpoint-final.orbax"]
    ck = JC.load_checkpoint(os.path.join(sd, "checkpoint-2.orbax"))
    assert ck["iterations"] == 2
    assert int(np.asarray(ck["optimizer"][0]["count"])) == 2


# --- the committed fixture ---------------------------------------------------

def test_fixture_jax_reads_orbax_equal_to_pickle():
    cfg = JaxConfig(**FIXTURE_CONFIG)
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    template = {"model": params,
                "optimizer": jax_make_optimizer().init(params),
                "iterations": 0}
    orb = JC.load_checkpoint(os.path.join(FIXTURE, "checkpoint-2.orbax"),
                             template=template)
    pkl = JC.load_checkpoint(os.path.join(FIXTURE, "checkpoint-2.pkl"))
    assert orb["iterations"] == pkl["iterations"] == 2
    for x, y in zip(jax.tree_util.tree_leaves(orb),
                    jax.tree_util.tree_leaves(pkl), strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_fixture_port_reads_orbax_equal_to_pickle():
    frames = []

    def plain(data):
        frames.append(bytes(data))
        return Z.decompress(data)

    def plain_into(data, out):
        frames.append(bytes(data))
        return Z.decompress_into(data, out)

    path = os.path.join(FIXTURE, "checkpoint-2.orbax")
    orb = OF.read_checkpoint(path, plain, plain_into)
    pkl = TC.load_checkpoint(os.path.join(FIXTURE, "checkpoint-2.pkl"))
    assert orb["iterations"] == pkl["iterations"] == 2
    assert_bit_equal(orb["model"], pkl["model"])
    a = TC.adam_state_from_optax(orb["optimizer"])
    b = TC.adam_state_from_optax(pkl["optimizer"])
    assert a["count"] == b["count"] == 2
    assert_bit_equal(a, b)
    # the default (C++) decoder reads the same, and equals the plain one on
    # every frame: manifest, b-tree nodes, chunks
    assert_bit_equal(TC.load_checkpoint(path), orb)
    assert len(frames) > 50
    for f in frames:
        assert N.decompress(f) == Z.decompress(f)
    # the weights' frames are entropy-coded: a first block compressed
    # (block type 2) with Huffman literals (literals type 2)
    coded = [f for f in frames if _first_block_types(f) == (2, 2)]
    assert len(coded) >= 10


def _first_block_types(frame):
    """(block type, literals type or None) of a frame's first block."""
    fhd = frame[4]
    single = (fhd >> 5) & 1
    pos = (5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3]
           + (single, 2, 4, 8)[fhd >> 6])
    kind = (frame[pos] >> 1) & 3
    return kind, (frame[pos + 3] & 3 if kind == 2 else None)


# --- the card's machine: none of jax, orbax, tensorstore, zstandard ----------

BLOCKED = """
import sys
for name in ("jax", "jaxlib", "orbax", "tensorstore", "zstandard", "optax",
             "qpnet_tpu", "google_crc32c"):
    sys.modules[name] = None
import numpy as np
from qpnet_tpu_torch.train import checkpoint as TC
tmp, fixture = sys.argv[1], sys.argv[2]
params = {"W": np.arange(12, dtype=np.float32).reshape(3, 4),
          "fixed": [{"b": np.ones(5, np.float32)}]}
adam = {"count": 3, "mu": params, "nu": params}
for backend in ("pickle", "orbax"):
    p = TC.save_checkpoint(tmp, params, adam, 3, backend=backend)
    f = TC.save_final(tmp, params, backend=backend)
    ck = TC.load_checkpoint(p)
    assert ck["iterations"] == 3, ck
    assert TC.adam_state_from_optax(ck["optimizer"])["count"] == 3
    np.testing.assert_array_equal(TC.load_checkpoint(f)["model"]["W"],
                                  params["W"])
orb = TC.load_checkpoint(fixture + "/checkpoint-2.orbax")
pkl = TC.load_checkpoint(fixture + "/checkpoint-2.pkl")
np.testing.assert_array_equal(orb["model"]["W_post1"],
                              pkl["model"]["W_post1"])
for name in ("jax", "orbax", "tensorstore", "zstandard", "qpnet_tpu"):
    assert sys.modules[name] is None, name
print("BLOCKED_OK")
"""


def test_both_backends_without_jax_orbax_tensorstore(tmp_path):
    script = tmp_path / "blocked.py"
    script.write_text(BLOCKED)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, str(script), str(tmp_path / "c"),
                          FIXTURE], capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BLOCKED_OK" in res.stdout
