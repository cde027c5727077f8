"""PyTorch port vs the JAX package: data parallelism.  The dp mesh, sharded
decode (bit-equal to one device, and the kernel twin's shards bit-equal to
JAX's sharded interpret-mode engine on its virtual devices), the dp train
step over two spawned gloo ranks on the CPU against one process and
against JAX's `make_train_step(mesh=make_mesh(2))`, and the dp dryrun."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.models.generate import batch_fast_generate as jax_generate
from qpnet_tpu.parallel import make_mesh as jax_make_mesh
from qpnet_tpu.parallel import shard_batch as jax_shard_batch
from qpnet_tpu.train.step import TrainState as JaxTrainState
from qpnet_tpu.train.step import make_optimizer as jax_make_optimizer
from qpnet_tpu.train.step import make_train_step as jax_make_train_step
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.models import generate as TG
from qpnet_tpu_torch.models import qpnet as TQ
from qpnet_tpu_torch.parallel import Mesh, distributed as PD, dryrun
from qpnet_tpu_torch.parallel import mesh as PM
from qpnet_tpu_torch.train import step as TS

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=1,
            dilationA_depth=2, dilationA_repeat=1, upsampling_factor=4)


def carried(seed, **over):
    kw = dict(TINY, **over)
    cfg_j, cfg = JaxConfig(**kw), ModelConfig(**kw)
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    pnp = jax.tree_util.tree_map(np.asarray, pj)
    return pj, pnp, TQ.params_from_numpy(pnp, "cpu"), cfg_j, cfg


def decode_case(cfg, B, F, seed):
    rng = np.random.default_rng(seed)
    up = cfg.upsampling_factor
    h = rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32)
    d = np.repeat(rng.uniform(1.0, 3.0, (B, F)), up, 1).astype(np.float32)
    x0 = np.full((B, 1), cfg.n_quantize // 2, np.int32)
    return x0, h, [F * up - 1] * B, d


# --- the mesh ----------------------------------------------------------------

def test_mesh_make_mesh_and_shard_batch():
    m = Mesh(["cpu"] * 4)
    assert m.size == 4 and m.axis_names == ("dp",) and m.rank is None
    assert PM.make_mesh(1, "cpu").devices == [torch.device("cpu")]
    with pytest.raises(ValueError, match="truncated"):
        PM.make_mesh(2, "cpu")     # the CPU is one device
    with pytest.raises(ValueError, match="truncated"):
        PM.make_mesh(torch.cuda.device_count() + 1, "cuda")
    # tp is ported (tests/test_torch_port_tp.py): it must divide the mesh
    with pytest.raises(ValueError, match="tp=2 must divide"):
        PM.make_mesh(1, "cpu", tp=2)
    # so are sp and pp (tests/test_torch_port_sp.py, test_torch_port_pp.py)
    for axis in ("sp", "pp"):
        with pytest.raises(ValueError,
                           match=f"{axis}=2 must divide the 1-device mesh"):
            PM.make_mesh(1, "cpu", **{axis: 2})
    x = np.arange(12).reshape(4, 3)
    shards = PM.shard_batch(Mesh(["cpu"] * 2), {"x": x, "valid_len": 5})
    assert [s["x"].tolist() for s in shards] == [x[:2].tolist(),
                                                 x[2:].tolist()]
    assert shards[1]["valid_len"] == 5
    with pytest.raises(ValueError, match="divide"):
        PM.shard_batch(Mesh(["cpu"] * 3), {"x": x})


def test_host_functions_outside_a_world(monkeypatch):
    for k in ("QPNET_COORDINATOR", "QPNET_NUM_HOSTS", "QPNET_HOST_ID"):
        monkeypatch.delenv(k, raising=False)
    assert PD.process_index() == 0 and PD.process_count() == 1
    assert PD.host_shard_list("abcde") == list("abcde")
    vl, trip = PD.global_min_and_any(np.int32(7), True)
    assert int(vl) == 7 and trip is True
    assert int(PD.global_min_scalar(3)) == 3
    # no coordinator, or fewer than two hosts: a single-host run
    assert not PD.initialize_multihost()
    assert not PD.initialize_multihost("localhost:1234")
    assert not PD.initialize_multihost(num_hosts=2, host_id=0)
    monkeypatch.setenv("QPNET_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("QPNET_NUM_HOSTS", "2")
    with pytest.raises(ValueError, match="host_id"):
        PD.resolve_multihost()
    monkeypatch.setenv("QPNET_HOST_ID", "1")
    assert PD.resolve_multihost() == ("localhost:1234", 2, 1)
    assert PD.resolve_multihost(num_hosts=1) is None
    # a training mesh spans processes: no world, no step
    cfg = ModelConfig(**TINY)
    with pytest.raises(ValueError, match="dp world"):
        TS.make_train_step(cfg, TS.make_optimizer(), mesh=Mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="drives whole"):
        TG.batch_fast_generate({}, cfg, *decode_case(cfg, 2, 2, 0),
                               mesh=Mesh(["cpu"] * 2, rank=0))


# --- sharded decode ---------------------------------------------------------

@pytest.mark.parametrize("B,kw", [
    (8, dict(engine="pallas", mode="sampling")),
    (8, dict(engine="pallas", mode="argmax")),
    (8, dict(engine="pallas", mode="sampling", quantize="w8a8")),
    (8, dict(engine="xla", mode="sampling", compute_dtype=torch.float32)),
    (5, dict(engine="pallas", mode="sampling")),
    (5, dict(engine="xla", mode="sampling", compute_dtype=torch.float32)),
], ids=["k1-sampling", "k1-argmax", "w8a8", "scan-f32", "ragged-k1",
        "ragged-scan"])
def test_sharded_decode_equals_one_device(B, kw):
    """Four CPU shards (B=5 pads to 8 by repeating the last utterance)
    give one device's samples, bit for bit: each shard primes the whole
    batch and keys the kernel's hash (or draws the scan's noise) by its
    global rows."""
    _, _, pt, _, cfg = carried(1)
    x0, h, n, d = decode_case(cfg, B, 10, 1)
    one = TG.batch_fast_generate(pt, cfg, x0, h, n, d, seed=7, device="cpu",
                                 **kw)
    sharded = TG.batch_fast_generate(pt, cfg, x0, h, n, d, seed=7,
                                     mesh=Mesh(["cpu"] * 4), **kw)
    assert len(sharded) == B
    np.testing.assert_array_equal(np.stack(one), np.stack(sharded))


@pytest.mark.parametrize("kw", [dict(mode="sampling"), dict(mode="argmax"),
                                dict(mode="sampling", quantize="w8a8")],
                         ids=["sampling", "argmax", "w8a8"])
def test_sharded_k1_twin_matches_jax_sharded_engine(kw):
    """The kernel twin over Mesh(["cpu"] * 4) against JAX's sharded pallas
    engine in interpret mode over make_mesh(4) of its virtual devices
    (tests/test_decode_sharding.py's case): the same samples, bit for
    bit."""
    pj, _, pt, cfg_j, cfg = carried(1)
    x0, h, n, d = decode_case(cfg, 8, 10, 1)
    theirs = jax_generate(pj, cfg_j, x0, h, n, d, seed=7, engine="pallas",
                          interpret=True, mesh=jax_make_mesh(4), **kw)
    mine = TG.batch_fast_generate(pt, cfg, x0, h, n, d, seed=7,
                                  engine="pallas", mesh=Mesh(["cpu"] * 4),
                                  **kw)
    np.testing.assert_array_equal(np.stack(theirs), np.stack(mine))


# --- the dp step -------------------------------------------------------------

def global_batches(cfg, B=4, T=120, n=3):
    out = []
    for i in range(n):
        rng = np.random.default_rng(20 + i)
        F = T // cfg.upsampling_factor
        out.append({
            "x": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
            "h": rng.normal(size=(B, F, cfg.n_aux)).astype(np.float32),
            "t": rng.integers(0, cfg.n_quantize, (B, T)).astype(np.int32),
            "d": np.repeat(rng.uniform(1.0, 3.0, (B, F)),
                           cfg.upsampling_factor, 1).astype(np.float32),
            "valid_len": np.int32(T // 2)})
    return out


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Spawned ranks start with one intra-op thread each: the tests share
    the host's cores with other test workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_dp_step_matches_one_process_and_jax(engine, one_thread_ranks):
    """Two gloo ranks on the CPU, 2 rows each of a global batch of 4, 3 f32
    steps: the logged (all-reduced) loss equals one process's step on the
    whole batch within 1e-6 and the parameters within 1e-5; the loss is
    JAX's dp step's (make_mesh(2)) within test_train_step_matches_jax's
    1e-4.  "pallas" runs the K2 twin on each rank's rows."""
    pj, pnp, _, cfg_j, cfg = carried(3, upsampling_factor=10)
    batches = global_batches(cfg)
    ranks = dryrun.run_dp_steps(2, cfg, batches, params_np=pnp, lr=2e-3,
                                engine=engine, timeout=240)
    one_losses, one_params = dryrun.steps(cfg, batches, "cpu",
                                          params_np=pnp, lr=2e-3,
                                          engine=engine)
    (l0, p0), (l1, p1) = ranks
    assert l0 == l1
    for a, b in zip(p0, p1):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(l0, one_losses, rtol=1e-6)
    for a, b in zip(p0, one_params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    txj = jax_make_optimizer(lr=2e-3)
    mesh = jax_make_mesh(2)
    step_j = jax_make_train_step(cfg_j, txj, mesh=mesh, fixed_engine="xla",
                                 remat=False)
    sj = JaxTrainState(pj, txj.init(pj), jnp.int32(0))
    for b, mine in zip(batches, l0):
        jb = jax_shard_batch(mesh, {k: v for k, v in b.items()
                                    if k != "valid_len"})
        jb["valid_len"] = jnp.asarray(b["valid_len"])
        sj, lj = step_j(sj, jb)
        np.testing.assert_allclose(mine, float(lj), rtol=1e-4)


def test_dryrun_returns_equal_losses(one_thread_ranks):
    """The dp leg's losses equal one process's; the tp leg
    (__graft_entry__.py:136-155), (dp=1, tp=2) on the same batch, is
    within 1e-4 of the dp loss with each gate shard holding 2R/2 paired
    columns."""
    out = dryrun.dryrun_multichip(2)
    a, b = out["dp_losses"]
    assert a == b and np.isfinite(a)
    np.testing.assert_allclose(a, out["single_loss"], rtol=1e-6)
    assert len(out["tp_losses"]) == 2
    np.testing.assert_allclose(out["tp_losses"], a, atol=1e-4)
    R = dryrun.CFG["n_resch"]
    assert out["tp_W_cur"] == [(R, R)] * 2
    dryrun.check_dryrun(out, ModelConfig(**dryrun.CFG))
