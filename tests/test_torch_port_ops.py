"""PyTorch port vs the JAX package: configuration, mu-law, pitch factors,
the sampling hash, weight packing, h5 and stats reads, and import hygiene.
Host and integer paths must agree exactly."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from qpnet_tpu import config as JC
from qpnet_tpu.data import lists as JL
from qpnet_tpu.data import stats as JS
from qpnet_tpu.data.h5io import write_hdf5
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.ops import gen_kernel as JK
from qpnet_tpu.ops import mulaw as JM
from qpnet_tpu.ops import pitch as JP
from qpnet_tpu_torch import config as TC
from qpnet_tpu_torch import data as TD
from qpnet_tpu_torch.models import params_from_numpy
from qpnet_tpu_torch.ops import gen_kernel as TK
from qpnet_tpu_torch.ops import mulaw as TM
from qpnet_tpu_torch.ops import pitch as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=2,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=5)


# --- configuration ---------------------------------------------------------

@pytest.mark.parametrize("network", ["default", "Rd10Rr3Ed4Er1"])
def test_config_json_round_trips_both_ways(tmp_path, network):
    jrc = JC.RunConfig(
        model=JC.ModelConfig.from_network_name(network, n_resch=64),
        train=JC.TrainConfig(lr=3e-4, dtype="bfloat16"), fs=16000)
    jpath, tpath = str(tmp_path / "jax.conf"), str(tmp_path / "torch.conf")
    jrc.save(jpath)
    TC.RunConfig.load(jpath).save(tpath)
    with open(jpath) as a, open(tpath) as b:
        assert a.read() == b.read()
    assert dataclasses.asdict(JC.RunConfig.load(tpath)) == \
        dataclasses.asdict(jrc)


def test_network_registry_and_receptive_fields():
    assert TC._NETWORKS == JC._NETWORKS
    for name in JC._NETWORKS:
        j = JC.ModelConfig.from_network_name(name)
        t = TC.ModelConfig.from_network_name(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.dilationsF, j.dilationsA) == (t.dilationsF, t.dilationsA)
        for f in (0.5, 1.0, 3.2, 47.9):
            assert j.receptive_field(f) == t.receptive_field(f)
    with pytest.raises(ValueError):
        TC.ModelConfig.from_network_name("nope")


@pytest.mark.parametrize("fs", [16000, 22050, 24000])
def test_acoustic_config(fs):
    j, t = JC.AcousticConfig(fs=fs), TC.AcousticConfig(fs=fs)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.upsampling_factor == t.upsampling_factor


# --- mu-law and pitch ------------------------------------------------------

@pytest.mark.parametrize("mu", [256, 32])
def test_mu_law_matches_jax(mu):
    rng = np.random.default_rng(mu)
    x = np.concatenate([rng.uniform(-1, 1, 4096), [-1.0, 0.0, 1.0]])
    enc = JM.encode_mu_law(x, mu)
    np.testing.assert_array_equal(TM.encode_mu_law(x, mu), enc)
    np.testing.assert_array_equal(
        TM.encode_mu_law(torch.from_numpy(x), mu).numpy(), enc)
    classes = np.arange(mu)
    dec = JM.decode_mu_law(classes, mu)
    np.testing.assert_array_equal(TM.decode_mu_law(classes, mu), dec)
    # torch's float32 pow and numpy's differ in the last bit for some
    # classes, and (256**|fx| - 1) carries that bit to small outputs: within
    # 2**-24 of full scale (the numpy path, which the decode CLI uses, is
    # exact above)
    np.testing.assert_allclose(
        TM.decode_mu_law(torch.from_numpy(classes), mu).numpy(), dec,
        rtol=0, atol=2 ** -24)


def test_pitch_factors_match_jax():
    rng = np.random.default_rng(3)
    f0 = rng.uniform(60, 400, 500)
    f0[rng.random(500) < 0.2] = 0.0
    np.testing.assert_array_equal(TP.dilated_factor(f0, 22050, 8),
                                  JP.dilated_factor(f0, 22050, 8))
    h = rng.normal(size=(200, 6))
    h[:, 1] = rng.uniform(-50, 300, 200)
    for thr in (0.0, 40.0):
        np.testing.assert_array_equal(TP.batch_f0(h, thr),
                                      JP.batch_f0(h, thr))
    np.testing.assert_array_equal(TP.extend_time(h, 7),
                                  JP.extend_time(h, 7))


# --- the sampling hash -----------------------------------------------------

def _numpy_hash(seed, t, b_offset, B, Q):
    """The kernel's hash in numpy uint32 arithmetic, as written out in
    tests/test_sampling_parity.py, with the global row index."""
    with np.errstate(over="ignore"):
        base = ((np.int64(seed).astype(np.uint32) * np.uint32(0x85EBCA6B))
                ^ (np.uint32(t) * np.uint32(2654435761)))
        idx = ((np.arange(B, dtype=np.uint32)[:, None] + np.uint32(b_offset))
               * np.uint32(Q) + np.arange(Q, dtype=np.uint32)[None, :])
        v = base + idx * np.uint32(0x9E3779B9)
        v = v ^ (v >> np.uint32(16)); v = v * np.uint32(0x7FEB352D)
        v = v ^ (v >> np.uint32(15)); v = v * np.uint32(0x846CA68B)
        v = v ^ (v >> np.uint32(16))
    return v


@pytest.mark.parametrize("seed", [0, 1, 100, 2 ** 31 - 1, -5])
def test_hash_bits_match_numpy_formula(seed):
    B, Q = 3, 256
    # t * 2654435761 wraps mod 2**32 from t = 2 on
    for t in (0, 1, 2, 3, 1617, 22049, 10 ** 6, 2 ** 31 - 1):
        for b_offset in (0, 7, 100003):
            ref = _numpy_hash(seed, t, b_offset, B, Q)
            rows = (torch.arange(B, dtype=torch.int64) + b_offset) * Q
            got = TK.hash_bits(seed, t, rows[:, None]
                               + torch.arange(Q, dtype=torch.int64)[None, :])
            np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
            unif = (ref >> np.uint32(8)).astype(np.float32) / (1 << 24) \
                + np.float32(1e-12)
            np.testing.assert_allclose(
                TK.gumbel_noise(seed, t, b_offset, B, Q, "cpu").numpy(),
                -np.log(-np.log(unif)), rtol=1e-6, atol=1e-6)


# --- weight packing --------------------------------------------------------

def test_pack_weights_matches_jax_layout():
    cfg_j, cfg_t = JC.ModelConfig(**TINY), TC.ModelConfig(**TINY)
    params = jax_init_params(jax.random.PRNGKey(0), cfg_j)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["up_b"] = np.float32(0.3)   # exercise c_all's up_b term
    pj = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                JK.pack_weights(params, cfg_j))
    pt = {k: v.float().numpy()
          for k, v in TK.pack_weights(params_from_numpy(params, "cpu"),
                                      cfg_t).items()}
    np.testing.assert_array_equal(pt["W_in_t"].transpose(0, 2, 1), pj["W_in"])
    np.testing.assert_array_equal(pt["W_out_t"].transpose(0, 2, 1),
                                  pj["W_out"])
    np.testing.assert_array_equal(pt["W_post1_t"].T, pj["W_post1"])
    np.testing.assert_array_equal(pt["W_post2_t"].T, pj["W_post2"])
    for k in ("W_aux", "E_cat", "b_res", "b_skip_sum", "up_w", "b_causal",
              "b_post1", "b_post2"):
        np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
    np.testing.assert_allclose(pt["c_all"], pj["c_all"], rtol=1e-6,
                               atol=1e-6)


# --- h5, stats and lists ---------------------------------------------------

def test_h5_stats_and_lists_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    feats = []
    for i in range(3):
        path = str(tmp_path / "h5" / f"utt{i}.h5")
        write_hdf5(path, "/world", rng.normal(size=(20 + i, 6)))
        feats.append(path)
    stats = str(tmp_path / "stats.h5")
    JS.calc_stats(feats, stats)
    for f in feats:
        np.testing.assert_array_equal(TD.read_hdf5(f, "/world"),
                                      np.asarray(JS.read_hdf5(f, "/world")))
        assert TD.shape_hdf5(f, "/world") == (int(f[-4]) + 20, 6)
    h = rng.normal(size=(30, 6))
    np.testing.assert_array_equal(TD.load_scaler(stats).transform(h),
                                  JS.load_scaler(stats).transform(h))
    assert sorted(TD.find_files(str(tmp_path), "*.h5")) == \
        sorted(JL.find_files(str(tmp_path), "*.h5"))
    lst = str(tmp_path / "list.scp")
    with open(lst, "w") as f:
        f.write("\n".join(feats) + "\n\n")
    assert TD.read_txt(lst) == JL.read_txt(lst) == feats


# --- import hygiene --------------------------------------------------------

def test_port_imports_no_jax_and_no_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import qpnet_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "qpnet_tpu_torch.__path__, 'qpnet_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m.startswith('ml_dtypes')"
        " or m.startswith('optax')"
        " or m == 'qpnet_tpu' or m.startswith('qpnet_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
