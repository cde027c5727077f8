"""PyTorch port vs the JAX package: the dp CLIs.  `qpnet_train --n_devices
2 --device cpu` (two spawned gloo ranks) against the JAX CLI's
`--n_devices 2`; two real processes joined through `--coordinator/
--n_hosts/--host_id` (identical losses, lead-only checkpoints, and one
host's preemption stopping both at the same iteration: the port's versions
of tests/test_multihost.py, at tiny shapes); and the decode CLI's
`--n_devices` and host fan-out."""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import yaml
from scipy.io import wavfile

from helpers import make_synthetic_corpus
from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.config import RunConfig as JaxRunConfig
from qpnet_tpu.data.stats import calc_stats
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.train import checkpoint as JC
from qpnet_tpu_torch.parallel import Mesh
from qpnet_tpu_torch.train import checkpoint as TC
from qpnet_tpu_torch.utils.yamlconf import read_loss_record

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_corpus")
    wavs, feats = make_synthetic_corpus(str(root), n_utts=4, fs=1000, up=10,
                                        n_aux=4)
    stats = str(root / "stats.h5")
    calc_stats(feats, stats)
    wav_scp, feat_scp = str(root / "wav.scp"), str(root / "feat.scp")
    for path, lines in ((wav_scp, wavs), (feat_scp, feats)):
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    import jax
    cfg = JaxConfig(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
                    dilationF_depth=3, dilationF_repeat=1,
                    dilationA_depth=2, dilationA_repeat=1,
                    upsampling_factor=10)
    # the same starting weights in both packages
    pretrain = JC.save_final(str(root / "si"),
                             jax_init_params(jax.random.PRNGKey(11), cfg))
    return {"root": root, "wav": wav_scp, "feat": feat_scp, "stats": stats,
            "pretrain": pretrain}


def train_argv(c, expdir, *extra):
    return ["--waveforms", c["wav"], "--feats", c["feat"],
            "--stats", c["stats"], "--expdir", expdir,
            "--config", os.path.join(expdir, "model.conf"),
            "--n_quantize", "32", "--n_aux", "4", "--n_resch", "16",
            "--n_skipch", "8", "--dilationF_depth", "3",
            "--dilationF_repeat", "1", "--dilationA_depth", "2",
            "--dilationA_repeat", "1", "--upsampling_factor", "10",
            "--batch_length", "200", "--max_length", "300", "--lr", "2e-3",
            "--checkpoint_interval", "2", "--intervals", "1", *extra]


def test_train_cli_n_devices_matches_the_jax_cli(corpus, tmp_path, capfd,
                                                 monkeypatch):
    from qpnet_tpu.bin import qpnet_train as jax_cli
    from qpnet_tpu_torch.bin import qpnet_train as cli
    flags = ("--batch_size", "2", "--iters", "4", "--n_devices", "2")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    flags += ("--pretrain", corpus["pretrain"])
    jax_cli.main(train_argv(corpus, jdir, *flags, "--verbose", "0"))
    capfd.readouterr()
    # spawned ranks start with one intra-op thread each: the tests share
    # the host's cores with other test workers
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cli.main(train_argv(corpus, tdir, *flags, "--device", "cpu"))
    log = capfd.readouterr().err
    with open(os.path.join(jdir, "loss-final.yml")) as f:
        ref = yaml.safe_load(f)
    got = read_loss_record(os.path.join(tdir, "loss-final.yml"))
    assert len(ref) == 4
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert log.count("gradient all-reduce over gloo (the ranks run on the "
                     "CPU)") == 2
    # both ranks log the same (all-reduced) losses; one writes the files
    losses = re.findall(r"average loss = ([0-9.]+)", log)
    assert sorted(losses) == sorted(2 * ["%.6f" % x for x in got]), losses
    assert log.count("final checkpoint created.") == 1
    assert log.count("2-iter checkpoint created.") == 1
    # JAX reads the weights-only final checkpoint: checkpoint-4's weights
    import jax
    final = JC.load_checkpoint(os.path.join(tdir, "checkpoint-final.pkl"))
    mine = TC.load_checkpoint(os.path.join(tdir, "checkpoint-4.pkl"))
    assert mine["iterations"] == 4 and mine["optimizer"]["count"] == 4
    for a, b in zip(jax.tree_util.tree_leaves(final["model"]),
                    jax.tree_util.tree_leaves(mine["model"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _free_coordinator():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def run_hosts(corpus, expdir, tmp_path, extra, env_for=lambda h: {}):
    """Two `qpnet_train` processes joined as two hosts; returns their
    outputs.  Each gets a timeout, and is killed in a finally."""
    coord = _free_coordinator()
    procs = []
    try:
        for hid in range(2):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("QPNET_")}
            env.update(env_for(hid), OMP_NUM_THREADS="1")
            argv = train_argv(corpus, expdir, *extra, "--device", "cpu",
                              "--coordinator", coord, "--n_hosts", "2",
                              "--host_id", str(hid))
            argv[argv.index("--config") + 1] = str(tmp_path / f"m{hid}.conf")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "qpnet_tpu_torch.bin.qpnet_train",
                 *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for hid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"host {hid} failed:\n{out[-4000:]}"
    return outs


def test_two_hosts_train_as_one(corpus, tmp_path):
    """Host-sharded lists, one rank each, the gradient all-reduce across
    the process boundary, lead-host-only checkpoints: both hosts log the
    same losses, and the replicas end equal (the trainer checks it)."""
    expdir = str(tmp_path / "exp")
    outs = run_hosts(corpus, expdir, tmp_path,
                     ("--batch_size", "4", "--iters", "3"))
    assert os.path.exists(os.path.join(expdir, "checkpoint-final.pkl"))
    assert os.path.exists(os.path.join(expdir, "checkpoint-2.pkl"))
    losses = []
    for out in outs:
        vals = re.findall(r"average loss = ([0-9.]+)", out)
        assert len(vals) == 3, out[-2000:]
        losses.append(vals)
        assert "host batch 2 over 1 ranks" in out
        assert "equal on the 2 ranks" in out
    assert losses[0] == losses[1]
    assert "checkpoint created" in outs[0]
    assert "checkpoint created" not in outs[1]
    assert len(read_loss_record(os.path.join(expdir, "loss-final.yml"))) == 3


def test_preemption_stops_every_host_together(corpus, tmp_path):
    """QPNET_PREEMPT_AFTER=3 on host 0 only: the trip rides step 4's
    valid_len gather, so both hosts save and exit after iteration 4."""
    expdir = str(tmp_path / "exp")
    outs = run_hosts(corpus, expdir, tmp_path,
                     ("--batch_size", "4", "--iters", "50",
                      "--checkpoint_interval", "100"),
                     env_for=lambda h: {"QPNET_PREEMPT_AFTER": "3"}
                     if h == 0 else {})
    assert os.path.exists(os.path.join(expdir, "checkpoint-4.pkl"))
    assert not os.path.exists(os.path.join(expdir, "checkpoint-final.pkl"))
    assert "preemption at iteration 4" in outs[0]
    for out in outs:
        assert len(re.findall(r"average loss", out)) == 4, out[-2000:]
    ck = TC.load_checkpoint(os.path.join(expdir, "checkpoint-4.pkl"))
    assert ck["iterations"] == 4


# --- the decode CLI ----------------------------------------------------------

@pytest.fixture(scope="module")
def decode_exp(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_decode")
    _, feats = make_synthetic_corpus(str(root), n_utts=5, fs=1000, up=10,
                                     n_aux=4, seconds=0.05)
    feat_scp = str(root / "feat.scp")
    with open(feat_scp, "w") as f:
        f.write("\n".join(feats) + "\n")
    stats = str(root / "stats.h5")
    calc_stats(feats, stats)
    cfg = JaxConfig(n_quantize=256, n_aux=4, n_resch=16, n_skipch=8,
                    dilationF_depth=2, dilationF_repeat=1,
                    dilationA_depth=2, dilationA_repeat=1,
                    upsampling_factor=10)
    config = str(root / "model.conf")
    JaxRunConfig(model=cfg, fs=1000).save(config)
    import jax
    ckpt = JC.save_final(str(root / "exp"),
                         jax_init_params(jax.random.PRNGKey(0), cfg))
    return {"feat_scp": feat_scp, "stats": stats, "config": config,
            "ckpt": ckpt}


def decode_argv(e, outdir, *extra):
    return ["--feats", e["feat_scp"], "--stats", e["stats"],
            "--config", e["config"], "--outdir", outdir,
            "--checkpoint", e["ckpt"], "--fs", "1000", "--batch_size", "0",
            "--verbose", "0", "--device", "cpu", *extra]


def wavs_in(d):
    return {n: wavfile.read(os.path.join(d, n))[1]
            for n in sorted(os.listdir(d))}


def test_decode_n_devices_and_host_fanout(decode_exp, tmp_path, monkeypatch):
    """`--n_devices 2` needs two devices of --device's type, so on the CPU
    make_mesh is patched to two CPU shards: the wavs equal one device's, bit
    for bit.  Two hosts (--n_hosts 2, each with --n_devices 2) write the
    strided halves of the list, each wav the one-host run's (argmax, so the
    hosts' other batch composition leaves the samples as they are)."""
    from qpnet_tpu_torch import parallel
    from qpnet_tpu_torch.bin import qpnet_decode
    e = decode_exp
    made = []

    def two_cpu_shards(n, device):
        made.append((n, device))
        return Mesh(["cpu"] * n)

    qpnet_decode.main(decode_argv(e, str(tmp_path / "one"), "--mode",
                                  "argmax"))
    monkeypatch.setattr(parallel, "make_mesh", two_cpu_shards)
    flags = ("--mode", "argmax", "--n_devices", "2")
    qpnet_decode.main(decode_argv(e, str(tmp_path / "two"), *flags))
    assert made == [(2, "cpu")]
    for hid in range(2):
        qpnet_decode.main(decode_argv(e, str(tmp_path / f"host{hid}"), *flags,
                                      "--n_hosts", "2", "--host_id",
                                      str(hid)))
    one = wavs_in(str(tmp_path / "one"))
    assert sorted(one) == [f"utt{i}.wav" for i in range(5)]
    parts = [wavs_in(str(tmp_path / f"host{hid}")) for hid in range(2)]
    assert sorted(parts[0]) == ["utt0.wav", "utt2.wav", "utt4.wav"]
    assert sorted(parts[1]) == ["utt1.wav", "utt3.wav"]
    for part in (wavs_in(str(tmp_path / "two")), *parts):
        for name, wav in part.items():
            np.testing.assert_array_equal(wav, one[name])
