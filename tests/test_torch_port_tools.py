"""PyTorch port vs the JAX package: the validation CLI (losses, and one
`validation_result.yml` extended by both packages in turn), reference-
checkpoint conversion, the serving soak on the CPU and the kernel build
cache's key."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from helpers import make_synthetic_corpus
from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.config import RunConfig as JaxRunConfig
from qpnet_tpu.data.stats import calc_stats
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.tools import convert_checkpoint as jax_convert
from qpnet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from qpnet_tpu.train.checkpoint import save_checkpoint, save_final
from qpnet_tpu_torch.bin import qpnet_validate
from qpnet_tpu_torch.config import ModelConfig, RunConfig
from qpnet_tpu_torch.ops import _build
from qpnet_tpu_torch.tools import convert_checkpoint
from qpnet_tpu_torch.train import load_checkpoint
from qpnet_tpu_torch.utils.yamlconf import (read_validation_record,
                                            write_validation_record)
from test_convert import make_state_dict

FS, UP, N_AUX = 1000, 10, 4
MODEL = dict(n_quantize=256, n_aux=N_AUX, n_resch=16, n_skipch=8,
             dilationF_depth=2, dilationF_repeat=1,
             dilationA_depth=2, dilationA_repeat=1,
             dense_factor=8, upsampling_factor=UP)
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def expdir(tmp_path_factory):
    """A JAX-written experiment: corpus lists, stats, model.conf and two
    checkpoints (final, and iteration 5 with optax state)."""
    root = tmp_path_factory.mktemp("port_tools")
    wavs, feats = make_synthetic_corpus(str(root), n_utts=2, fs=FS, up=UP,
                                        n_aux=N_AUX, seconds=0.6)
    lists = {}
    for name, files in (("wavs", wavs), ("feats", feats)):
        lists[name] = str(root / f"{name}.scp")
        with open(lists[name], "w") as f:
            f.write("\n".join(files) + "\n")
    stats = str(root / "stats.h5")
    calc_stats(feats, stats)
    cfg = JaxConfig(**MODEL)
    config = str(root / "model.conf")
    JaxRunConfig(model=cfg, fs=FS).save(config)
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    save_final(str(root), params)
    tx = optax.chain(optax.scale_by_adam(), optax.scale(-1e-3))
    save_checkpoint(str(root), params, tx.init(params), 5)
    return dict(root=root, stats=stats, config=config, **lists)


def validate_argv(e, ckpt, resultdir):
    return ["--waveforms", e["wavs"], "--feats", e["feats"],
            "--stats", e["stats"], "--resultdir", str(resultdir),
            "--config", e["config"],
            "--checkpoint", str(e["root"] / ckpt),
            "--batch_length", "300", "--max_length", "500",
            "--verbose", "0"]


def test_validate_cli_against_jax_and_cross_appended(expdir, tmp_path):
    """Each package validates one checkpoint into one result file in turn,
    both orders: every key is kept, the losses agree within 1e-5, and the
    file reads back equal under yaml.safe_load and the port's reader."""
    from qpnet_tpu.bin import qpnet_validate as jax_validate

    def port(ckpt, out):
        qpnet_validate.main(validate_argv(expdir, ckpt, out)
                            + ["--device", "cpu"])

    def jax_(ckpt, out):
        jax_validate.main(validate_argv(expdir, ckpt, out))

    results = {}
    for first, second in ((port, jax_), (jax_, port)):
        out = tmp_path / first.__name__
        first("checkpoint-final.pkl", out)
        second("checkpoint-5.pkl", out)
        path = out / qpnet_validate.RESULT_FILE
        with open(path) as f:
            got = yaml.safe_load(f)
        assert got == read_validation_record(str(path))
        assert sorted(got) == ["checkpoint-5.pkl", "checkpoint-final.pkl"]
        assert all(np.isfinite(v) for v in got.values())
        results[first.__name__] = got
    # the same parameters in both checkpoints, each validated by both
    for a in results.values():
        for b in results.values():
            for k in a:
                assert abs(a[k] - b["checkpoint-final.pkl"]) <= LOSS_TOL


def test_validation_loss_is_the_mean_of_eval_steps(expdir):
    from qpnet_tpu_torch.data.batcher import train_window_generator
    from qpnet_tpu_torch.data.stats import load_scaler
    from qpnet_tpu_torch.models import params_from_numpy
    from qpnet_tpu_torch.train.step import batch_to_device, make_eval_step

    run_cfg = RunConfig.load(expdir["config"])
    params = params_from_numpy(
        load_checkpoint(str(expdir["root"] / "checkpoint-final.pkl"))[
            "model"], "cpu")
    with open(expdir["wavs"]) as f:
        wavs = f.read().split()
    with open(expdir["feats"]) as f:
        feats = f.read().split()
    scaler = load_scaler(expdir["stats"])

    def batches():
        return train_window_generator(
            wavs, feats, run_cfg.model, feat_transform=scaler.transform,
            batch_length=300, max_length=500, shuffle=False, loop=False)

    mean, losses = qpnet_validate.validation_loss(params, run_cfg.model,
                                                  batches(), "cpu")
    step = make_eval_step(run_cfg.model)
    want = []
    for b in batches():
        b.pop("window_lens")
        want.append(float(step(params, batch_to_device(b, "cpu"))))
    assert len(losses) == len(want) >= 2
    assert losses == want and mean == float(np.mean(want))
    assert np.isnan(qpnet_validate.validation_loss(params, run_cfg.model,
                                                   [], "cpu")[0])


def test_validation_record_reads_what_pyyaml_writes(tmp_path):
    values = {"checkpoint-final.pkl": 3.25, "checkpoint-10.pkl": 1e-20,
              "it's.pkl": float("inf"), "1000": -2.5, "yes": 0.1,
              "a: b": 7.0}
    ours, theirs = tmp_path / "ours.yml", tmp_path / "theirs.yml"
    write_validation_record(str(ours), values)
    with open(theirs, "w") as f:
        yaml.safe_dump(values, f)
    for path in (ours, theirs):
        with open(path) as f:
            assert yaml.safe_load(f) == values
        assert read_validation_record(str(path)) == values
    write_validation_record(str(ours), {"nan.pkl": float("nan")})
    assert np.isnan(read_validation_record(str(ours))["nan.pkl"])


def _tree_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_convert_state_dict_bit_equal_to_jax(tmp_path):
    """From one synthetic state_dict, directly and through torch.save and
    load_torch_checkpoint."""
    spec = dict(n_quantize=16, n_aux=3, n_resch=8, n_skipch=4,
                dilationF_depth=2, dilationF_repeat=2, dilationA_depth=2,
                dilationA_repeat=1, kernel_size=2, upsampling_factor=4)
    cfg_j, cfg = JaxConfig(**spec), ModelConfig(**spec)
    sd = make_state_dict(cfg_j, np.random.default_rng(0))
    _tree_equal(convert_checkpoint.convert_state_dict(sd, cfg),
                jax_convert.convert_state_dict(sd, cfg_j))
    path = str(tmp_path / "ref.pkl")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    mine = convert_checkpoint.load_torch_checkpoint(path)
    theirs = jax_convert.load_torch_checkpoint(path)
    assert sorted(mine) == sorted(sd)
    _tree_equal(convert_checkpoint.convert_state_dict(mine, cfg),
                jax_convert.convert_state_dict(theirs, cfg_j))


def test_convert_cli_pickle_loads_in_both_packages(tmp_path):
    """The default network's layer count at tiny widths, through the CLI:
    the pickle and model.conf load in both packages, equal to
    convert_state_dict."""
    spec = dict(n_quantize=16, n_aux=3, n_resch=8, n_skipch=4,
                upsampling_factor=4)
    cfg = ModelConfig(**spec)
    sd = make_state_dict(JaxConfig(**spec), np.random.default_rng(1))
    ref = str(tmp_path / "ref.pkl")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ref)
    out, conf = str(tmp_path / "ck.pkl"), str(tmp_path / "model.conf")
    convert_checkpoint.main(["--checkpoint", ref, "--out", out,
                             "--n_aux", "3", "--upsampling_factor", "4",
                             "--config", conf])
    want = convert_checkpoint.convert_state_dict(sd, cfg)
    _tree_equal(load_checkpoint(out)["model"], want)
    _tree_equal(jax_load_checkpoint(out)["model"], want)
    assert RunConfig.load(conf).model == ModelConfig(
        n_aux=3, upsampling_factor=4)
    assert JaxRunConfig.load(conf).model.n_resch == 512


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the soak, in a process of its own whose nice value is lowered first
SOAK = """
import json, os, sys
try:
    os.nice(-{step})
except PermissionError:
    print(f"soak: may not raise its priority, runs at nice {{os.nice(0)}}",
          file=sys.stderr)
from qpnet_tpu_torch.tools.serve_soak import run_soak
out = run_soak(minutes=0.15, streams=4, seconds=0.2, tiny=True,
               sample_every_s=1.0, verbose=False, device="cpu")
print(json.dumps(out))
"""


def soak_ahead_of_neighbours(step: int = 10, timeout: float = 120) -> dict:
    """The soak's summary, from a child process whose nice value is
    lowered by `step` before it starts a thread, so that every thread of
    the soak runs at that priority and nothing of it stays in this
    process.  Where the child may not raise its priority, it runs as it is
    and says so on stderr (echoed here).

    The soak's drift gate compares its own chunk latencies over 9 s.  On a
    CPU shared with other test workers, their load changes within that
    window and moves the drift past the gate whatever the soak's own
    torch threads; ahead of them, the soak's latencies and drift are the
    ones it shows alone."""
    proc = subprocess.run([sys.executable, "-c", SOAK.format(step=step)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    sys.stderr.write(proc.stderr)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_serve_soak_on_the_cpu():
    """A short closed-loop soak on the tiny network through the kernel's
    twin: JSON-clean, passing, every power-of-two group size prewarmed.
    The soak runs ahead of the other test workers' load
    (`soak_ahead_of_neighbours`): its gates are unchanged."""
    from qpnet_tpu_torch.tools.serve_soak import prewarm_buckets

    assert prewarm_buckets(8, 64) == [1, 2, 4, 8]
    assert prewarm_buckets(6, 64) == [1, 2, 4, 8]
    assert prewarm_buckets(100, 64) == [1, 2, 4, 8, 16, 32, 64]
    assert prewarm_buckets(1, 64) == [1]
    out = soak_ahead_of_neighbours()
    assert json.loads(json.dumps(out)) == out
    assert out["prewarmed_buckets"] == [1, 2, 4]
    assert not out["errors"] and out["completions"] > 0, out
    assert out["ok"], out


def test_build_cache_key_and_directory(monkeypatch, tmp_path):
    """QPNET_KERNEL_CACHE moves the libraries; another nvcc version (a
    stubbed `nvcc --version`) gives another library; the default is the
    checkout's build/kernels."""
    versions = {"nvcc": "Cuda compilation tools, release 12.8, V12.8.93\n"}
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "nvcc_version", lambda nvcc: versions[nvcc])
    monkeypatch.delenv("QPNET_KERNEL_CACHE", raising=False)
    gen = (_build.CSRC / "gen_kernel.cu").read_bytes()
    train = (_build.CSRC / "train_kernel.cu").read_bytes()
    default = _build.library_path("gen_kernel", gen)
    assert default.parent == _build.DEFAULT_BUILD_DIR
    assert _build.DEFAULT_BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert _build.library_path("gen_kernel", gen) == default
    assert _build.library_path("train_kernel", train) != default
    assert _build.library_path("gen_kernel", gen + b"\n") != default
    versions["nvcc"] = "Cuda compilation tools, release 12.9, V12.9.41\n"
    other = _build.library_path("gen_kernel", gen)
    assert other.parent == default.parent and other.name != default.name
    monkeypatch.setenv("QPNET_KERNEL_CACHE", str(tmp_path / "kc"))
    assert (_build.library_path("gen_kernel", gen)
            == tmp_path / "kc" / other.name)


def test_build_source_compiles_once(monkeypatch, tmp_path):
    """A stubbed nvcc: the first call compiles the source into the cache,
    the second loads the same library without compiling."""
    calls = []

    class Done:
        returncode, stderr = 0, ""

    def run(cmd, **kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"so")
        return Done()

    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "nvcc_version", lambda nvcc: "release 12.8")
    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setenv("QPNET_KERNEL_CACHE", str(tmp_path / "kc"))
    out = _build.build_source("k", b"__global__ void k() {}\n")
    assert out == _build.library_path("k", b"__global__ void k() {}\n")
    assert out.read_bytes() == b"so" and len(calls) == 1
    assert _build.build_source("k", b"__global__ void k() {}\n") == out
    assert len(calls) == 1 and os.listdir(tmp_path / "kc") == [out.name]


def test_nvcc_version_is_read_once(monkeypatch):
    calls = []

    class Done:
        stdout = "release 12.8\n"

    def run(cmd, **kw):
        calls.append(cmd)
        return Done()

    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build, "_nvcc_versions", {})
    assert _build.nvcc_version("/x/nvcc") == "release 12.8\n"
    assert _build.nvcc_version("/x/nvcc") == "release 12.8\n"
    assert calls == [["/x/nvcc", "--version"]]


def test_host_build_key_and_the_unchanged_cuda_key(monkeypatch, tmp_path):
    """The host DSP core's library is keyed on its source, the host flags
    and `<compiler> --version` (a stubbed compiler), in the kernels' build
    directory; the CUDA key is the one of earlier builds (its digest for a
    fixed source and nvcc version is pinned here)."""
    versions = {"c++": "c++ (Debian 12.2.0-14) 12.2.0\n"}
    monkeypatch.setattr(_build, "find_cxx", lambda: "c++")
    monkeypatch.setattr(_build, "cxx_version", lambda cxx: versions[cxx])
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "nvcc_version", lambda nvcc: (
        "Cuda compilation tools, release 12.8, V12.8.93\n"))
    monkeypatch.setenv("QPNET_KERNEL_CACHE", str(tmp_path / "kc"))
    src = (_build.CSRC / "qpdsp.cpp").read_bytes()
    key = _build.host_library_path("qpdsp", src)
    assert key.parent == tmp_path / "kc" and key.name.startswith("libqpdsp-")
    assert _build.host_library_path("qpdsp", src) == key
    assert _build.host_library_path("qpdsp", src + b"\n") != key
    versions["c++"] = "c++ (Debian 13.1.0-1) 13.1.0\n"
    assert _build.host_library_path("qpdsp", src) != key
    cu = b"__global__ void k() {}\n"
    assert _build.library_path("k", cu).name == "libk-a00f123af859c0ee.so"
    assert "-ffp-contract=off" in _build.HOST_CXX_FLAGS
    assert not any("march" in f for f in _build.HOST_CXX_FLAGS)


def test_host_core_builds_once_with_the_host_compiler(monkeypatch, tmp_path):
    """csrc/qpdsp.cpp builds with the host compiler here (no nvcc) into
    QPNET_KERNEL_CACHE, and a second build finds the library."""
    monkeypatch.setenv("QPNET_KERNEL_CACHE", str(tmp_path / "kc"))
    first = _build.build_host("qpdsp")
    assert first.exists() and first.parent == tmp_path / "kc"
    mtime = first.stat().st_mtime_ns
    assert _build.build_host("qpdsp") == first
    assert first.stat().st_mtime_ns == mtime
    import ctypes
    assert ctypes.CDLL(str(first)).qpdsp_mlsa_state_size(24, 4) == 200
