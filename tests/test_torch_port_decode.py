"""The port's decode CLI on the CPU against the port's library, on files the
JAX package wrote: h5 features, a stats file, `model.conf` and checkpoint
pickles (`checkpoint-final.pkl`, and `checkpoint-<iter>.pkl` holding optax
state, which loads with no JAX installed)."""

import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from helpers import make_synthetic_corpus
from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.config import RunConfig as JaxRunConfig
from qpnet_tpu.data.stats import calc_stats
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.train.checkpoint import save_checkpoint, save_final
from qpnet_tpu_torch.bin import qpnet_decode
from qpnet_tpu_torch.config import RunConfig
from qpnet_tpu_torch.data import read_hdf5
from qpnet_tpu_torch.data.stats import load_scaler
from qpnet_tpu_torch.models import batch_fast_generate, params_from_numpy
from qpnet_tpu_torch.ops import decode_mu_law
from qpnet_tpu_torch.train import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS, UP, N_AUX = 1000, 10, 4
MODEL = dict(n_quantize=256, n_aux=N_AUX, n_resch=16, n_skipch=8,
             dilationF_depth=2, dilationF_repeat=1,
             dilationA_depth=2, dilationA_repeat=1,
             dense_factor=8, upsampling_factor=UP)


@pytest.fixture(scope="module")
def expdir(tmp_path_factory):
    """A JAX-written experiment: corpus, stats, model.conf, checkpoints."""
    root = tmp_path_factory.mktemp("port_decode")
    _, feats = make_synthetic_corpus(str(root), n_utts=3, fs=FS, up=UP,
                                     n_aux=N_AUX, seconds=0.05)
    feat_scp = str(root / "feats.scp")
    with open(feat_scp, "w") as f:
        f.write("\n".join(feats) + "\n")
    stats = str(root / "stats.h5")
    calc_stats(feats, stats)
    cfg = JaxConfig(**MODEL)
    config = str(root / "model.conf")
    JaxRunConfig(model=cfg, fs=FS).save(config)
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    ckdir = str(root / "ckpt")
    save_final(ckdir, params)
    tx = optax.chain(optax.scale_by_adam(), optax.scale(-1e-3))
    save_checkpoint(ckdir, params, tx.init(params), 5)
    return dict(root=root, feats=feats, feat_scp=feat_scp, stats=stats,
                config=config,
                final=os.path.join(ckdir, "checkpoint-final.pkl"),
                iter5=os.path.join(ckdir, "checkpoint-5.pkl"),
                params=jax.tree_util.tree_map(np.asarray, params))


def argv(e, outdir, *extra):
    return ["--feats", e["feat_scp"], "--stats", e["stats"],
            "--config", e["config"], "--outdir", outdir,
            "--checkpoint", e["final"], "--fs", str(FS), "--verbose", "0",
            "--device", "cpu", *extra]


def read_wavs(template, feats):
    out = {}
    for f in feats:
        fid = os.path.basename(f).rsplit(".", 1)[0]
        rate, wav = wavfile.read(template.replace("feat_id", fid))
        assert rate == FS and wav.dtype == np.int16
        out[fid] = wav
    return out


def test_cli_writes_the_librarys_wavs(expdir, tmp_path):
    out = str(tmp_path / "wav" / "feat_id.wav")
    qpnet_decode.main(argv(expdir, out, "--batch_size", "2"))
    wavs = read_wavs(out, expdir["feats"])
    # the library, on the same batches the CLI forms
    args = qpnet_decode.get_arguments(argv(expdir, out, "--batch_size", "2"))
    run_cfg = RunConfig.load(expdir["config"])
    params = params_from_numpy(load_checkpoint(expdir["final"])["model"],
                               "cpu")
    n_checked = 0
    for fids, x, h, n_samples, d in qpnet_decode.decode_batches(
            expdir["feats"], run_cfg, args, load_scaler(expdir["stats"])):
        rows = batch_fast_generate(params, run_cfg.model, x, h, n_samples,
                                   d, seed=100, device="cpu")
        for fid, s, n in zip(fids, rows, n_samples):
            ref = np.clip(decode_mu_law(s, 256) * 32768, -32768,
                          32767).astype(np.int16)
            n_frames = read_hdf5(
                os.path.join(expdir["root"], "h5", fid + ".h5"),
                "/world").shape[0]
            assert len(wavs[fid]) == n == n_frames * UP - 1
            np.testing.assert_array_equal(wavs[fid], ref)
            assert wavs[fid].max() > wavs[fid].min()
            n_checked += 1
    assert n_checked == 3


def test_cli_trace_dir_writes_the_decodings_spans(expdir, tmp_path):
    """--trace_dir: a Chrome trace of the decoding, with a decode.call span
    a batch beside the host ops, and the wavs written as without it."""
    import json
    out = str(tmp_path / "wav" / "feat_id.wav")
    trace_dir = tmp_path / "trace"
    qpnet_decode.main(argv(expdir, out, "--batch_size", "2", "--mode",
                           "argmax", "--trace_dir", str(trace_dir)))
    (name,) = os.listdir(trace_dir)
    with open(trace_dir / name) as f:
        events = json.load(f)["traceEvents"]
    calls = [e for e in events if e.get("cat") == "qpnet_span"
             and e["name"] == "decode.call"]
    assert sorted(e["args"]["B"] for e in calls) == [1, 2]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert sorted(read_wavs(out, expdir["feats"])) == ["utt0", "utt1",
                                                       "utt2"]


def test_cli_host_striding_with_f0_factor(expdir, tmp_path):
    """--n_hosts/--host_id decode disjoint strided shards; in argmax mode
    their union is the single-host output, bit for bit."""
    flags = ("--mode", "argmax", "--f0_factor", "1.5", "--batch_size", "2")
    whole = str(tmp_path / "all" / "feat_id.wav")
    qpnet_decode.main(argv(expdir, whole, *flags))
    parts = str(tmp_path / "hosts")
    for host in ("0", "1"):
        qpnet_decode.main(argv(expdir, parts, *flags, "--n_hosts", "2",
                               "--host_id", host))
    assert sorted(os.listdir(parts)) == ["utt0.wav", "utt1.wav", "utt2.wav"]
    a = read_wavs(whole, expdir["feats"])
    b = read_wavs(os.path.join(parts, "feat_id.wav"), expdir["feats"])
    for fid in a:
        np.testing.assert_array_equal(a[fid], b[fid])


def _library_wavs(e, args_list, **kw):
    """{feat_id: int16 wav} of batch_fast_generate on the CLI's batches."""
    args = qpnet_decode.get_arguments(args_list)
    run_cfg = RunConfig.load(e["config"])
    params = params_from_numpy(load_checkpoint(e["final"])["model"], "cpu")
    out = {}
    for fids, x, h, n_samples, d in qpnet_decode.decode_batches(
            e["feats"], run_cfg, args, load_scaler(e["stats"])):
        rows = batch_fast_generate(params, run_cfg.model, x, h, n_samples, d,
                                   seed=100, device="cpu", **kw)
        for fid, s in zip(fids, rows):
            out[fid] = np.clip(decode_mu_law(s, 256) * 32768, -32768,
                               32767).astype(np.int16)
    return out


@pytest.mark.parametrize("extra", [("--engine", "xla"),
                                   ("--engine", "xla", "--quantize", "w8a8"),
                                   ("--quantize", "int8_weights"),
                                   ("--n_devices", "2")])
def test_cli_rejects_what_is_not_ported(expdir, tmp_path, extra):
    """--n_devices 2 needs two devices of --device's type, and the CPU is
    one (make_mesh's rule; sharded decode on CPU shards:
    tests/test_torch_port_multihost.py); w8a8 is no scheme of the scan
    engine; --engine xla and --quantize int8_weights decode through the
    scan engine, as batch_fast_generate does on the CLI's batches."""
    out = str(tmp_path / "o" / "feat_id.wav")
    if "--n_devices" in extra:
        with pytest.raises(ValueError, match="2 cpu devices requested"):
            qpnet_decode.main(argv(expdir, out, *extra))
        return
    if "w8a8" in extra:
        with pytest.raises(ValueError, match="w8a8"):
            qpnet_decode.main(argv(expdir, out, *extra))
        return
    a = argv(expdir, out, *extra, "--batch_size", "0")
    qpnet_decode.main(a)
    wavs = read_wavs(out, expdir["feats"])
    want = _library_wavs(expdir, a, engine="xla",
                         quantize="int8_weights" if "int8_weights" in extra
                         else "none")
    assert sorted(wavs) == sorted(want)
    for fid in wavs:
        np.testing.assert_array_equal(wavs[fid], want[fid])


def test_cli_f32_scan_matches_library_and_jax_cli(expdir, tmp_path):
    """--engine xla --dtype float32 --mode argmax: the parity mode writes
    what batch_fast_generate(engine="xla", compute_dtype=torch.float32)
    gives, and what the JAX CLI writes with the same argv."""
    from qpnet_tpu.bin import qpnet_decode as jax_decode

    flags = ("--engine", "xla", "--dtype", "float32", "--mode", "argmax",
             "--batch_size", "2")
    out = str(tmp_path / "port" / "feat_id.wav")
    a = argv(expdir, out, *flags)
    qpnet_decode.main(a)
    wavs = read_wavs(out, expdir["feats"])
    want = _library_wavs(expdir, a, mode="argmax", engine="xla",
                         compute_dtype=torch.float32)
    jout = str(tmp_path / "jax" / "feat_id.wav")
    ja = argv(expdir, jout)
    jax_decode.main(ja[:ja.index("--device")] + list(flags))
    jwavs = read_wavs(jout, expdir["feats"])
    assert len(wavs) == 3
    for fid in wavs:
        np.testing.assert_array_equal(wavs[fid], want[fid])
        np.testing.assert_array_equal(wavs[fid], jwavs[fid])
        assert wavs[fid].max() > wavs[fid].min()


def test_cli_decodes_w8a8_through_the_library(expdir, tmp_path):
    """--quantize w8a8 writes what batch_fast_generate(quantize="w8a8")
    gives on the CLI's batches."""
    out = str(tmp_path / "q" / "feat_id.wav")
    flags = ("--quantize", "w8a8", "--batch_size", "0")
    qpnet_decode.main(argv(expdir, out, *flags))
    wavs = read_wavs(out, expdir["feats"])
    args = qpnet_decode.get_arguments(argv(expdir, out, *flags))
    run_cfg = RunConfig.load(expdir["config"])
    params = params_from_numpy(load_checkpoint(expdir["final"])["model"],
                               "cpu")
    (fids, x, h, n_samples, d), = qpnet_decode.decode_batches(
        expdir["feats"], run_cfg, args, load_scaler(expdir["stats"]))
    rows = batch_fast_generate(params, run_cfg.model, x, h, n_samples, d,
                               seed=100, quantize="w8a8", device="cpu")
    for fid, s in zip(fids, rows):
        np.testing.assert_array_equal(
            wavs[fid], np.clip(decode_mu_law(s, 256) * 32768, -32768,
                               32767).astype(np.int16))


@pytest.mark.parametrize("quantize", ["none", "w8a8"])
def test_cli_decodes_a_deep_network_at_full_depth(expdir, tmp_path,
                                                  quantize):
    """A model.conf with the deep layout (fixed dilations to 32, the shape
    of Rd10Rr3Ed4Er1 at a tiny width) decodes every layer: the CLI's wavs
    equal JAX's batch_fast_generate through its kernel (interpret mode) in
    argmax mode, from the same JAX-written checkpoint."""
    from qpnet_tpu.models.generate import batch_fast_generate as jax_bfg

    deep = dict(MODEL, dilationF_depth=6, dilationF_repeat=1)
    cfg = JaxConfig(**deep)
    root = tmp_path / "deep"
    config = str(root / "model.conf")
    JaxRunConfig(model=cfg, fs=FS).save(config)
    params = jax_init_params(jax.random.PRNGKey(3), cfg)
    save_final(str(root), params)
    out = str(tmp_path / "w" / "feat_id.wav")
    a = argv(expdir, out, "--mode", "argmax", "--quantize", quantize,
             "--batch_size", "0")
    a[a.index("--config") + 1] = config
    a[a.index("--checkpoint") + 1] = str(root / "checkpoint-final.pkl")
    qpnet_decode.main(a)
    wavs = read_wavs(out, expdir["feats"])
    args = qpnet_decode.get_arguments(a)
    run_cfg = RunConfig.load(config)
    assert len(run_cfg.model.dilationsF) == 6
    (fids, x, h, n_samples, d), = qpnet_decode.decode_batches(
        expdir["feats"], run_cfg, args, load_scaler(expdir["stats"]))
    want = jax_bfg(params, cfg, x, h, n_samples, d, seed=100, mode="argmax",
                   engine="pallas", quantize=quantize, interpret=True)
    for fid, s in zip(fids, want):
        np.testing.assert_array_equal(
            wavs[fid], np.clip(decode_mu_law(np.asarray(s), 256) * 32768,
                               -32768, 32767).astype(np.int16))


def test_cli_defaults_to_cuda(expdir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    a = argv(expdir, str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="CUDA"):
        qpnet_decode.main(a[:a.index("--device")])


def test_final_checkpoint_loads_exactly(expdir):
    model = load_checkpoint(expdir["final"])["model"]
    flat_t = jax.tree_util.tree_leaves(model)
    flat_j = jax.tree_util.tree_leaves(expdir["params"])
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_array_equal(a, b)


def test_iteration_checkpoint_with_optax_state_loads_without_jax(expdir):
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'optax'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from qpnet_tpu_torch.train import load_checkpoint\n"
        "from qpnet_tpu_torch.models import params_from_numpy, count_params\n"
        f"ck = load_checkpoint({expdir['iter5']!r})\n"
        "p = params_from_numpy(ck['model'], 'cpu')\n"
        "print(ck['iterations'], count_params(p), type(ck['optimizer']).__name__)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr
    n_params = sum(int(np.prod(a.shape))
                   for a in jax.tree_util.tree_leaves(expdir["params"]))
    it, count, _ = res.stdout.split()
    assert (int(it), int(count)) == (5, n_params)
