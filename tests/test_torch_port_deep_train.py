"""PyTorch port vs the JAX package: deep-net training
(`qpnet_tpu_torch/tools/deep_train_smoke.py`, the port of the root
`tools/deep_train_smoke.py`) and K2's twin at the deep net's dilations.

The tool's in-memory corpus cuts the windows JAX's `train_window_generator`
cuts from `tests/helpers.py::make_synthetic_corpus`'s files, bit for bit;
its loop at a tiny width follows JAX's `make_train_step` on those batches;
its JSON carries the JAX tool's keys and its exit code is the loss gate.
K2's plain twins are held against JAX's Pallas kernels in interpret mode
with fixed dilations past 128 rows (up to 256, two of the CUDA kernel's
128-row tiles back).  The CUDA kernels themselves are held at the full
deep geometry by chip_smoke.py (phase 19).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qpnet_tpu.config import ModelConfig as JaxConfig
from qpnet_tpu.data.batcher import \
    train_window_generator as jax_train_window_generator
from qpnet_tpu.models import init_params as jax_init_params
from qpnet_tpu.ops import train_kernel as JTK
from qpnet_tpu.train.step import TrainState as JaxTrainState
from qpnet_tpu.train.step import make_train_step as jax_make_train_step
from qpnet_tpu_torch.config import ModelConfig
from qpnet_tpu_torch.ops import train_kernel as TK
from qpnet_tpu_torch.tools import deep_train_smoke as DT

from helpers import make_synthetic_corpus

TINY = dict(n_quantize=32, n_aux=4, n_resch=16, n_skipch=8,
            dilationF_depth=3, dilationF_repeat=1,
            dilationA_depth=2, dilationA_repeat=1, upsampling_factor=10)
# a tiny corpus and its windows: fs 1000, up 10
CORPUS = dict(n_utts=4, fs=1000, up=10, n_aux=4, seconds=1.0, f0_lo=50.0,
              f0_hi=120.0, seed=7)
BATCH_LENGTH, MAX_LENGTH = 200, 300


def jax_windows(tmp_path, cfg_j, corpus, batch_length, max_length, n):
    wavs, feats = make_synthetic_corpus(str(tmp_path), **corpus)
    gen = jax_train_window_generator(wavs, feats, cfg_j,
                                     batch_length=batch_length, batch_size=1,
                                     max_length=max_length, seed=1)
    return [next(gen) for _ in range(n)]


@pytest.mark.parametrize("case", ["tiny", "registry"])
def test_corpus_windows_equal_jax(tmp_path, case):
    """The tool's windows are the JAX tool's, bit for bit: a tiny fs and
    up, and the registry's deep net at 22,050 Hz with its windows."""
    if case == "tiny":
        cfg_j, cfg = JaxConfig(**TINY), ModelConfig(**TINY)
        corpus, bl, ml, n = CORPUS, BATCH_LENGTH, MAX_LENGTH, 12
    else:
        cfg_j = JaxConfig.from_network_name(DT.NETWORK)
        cfg, bl, ml, _ = DT.registry_geometry()
        corpus = dict(CORPUS, n_utts=6, fs=22050, up=110, n_aux=39,
                      seconds=1.5)
        n = 4
    ref = jax_windows(tmp_path, cfg_j, corpus, bl, ml, n)
    mine = DT.window_stream(cfg, DT.synthetic_utterances(**corpus), bl, ml)
    for i, r in enumerate(ref):
        got = next(mine)
        for k in ("x", "h", "t", "d", "valid_len", "window_lens"):
            np.testing.assert_array_equal(got[k], np.asarray(r[k]),
                                          err_msg=f"window {i} {k}")


@pytest.mark.parametrize("engine", ["auto", "pallas"])
def test_tool_loop_matches_jax_train_step(tmp_path, engine):
    """5 f32 steps of the tool's loop at a tiny width, from JAX's
    init_params carried across, against JAX's make_train_step on the JAX
    tool's batches: losses within rtol 2e-5.  "pallas" runs K2's twin."""
    cfg_j, cfg = JaxConfig(**TINY), ModelConfig(**TINY)
    pnp = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0), cfg_j))
    # the JAX step donates its state: it gets its own copy
    pj = jax.tree_util.tree_map(jnp.array, pnp)
    batches = jax_windows(tmp_path, cfg_j, CORPUS, BATCH_LENGTH, MAX_LENGTH,
                          5)
    tx = optax.adam(1e-3)
    step = jax_make_train_step(cfg_j, tx, compute_dtype=jnp.float32,
                               remat=True)
    state = JaxTrainState(pj, tx.init(pj), 0)
    ref = []
    for b in batches:
        b = {k: v for k, v in b.items() if k != "window_lens"}
        state, loss = step(state, b)
        ref.append(float(loss))
    out = DT.train_run(cfg, 5, "float32", remat=True, lr=1e-3, device="cpu",
                       fixed_engine=engine, batch_length=BATCH_LENGTH,
                       max_length=MAX_LENGTH,
                       utts=DT.synthetic_utterances(**CORPUS),
                       params=pnp,
                       log=lambda msg: None)
    np.testing.assert_allclose(out["losses"], ref, rtol=2e-5)
    assert out["fixed_engine"] == ("xla" if engine == "auto" else "pallas")
    # on the CPU the wrappers run the twins: no kernel launch is counted
    assert out["k2_launches"] == [0, 0] and out["device"] == "cpu"


JAX_KEYS = {"network", "params_m", "dtype", "remat", "iters",
            "ms_per_step_median", "compile_s", "loss_first50_mean",
            "loss_last50_mean", "loss_decreased"}


def test_tool_json_and_loss_gate(monkeypatch, capsys, tmp_path):
    """main prints the JAX tool's keys plus device, fixed_engine and card,
    writes --json, and exits 1 unless the last 50 iterations' mean loss is
    below the first 50's (5 iterations: the same window, so 1)."""
    cfg = ModelConfig(**TINY)
    monkeypatch.setattr(DT, "registry_geometry",
                        lambda: (cfg, BATCH_LENGTH, MAX_LENGTH, 1))
    real = DT.synthetic_utterances
    monkeypatch.setattr(DT, "synthetic_utterances",
                        lambda **kw: real(**CORPUS))
    runs = {}
    for iters, lr in ((5, 1e-4), (60, 5e-3)):
        path = tmp_path / f"{iters}.json"
        rc = DT.main(["--iters", str(iters), "--lr", str(lr), "--device",
                      "cpu", "--dtype", "float32", "--json", str(path)])
        line = capsys.readouterr().out.strip().splitlines()[-1]
        out = json.loads(line)
        assert out == json.loads(path.read_text())
        assert JAX_KEYS | {"device", "fixed_engine", "card"} <= set(out)
        assert out["network"] == DT.NETWORK and out["iters"] == iters
        assert out["device"] == "cpu" and out["card"] is None
        assert out["fixed_engine"] == "xla" and out["remat"] is True
        runs[iters] = (rc, out)
    rc, out = runs[5]
    assert out["loss_first50_mean"] == out["loss_last50_mean"]
    assert rc == 1 and out["loss_decreased"] is False
    rc, out = runs[60]
    assert out["loss_last50_mean"] < out["loss_first50_mean"]
    assert rc == 0 and out["loss_decreased"] is True


def test_tool_has_no_cpu_fallback(monkeypatch):
    """The tool runs on the card unless asked for the CPU: without one it
    raises, it does not fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        DT.train_run(ModelConfig(**TINY), 1, device="cuda",
                     utts=DT.synthetic_utterances(**CORPUS))


# --- K2's twin at dilations past a CUDA tile --------------------------------

R, S, UP = 16, 8, 4
DILS_F = tuple(2 ** i for i in range(9))        # 1 .. 256
DILS_A = (1, 2)


@pytest.fixture
def deep_tile(monkeypatch):
    # JAX's time tile must hold the largest fixed dilation (its carry):
    # 264 rows, more than two of the CUDA kernel's 128-row tiles
    monkeypatch.setattr(JTK, "TILE", 264)


def stack_case(seed, B, T, fused, maxd, d_range):
    rng = np.random.default_rng(seed)
    L = len(DILS_F) + (len(DILS_A) if fused else 0)
    w = {
        "W_in": rng.normal(size=(L, 2 * R, 2 * R)) / np.sqrt(2 * R),
        "W_aux": rng.normal(size=(L, TK.AUX_PAD, 2 * R)) / np.sqrt(8),
        "b_gate": 0.1 * rng.normal(size=(L, 2 * R)),
        "W_out": rng.normal(size=(L, R, S + R)) / np.sqrt(2 * R),
        "b_res": 0.1 * rng.normal(size=(L, R)),
    }
    w = {k: v.astype(np.float32) for k, v in w.items()}
    o0 = rng.normal(size=(B, T, R)).astype(np.float32)
    h = np.zeros((B, T, TK.AUX_PAD), np.float32)
    h[..., :5] = rng.normal(size=(B, T, 5))
    d = rng.uniform(*d_range, size=(B, -(-T // UP))).astype(np.float32)
    static = (DILS_F, DILS_A if fused else (), maxd if fused else 1, UP, R,
              S)
    return w, o0, h, d, static


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max(), 1e-8)


@pytest.mark.parametrize("fused", [False, True], ids=["fixed", "fused"])
def test_twin_matches_pallas_past_a_tile(deep_tile, fused):
    """Forward and VJP of K2's f32 twins against JAX's fixed_stack_fused
    in interpret mode, T = 528 (two JAX tiles, whose public call takes
    whole tiles), fixed dilations 1-256, and with the adaptive layers
    fused at look-backs up to 120 rows: every output and gradient within
    2e-5 of scale."""
    B, T = 1, 528
    w, o0, h, d, static = stack_case(11, B, T, fused, 64, (30.0, 60.0))
    rng = np.random.default_rng(12)
    do = rng.normal(size=(B, T, R)).astype(np.float32)
    dskip = rng.normal(size=(B, T, S)).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jd = jnp.asarray(d) if fused else None

    def f(weights, o0_, h_):
        return JTK.fixed_stack_fused(static, "float32", True, weights, o0_,
                                     h_, jd)

    (jo, jskip), vjp = jax.vjp(f, jw, jnp.asarray(o0), jnp.asarray(h))
    jdw, jdo0, jdh = vjp((jnp.asarray(do), jnp.asarray(dskip)))

    W = {k: torch.from_numpy(v) for k, v in w.items()}
    td = torch.from_numpy(d) if fused else None
    o_out, skip, oall, st = TK.stack_forward(static, torch.float32, W,
                                             torch.from_numpy(o0),
                                             torch.from_numpy(h), td)
    assert _rel(jo, o_out.numpy()) < 2e-5
    assert _rel(jskip, skip.numpy()) < 2e-5
    do0, dh, dW = TK.stack_backward(static, torch.float32, W, oall, st,
                                    torch.from_numpy(h), td,
                                    torch.from_numpy(do),
                                    torch.from_numpy(dskip))
    assert _rel(jdo0, do0.numpy()) < 2e-5
    assert _rel(jdh, dh.numpy()) < 2e-5
    for k in TK._WEIGHT_KEYS:
        assert _rel(jdw[k], dW[k].numpy()) < 2e-5, k
