"""The port's feature-pipeline CLIs against the JAX package's on a synthetic
corpus (16 kHz voiced utterances of 0.5 s), and `qpnet_serve
--noise_shaping`.

  * feature_extract with the host backends: every h5 dataset equal to the
    JAX CLI's, dtypes and shapes too, bit for bit;
  * the device backends on the CPU (`--device cpu`): the same schema, the
    F0 within the JAX package's device-vs-host gates (voicing agreement >
    0.85, median |dF0| < 1 Hz, frames voiced in both at least 90% of the
    host's voiced ones), mcep mean |d| < 0.05, codeap max |d| < 0.1 dB of
    the host's;
  * the restore pass: the host backend's wavs equal the JAX CLI's; the
    device backend's F0 within 1 Hz RMSE of the host's, and on
    tests/test_jax_synthesis.py's restore inputs within its gate (MCD at
    most the host's seed-to-seed floor + 0.1 dB).  (On the corpus's
    analyzed features, whose aperiodicity makes the MCD noise-bound, the
    JAX package's own device restore misses that gate as the port's does:
    at 0.5 s, MCD 0.883 and 0.884 dB against a floor of 0.542 dB.)
  * calc_stats bit for bit; noise_shaping and noise_restored int16 within
    1 LSB (the port's float64 core against JAX's native one);
  * the serve CLI with --noise_shaping on the CPU: the argmax stream within
    1 LSB of the JAX server's, and equal to a direct session's samples put
    through one-shot `emphasize`.
"""

import os
import shutil
import socket
import threading
import time

import jax
import numpy as np
import pytest
from scipy.io import wavfile

from qpnet_tpu.bin import calc_stats as j_calc
from qpnet_tpu.bin import feature_extract as j_fe
from qpnet_tpu.bin import noise_restored as j_nr
from qpnet_tpu.bin import noise_shaping as j_ns
from qpnet_tpu.data import h5io as JH
from qpnet_tpu_torch.bin import calc_stats as t_calc
from qpnet_tpu_torch.bin import feature_extract as t_fe
from qpnet_tpu_torch.bin import noise_restored as t_nr
from qpnet_tpu_torch.bin import noise_shaping as t_ns
from qpnet_tpu_torch.data import h5io as TH
from qpnet_tpu_torch.dsp.world import gates
from qpnet_tpu_torch.tools.evaluate import wav_metrics

FS = 16000
SECONDS = (0.5, 0.5, 0.5)
N_UTT = len(SECONDS)
COMMON = ["--fs", str(FS), "--minf0", "60", "--maxf0", "400", "--verbose",
          "0"]


def _h5_sets(path):
    import h5py
    with h5py.File(path, "r") as f:
        out = {}
        f.visititems(lambda k, v: out.__setitem__(k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """N_UTT int16 wavs under <root>/wav, and a list of them."""
    root = tmp_path_factory.mktemp("fecli")
    rng = np.random.default_rng(16)
    (root / "wav").mkdir()
    for i, secs in enumerate(SECONDS):
        x = gates.voiced_utterance(rng, secs, FS)
        wavfile.write(str(root / "wav" / f"u{i}.wav"), FS,
                      np.clip(x, -32768, 32767).astype(np.int16))
    return root


def _copy(corpus, dst):
    shutil.copytree(corpus / "wav", dst / "wav")
    lst = dst / "wav.scp"
    lst.write_text("".join(f"{dst / 'wav' / f'u{i}.wav'}\n"
                           for i in range(N_UTT)))
    return str(lst)


@pytest.fixture(scope="module")
def host_feats(corpus, tmp_path_factory):
    """The port's host extraction (default datasets) of the corpus."""
    dst = tmp_path_factory.mktemp("host")
    lst = _copy(corpus, dst)
    t_fe.main(["--waveforms", lst, "--n_jobs", "1"] + COMMON)
    return dst, lst


@pytest.mark.parametrize("extra", [
    [], ["--f0_analyzer", "dio", "--save_ap", "true", "--save_spc", "true",
         "--save_extended", "true"]])
def test_feature_extract_host_equals_jax_cli(corpus, tmp_path, extra):
    """Every dataset of every file equal, dtypes and shapes included; a
    second run without --overwrite leaves the files as they are."""
    got = {}
    for name, main in (("t", t_fe.main), ("j", j_fe.main)):
        lst = _copy(corpus, tmp_path / name)
        main(["--waveforms", lst, "--n_jobs", "1"] + COMMON + extra)
        got[name] = [_h5_sets(str(tmp_path / name / "h5" / f"u{i}.h5"))
                     for i in range(N_UTT)]
    for t, j in zip(got["t"], got["j"]):
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    h5 = str(tmp_path / "t" / "h5" / "u0.h5")
    before = os.stat(h5).st_mtime_ns
    t_fe.main(["--waveforms", str(tmp_path / "t" / "wav.scp")] + COMMON
              + extra)
    assert os.stat(h5).st_mtime_ns == before


@pytest.mark.parametrize("backends,n_jobs", [(("jax", "jax"), 1),
                                             (("jax", "host"), 2)])
def test_feature_extract_device_backends_on_cpu(host_feats, corpus,
                                                tmp_path, backends, n_jobs):
    """--dsp_backend jax (fused with --f0_backend jax; staged with the host
    F0 in a thread pool of 2) on the CPU: the host files' schema, and the
    JAX package's device-vs-host gates."""
    host_dir, _ = host_feats
    lst = _copy(corpus, tmp_path)
    t_fe.main(["--waveforms", lst, "--dsp_backend", backends[0],
               "--f0_backend", backends[1], "--device", "cpu", "--n_jobs",
               str(n_jobs)] + COMMON)
    for i in range(N_UTT):
        h = _h5_sets(str(host_dir / "h5" / f"u{i}.h5"))
        d = _h5_sets(str(tmp_path / "h5" / f"u{i}.h5"))
        # /vad_idx's length follows the frames' power: only its rank counts
        assert {k: (v.dtype, v.ndim if k == "vad_idx" else v.shape)
                for k, v in h.items()} == \
            {k: (v.dtype, v.ndim if k == "vad_idx" else v.shape)
             for k, v in d.items()}
        f0h, f0d = h["f0"], d["f0"]
        if backends[1] == "host":
            np.testing.assert_array_equal(f0d, f0h)
        vd, vh = f0d > 0, f0h > 0
        both = vd & vh
        # the utterances are 40% voiced (silence and a noise burst around
        # two voiced spans): both must share 90% of the host's voiced frames
        assert (vd == vh).mean() > 0.85 and both.sum() > 0.9 * vh.sum()
        assert np.median(np.abs(f0d - f0h)[both]) < 1.0
        # world = [uv, contF0, mcep (35), codeap]; compare on frames whose
        # voicing agrees (the host F0 drives both spectral stages there)
        same = vd == vh
        mc = np.abs(d["world"][same, 2:37] - h["world"][same, 2:37])
        assert mc.mean() < gates.MCEP_MEAN_MAX, mc.mean()
        if backends[1] == "host":
            ca = np.abs(d["world"][:, 37:] - h["world"][:, 37:])
            assert ca.max() < gates.CODEAP_MAX_DB, ca.max()


def test_device_backend_raises_without_a_card(corpus, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    lst = _copy(corpus, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_fe.main(["--waveforms", lst, "--dsp_backend", "jax", "--f0_backend",
                   "jax"] + COMMON)


def _restore(root, main, backend, args=()):
    """Restore every feature file under <root>/h5 into <root>/h5_restored
    (the feature files' wav names list under <root>/wav)."""
    main(["--waveforms", str(root / "wav"), "--inv", "false",
          "--dsp_backend", backend, "--n_jobs", "1"] + COMMON
         + (["--device", "cpu"] if backend == "jax" else []) + list(args))
    return [wavfile.read(str(p)) for p in
            sorted((root / "h5_restored").glob("*.wav"))]


def test_restore_pass_both_backends(host_feats, tmp_path):
    """--inv false from the corpus features: the host backend's wavs equal
    the JAX CLI's; the device backend's (on the CPU) are as long, and their
    F0 within 1 Hz RMSE of the host's."""
    host_dir, _ = host_feats
    outs = {}
    for name, main, backend in (("t", t_fe.main, "numpy"),
                                ("j", j_fe.main, "numpy"),
                                ("d", t_fe.main, "jax")):
        root = tmp_path / name
        shutil.copytree(host_dir / "wav", root / "wav")
        shutil.copytree(host_dir / "h5", root / "h5")
        # one coded-aperiodicity band at 16 kHz (the argv's default, -2,
        # is the two bands of 22,050 Hz)
        outs[name] = _restore(root, main, backend, ["--ap_dim_idx", "-1"])
    assert len(outs["t"]) == N_UTT
    for (ft, t), (fj, j), (fd, d) in zip(outs["t"], outs["j"], outs["d"]):
        assert ft == fj == fd == FS and t.dtype == d.dtype == np.int16
        np.testing.assert_array_equal(t, j)
        assert d.shape == t.shape
    m = wav_metrics(outs["t"][0][1].astype(np.float64),
                          outs["d"][0][1].astype(np.float64), FS, minf0=60,
                          maxf0=400)
    assert m["f0_rmse_hz"] < gates.RESTORE_F0_RMSE_HZ, m


def test_restore_pass_device_within_jax_gate(tmp_path):
    """tests/test_jax_synthesis.py:140-186 through the port's CLI: the
    device restore's MCD against the host restore at most the host's
    seed-to-seed floor + 0.1 dB, F0 RMSE < 1 Hz (22,050 Hz, 120 frames)."""
    fs = 22050
    sets = gates.restore_features(120, fs)
    outs = {}
    for backend in ("numpy", "jax"):
        root = tmp_path / backend
        (root / "wav").mkdir(parents=True)
        wavfile.write(str(root / "wav" / "u1.wav"), fs,
                      np.zeros(int(120 * 5.0 / 1000 * fs), np.int16))
        for k, v in sets.items():
            TH.write_hdf5(str(root / "h5" / "u1.h5"), k, v)
        outs[backend] = _restore(root, t_fe.main, backend,
                                 ["--fs", str(fs)])[0][1].astype(np.float64)
    kw = dict(minf0=60, maxf0=400)
    floor = gates.restore_floor(sets["/world"], sets["/f0"], fs, **kw)
    m = wav_metrics(outs["numpy"], outs["jax"], fs, **kw)
    assert m["mcd_db"] <= floor["mcd_db"] + gates.RESTORE_MCD_MARGIN_DB, \
        (m, floor)
    assert m["f0_rmse_hz"] < gates.RESTORE_F0_RMSE_HZ, m


def test_stats_shaping_and_restoration_clis(host_feats, tmp_path):
    """calc_stats: the stats files equal; noise_shaping (scp list and
    directory) and noise_restored (feat_id templates, its own defaults):
    int16 within 1 LSB of the JAX CLIs'."""
    host_dir, lst = host_feats
    feats = tmp_path / "feats.scp"
    feats.write_text("".join(f"{host_dir / 'h5' / f'u{i}.h5'}\n"
                             for i in range(N_UTT)))
    for name, main in (("t", t_calc.main), ("j", j_calc.main)):
        main(["--features", str(feats), "--stats",
              str(tmp_path / f"{name}.h5"), "--verbose", "0"])
    for k in ("/world/mean", "/world/scale"):
        np.testing.assert_array_equal(TH.read_hdf5(str(tmp_path / "t.h5"), k),
                                      JH.read_hdf5(str(tmp_path / "j.h5"), k))
    stats = str(tmp_path / "t.h5")
    for i, (name, main) in enumerate((("t", t_ns.main), ("j", j_ns.main))):
        src = lst if i == 0 else str(host_dir / "wav")
        main(["--waveforms", src, "--stats", stats, "--fs", str(FS),
              "--wavtype", f"ns{name}", "--n_jobs", "1", "--verbose", "0"])
    for u in range(N_UTT):
        (f1, a), (f2, b) = (wavfile.read(str(host_dir / f"wav_h5_ns{n}" /
                                             f"u{u}.wav")) for n in "tj")
        assert f1 == f2 == FS and a.dtype == b.dtype == np.int16
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert t_nr.get_arguments(["--feats", "f", "--stats", "s", "--outdir",
                               "o", "--writedir", "w"]).__dict__ == \
        j_nr.get_arguments(["--feats", "f", "--stats", "s", "--outdir", "o",
                            "--writedir", "w"]).__dict__
    for name, main in (("t", t_nr.main), ("j", j_nr.main)):
        main(["--feats", str(feats), "--stats", stats,
              "--outdir", str(host_dir / "wav_h5_nst" / "feat_id.wav"),
              "--writedir", str(tmp_path / f"res_{name}" / "feat_id.wav"),
              "--mcep_dim_end", "37", "--mcep_alpha", "0.455",
              "--n_jobs", "1", "--verbose", "0"])
    for u in range(N_UTT):
        a, b = (wavfile.read(str(tmp_path / f"res_{n}" / f"u{u}.wav"))[1]
                for n in "tj")
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


TINY = dict(n_quantize=32, n_aux=39, n_resch=16, n_skipch=8,
            dilationF_depth=2, dilationF_repeat=2,
            dilationA_depth=2, dilationA_repeat=1,
            kernel_size=2, upsampling_factor=5)


def _free_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _stream(request_stream, port, feats):
    deadline = time.time() + 60
    while True:
        try:
            return np.concatenate(list(request_stream(("127.0.0.1", port),
                                                      feats)))
        except ConnectionRefusedError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)


def test_serve_noise_shaping_on_the_cpu(tmp_path):
    """Both packages' serve CLIs with --noise_shaping, argmax, from the
    same JAX-written files: PCM within 1 LSB of each other; the port's
    equal to a direct service's samples through one-shot emphasize."""
    from qpnet_tpu import serve as jserve
    from qpnet_tpu.bin import qpnet_serve as j_serve
    from qpnet_tpu.config import ModelConfig as JaxConfig
    from qpnet_tpu.config import RunConfig as JaxRunConfig
    from qpnet_tpu.models import init_params as jax_init_params
    from qpnet_tpu.train.checkpoint import save_final
    from qpnet_tpu_torch import serve as tserve
    from qpnet_tpu_torch.bin import qpnet_serve as t_serve
    from qpnet_tpu_torch.config import ModelConfig
    from qpnet_tpu_torch.data.stats import load_scaler
    from qpnet_tpu_torch.dsp.emphasis import emphasis_coefs, emphasize
    from qpnet_tpu_torch.models import qpnet as TQ

    cfg_j, cfg = JaxConfig(**TINY), ModelConfig(**TINY)
    pj = jax_init_params(jax.random.PRNGKey(0), cfg_j)
    save_final(str(tmp_path), pj)
    conf = str(tmp_path / "model.conf")
    JaxRunConfig(model=cfg_j, fs=1000).save(conf)
    rng = np.random.default_rng(8)
    stats = str(tmp_path / "stats.h5")
    JH.write_hdf5(stats, "/world/mean", rng.normal(size=39) * 0.3)
    JH.write_hdf5(stats, "/world/scale", rng.uniform(0.5, 2.0, 39))
    F = 9
    feats = np.abs(rng.normal(size=(F, 39)))
    feats[:, 1] = 60.0                             # d = 1000 / 480 < 4
    got = {}
    for name, main, extra in (("t", t_serve.main, ["--device", "cpu"]),
                              ("j", j_serve.main, ["--interpret"])):
        port = _free_port()
        argv = ["--config", conf, "--stats", stats,
                "--checkpoint", str(tmp_path / "checkpoint-final.pkl"),
                "--host", "127.0.0.1", "--port", str(port), "--fs", "1000",
                "--maxd", "4", "--max_streams", "2", "--chunk_samples", "15",
                "--mode", "argmax", "--gather_window_ms", "20",
                "--noise_shaping", "--verbose", "0"] + extra
        threading.Thread(target=main, daemon=True, args=(argv,)).start()
        got[name] = _stream((tserve if name == "t" else jserve)
                            .request_stream, port, feats)
    assert got["t"].dtype == got["j"].dtype == np.int16
    assert got["t"].shape == (F * 5,)
    assert np.abs(got["t"].astype(int) - got["j"].astype(int)).max() <= 1

    args = t_serve.get_arguments(argv)
    svc = tserve.StreamingService(
        TQ.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu"),
        cfg, maxd=4, mode="argmax", min_chunk_samples=15, devices=["cpu"],
        frontend=t_serve.make_frontend(load_scaler(stats), args, cfg))
    try:
        samples = svc.submit_raw(feats).samples()
    finally:
        svc.close()
    coefs = emphasis_coefs(stats, "world", 2, 27, 0.5, invert=False)
    wav = emphasize(tserve.decode_mu_law(samples, cfg.n_quantize), 1000,
                    coefs,
                    0.41, 5.0)
    np.testing.assert_array_equal(
        got["t"], np.clip(wav * 32768, -32768, 32767).astype("<i2"))
