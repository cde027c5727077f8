"""The port's orchestrators, `runFE` and `runQP`, against the JAX package's
on a miniature rootpath-convention corpus (the run_FE.sh/run_QP.sh flow, as
tests/test_orchestrators.py drives the JAX package's):

  * worker argv: every worker `main` of both packages replaced by a
    recorder; for every step the port hands its worker the JAX package's
    argv, and `--device cpu` after it where the port's CLI has that flag,
    with the same temp lists; the port's CLIs parse what they are given;
  * runFE -1..-4 for real in both packages (host backends): the temp
    lists, h5 features, stats, restored wavs and `pow_f0_dict.yml` bytes
    equal, the noise-shaped wavs within 1 LSB (the port's float64 MLSA
    core against JAX's native one, tests/test_torch_port_feature_cli.py);
  * runQP -1 -2 -5 -3 -4 of the port for real on the CPU on a tiny-depth
    network from the registry, with UPDATE_INTERVAL lowered, decoding one
    0.15 s utterance: JAX's `load_checkpoint` reads its SI and SD
    checkpoints, `yaml.safe_load` its yml files, and the wavs have
    F*up - 1 samples.  (K1's twin sums in a fixed order, slowly at the
    default widths, so the SI training worker is handed narrow widths
    after runQP's argv; the SD update and the decodes read them from
    model.conf);
  * in a process where PyYAML, matplotlib and h5py cannot be imported (as
    on the card's machine), every module of the port imports, and the
    recipe runs runFE -1 and the step-5 best-iteration read.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import yaml
from scipy.io import wavfile

import qpnet_tpu_torch.runFE as t_runFE
import qpnet_tpu_torch.runQP as t_runQP
from qpnet_tpu import config as j_config
from qpnet_tpu import runFE as j_runFE
from qpnet_tpu import runQP as j_runQP
from qpnet_tpu.data import write_txt
from qpnet_tpu_torch import config as t_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 16000
UP = 80                      # samples per 5 ms frame at 16 kHz
SPK = "SPKA"
SECONDS = (0.15, 0.3)
NARROW = ["--n_resch", "16", "--n_skipch", "8"]
TINY = dict(dilationF_depth=2, dilationF_repeat=1, dilationA_depth=2,
            dilationA_repeat=1, kernel_size=2, max_length=4000,
            batch_length=1600, batch_size=1, f0_threshold=0,
            decode_batch_size=2)
WORKERS = ["initialize_speaker", "feature_extract", "calc_stats",
           "noise_shaping", "qpnet_train", "qpnet_update", "qpnet_validate",
           "qpnet_decode", "noise_restored"]
# the port's workers whose CLI takes --device
DEVICE_WORKERS = {"feature_extract", "qpnet_train", "qpnet_update",
                  "qpnet_validate", "qpnet_decode"}
FE = ["--corpus", "MINI", "--n_jobs", "1", "-f", str(FS)]
SI = ["-w", "minitr.scp", "-a", "minitr.scp"]
SD = ["-x", f"minitr_{SPK}.scp", "-u", f"minitr_{SPK}.scp"]
SI_MODEL = "Aminitr_Wminitr_d8_tiny"
SD_MODEL = f"{SI_MODEL}_Uminitr_{SPK}_Vminitr_{SPK}"


def _corpus(root):
    """root/corpus/MINI/{wav,scp,conf} in the reference layout."""
    corpus = os.path.join(root, "corpus", "MINI")
    rng = np.random.default_rng(16)
    rel = []
    for i, secs in enumerate(SECONDS):
        n = int(secs * FS)
        phase = np.cumsum(np.linspace(140, 180, n) / FS)
        x = 0.5 * (2 * (phase % 1.0) - 1.0) + 0.01 * rng.normal(size=n)
        p = os.path.join(corpus, "wav", "train", SPK, f"u{i}.wav")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        wavfile.write(p, FS, (x * 12000).astype(np.int16))
        rel.append(f"rootpath/wav/train/{SPK}/u{i}.wav")
    write_txt(os.path.join(corpus, "scp", f"minitr_{SPK}.scp"), rel)
    write_txt(os.path.join(corpus, "scp", "minitr.scp"), rel)
    write_txt(os.path.join(corpus, "scp", f"minieval_{SPK}.scp"), rel[:1])
    os.makedirs(os.path.join(corpus, "conf"))
    with open(os.path.join(corpus, "conf", "pow_f0_dict.yml"), "w") as f:
        f.write("# hand-curated\nOTHER: {f0_min: 50, f0_max: 300, "
                f"pow_th: -25}}\n{SPK}:\n  f0_min: 60\n  f0_max: 400  # Hz"
                "\n  pow_th: -20\n")
    return corpus


def _files(root, ext):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(ext):
                p = os.path.join(d, n)
                out[os.path.relpath(p, root)] = p
    return out


def _h5_sets(path):
    import h5py
    with h5py.File(path, "r") as f:
        out = {}
        f.visititems(lambda k, v: out.__setitem__(k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
    return out


# --- worker argv ---------------------------------------------------------------

@pytest.fixture
def recorded(tmp_path, monkeypatch):
    """A project with the files the steps check for, and every worker main
    of both packages replaced by a recorder of (worker, argv, temp
    lists)."""
    import importlib
    prj = str(tmp_path)
    corpus = _corpus(prj)
    os.makedirs(os.path.join(corpus, "stats"))
    open(os.path.join(corpus, "stats", "minitr_stats.h5"), "wb").close()
    for d, names in ((SI_MODEL, ["checkpoint-final.pkl", "checkpoint-5.pkl",
                                 "model.conf"]),
                     (SD_MODEL, ["checkpoint-100.pkl", "checkpoint-200.pkl",
                                 "checkpoint-final.pkl", "model.conf"])):
        os.makedirs(os.path.join(prj, "qpnet_models", d))
        for n in names:
            open(os.path.join(prj, "qpnet_models", d, n), "w").close()
    with open(os.path.join(prj, "qpnet_models", SD_MODEL,
                           "validation_result.yml"), "w") as f:
        yaml.safe_dump({"checkpoint-100.pkl": 2.5,
                        "checkpoint-200.pkl": 2.25}, f)
    calls = {"qpnet_tpu": [], "qpnet_tpu_torch": []}
    for pkg, log in calls.items():
        for w in WORKERS:
            mod = importlib.import_module(f"{pkg}.bin.{w}")

            def record(argv, _w=w, _log=log):
                lists = {a: open(a).read() for a in argv
                         if a.endswith(".tmp") and os.path.exists(a)}
                _log.append((_w, list(argv), lists))

            monkeypatch.setattr(mod, "main", record)
    for reg in (j_config._NETWORKS, t_config._NETWORKS):
        monkeypatch.setitem(reg, "tiny", TINY)
    return prj, calls


def _both(calls, fn_j, fn_t, argv):
    """Run one step in each package; returns the calls each made."""
    n_j, n_t = len(calls["qpnet_tpu"]), len(calls["qpnet_tpu_torch"])
    for fn, extra in ((fn_j, []), (fn_t, ["--device", "cpu"])):
        try:
            fn(argv + extra)
        except SystemExit as e:
            assert e.code in (0, None), e.code
    return calls["qpnet_tpu"][n_j:], calls["qpnet_tpu_torch"][n_t:]


FE_STEPS = [["-e", f"minitr_{SPK}.scp", "-1", SPK],
            ["-e", f"minitr_{SPK}.scp", "-r", "-i", "-2", SPK],
            ["-e", f"minitr_{SPK}.scp", "-2", "--dsp_backend", "jax",
             "--f0_backend", "jax", SPK],
            ["-e", "minitr.scp", "-3", "allspk"],
            ["-e", "minitr.scp", "-4", "allspk"]]
QP_STEPS = [
    SI + ["-I", "4", "-1"],
    SI + ["-I", "20000", "-R", "auto", "--dtype", "bfloat16", "-1"],
    SI + ["-I", "4", "-R", "5", "-g", "0", "-1"],
    SI + SD + ["-U", "200", "-2"],
    SI + SD + ["-U", "200", "-R", "auto", "-2"],
    SI + SD + ["-y", f"minitr_{SPK}.scp", "-v", f"minitr_{SPK}.scp",
               "-U", "200", "-5"],
    SI + ["-m", "-e", f"minitr_{SPK}.scp", "-M", "final", "-3", "-4", SPK],
    SI + SD + ["-r", "-e", f"minitr_{SPK}.scp", "-M", "100", "-3", "-4",
               SPK, "--decode_batch_size", "0"],
    SI + ["-m", "-r", "-e", f"minitr_{SPK}.scp", "-F", "1.5", "-3", "-4",
          SPK, "--decode_quantize", "w8a8"],
    SI + ["-m", "-e", f"minitr_{SPK}.scp", "-3", SPK,
          "--decode_quantize", "int8_weights"],
]


@pytest.mark.parametrize("step", range(len(FE_STEPS) + len(QP_STEPS)))
def test_workers_get_the_jax_argv(recorded, step, capsys):
    import importlib
    prj, calls = recorded
    if step < len(FE_STEPS):
        argv = FE_STEPS[step] + FE + ["--prj_dir", prj]
        fns = (j_runFE.main, t_runFE.main)
    else:
        argv = (QP_STEPS[step - len(FE_STEPS)] + FE[:4] + ["-f", str(FS),
                "-n", "tiny", "--prj_dir", prj])
        fns = (j_runQP.main, t_runQP.main)
    conf = os.path.join(prj, "corpus", "MINI", "conf", "pow_f0_dict.yml")
    got_j, got_t = _both(calls, *fns, argv)
    out = capsys.readouterr().out
    assert got_j and len(got_j) == len(got_t)
    for (wj, aj, lj), (wt, at, lt) in zip(got_j, got_t):
        assert wj == wt
        want = aj + (["--device", "cpu"] if wt in DEVICE_WORKERS else [])
        assert at == want, (wt, at, want)
        assert lt == lj and all(lj.values())
        mod = importlib.import_module(f"qpnet_tpu_torch.bin.{wt}")
        if hasattr(mod, "get_arguments"):
            mod.get_arguments(at)
    if "-1" in argv and "-e" in argv:
        with open(conf) as f:
            text = f.read()
        assert text == yaml.safe_dump(yaml.safe_load(text))
    if "-5" in argv:
        assert out.count("best iteration: 200 (loss 2.2500)") == 2
        assert [a[1][a[1].index("--checkpoint") + 1].split("/")[-1]
                for a in got_t] == ["checkpoint-100.pkl",
                                    "checkpoint-200.pkl"]


# --- runFE for real, both packages ------------------------------------------

@pytest.fixture(scope="module")
def fe_prj(tmp_path_factory):
    """runFE -1, -2 (extraction and restoration), -3, -4 of each package on
    copies of one corpus; {package: project dir}."""
    base = str(tmp_path_factory.mktemp("fe"))
    src = os.path.join(base, "src")
    _corpus(src)
    out = {}
    for tag, run in (("jax", j_runFE.main), ("port", t_runFE.main)):
        prj = os.path.join(base, tag)
        shutil.copytree(src, prj)
        extra = ["--device", "cpu"] if tag == "port" else []
        common = FE + ["--prj_dir", prj] + extra
        with pytest.raises(SystemExit) as e:
            run(["-e", f"minitr_{SPK}.scp", "-1", SPK] + common)
        assert e.value.code == 0
        # step 1 leaves its temp lists (the later steps remove theirs)
        tmp = os.path.join(prj, "temp")
        out[tag + " lists"] = {
            n: open(os.path.join(tmp, n)).read().replace(prj, "<prj>")
            for n in sorted(os.listdir(tmp))}
        for step in (["-e", f"minitr_{SPK}.scp", "-i", "-2", SPK],
                     ["-e", f"minitr_{SPK}.scp", "-2", SPK],
                     ["-e", "minitr.scp", "-3", SPK],
                     ["-e", "minitr.scp", "-4", SPK]):
            run(step + common)
        out[tag] = prj
    return out


def test_runfe_files_equal_jax(fe_prj):
    j, t = fe_prj["jax"], fe_prj["port"]
    # step 1's temp lists: the same lines under each project
    assert sorted(fe_prj["jax lists"]) == [f"feat_minitr_{SPK}.tmp",
                                           f"wavs_{SPK}.tmp"]
    assert fe_prj["port lists"] == fe_prj["jax lists"]
    assert os.listdir(os.path.join(j, "temp")) == []
    assert os.listdir(os.path.join(t, "temp")) == []
    for rel in ("corpus/MINI/conf/pow_f0_dict.yml",):
        with open(os.path.join(j, rel), "rb") as a, \
                open(os.path.join(t, rel), "rb") as b:
            assert a.read() == b.read()
    for ext in (".h5", ".png"):
        assert sorted(_files(j, ext)) == sorted(_files(t, ext))
    h5 = _files(j, ".h5")
    assert len(h5) == len(SECONDS) + 1          # features and the stats
    for rel, p in h5.items():
        a, b = _h5_sets(p), _h5_sets(os.path.join(t, rel))
        assert sorted(a) == sorted(b), rel
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), \
                (rel, k)
    wavs_j, wavs_t = _files(j, ".wav"), _files(t, ".wav")
    assert sorted(wavs_j) == sorted(wavs_t)
    kinds = {rel.split("/")[2] for rel in wavs_j}
    assert kinds == {"wav", "h5_restored", "wav_h5_ns"}
    for rel, p in wavs_j.items():
        a = wavfile.read(p)[1].astype(int)
        b = wavfile.read(wavs_t[rel])[1].astype(int)
        assert a.shape == b.shape, rel
        # the host restore (WORLD synthesis) is bit-equal; shaping runs
        # the MLSA filter in each package's own float64 core
        tol = 1 if "wav_h5_ns" in rel else 0
        assert np.abs(a - b).max() <= tol, rel


# --- runQP of the port for real on the CPU ---------------------------------

def test_runqp_stages_on_the_cpu(fe_prj, tmp_path, monkeypatch, capsys):
    from qpnet_tpu.train.checkpoint import load_checkpoint as j_load
    from qpnet_tpu_torch.bin import qpnet_train
    prj = str(tmp_path / "prj")
    shutil.copytree(fe_prj["port"], prj)
    monkeypatch.setitem(t_config._NETWORKS, "tiny", TINY)
    monkeypatch.setattr(t_runQP, "UPDATE_INTERVAL", 2)
    train = qpnet_train.main
    monkeypatch.setattr(qpnet_train, "main",
                        lambda argv: train(argv + NARROW))
    base = FE[:4] + ["-f", str(FS), "-n", "tiny", "--prj_dir", prj,
                     "--device", "cpu"]
    t_runQP.main(SI + ["-I", "2", "-1"] + base)
    t_runQP.main(SI + SD + ["-U", "4", "-2"] + base)
    t_runQP.main(SI + SD + ["-y", f"minitr_{SPK}.scp", "-v",
                            f"minitr_{SPK}.scp", "-U", "4", "-5"] + base)
    out = capsys.readouterr().out
    best = out.split("best iteration: ")[1].split()[0]
    assert best in ("2", "4")
    t_runQP.main(SI + SD + ["-e", f"minieval_{SPK}.scp", "-M", best, "-3",
                            "-4", SPK] + base)
    t_runQP.main(SI + ["-m", "-e", f"minieval_{SPK}.scp", "-3", "-4", SPK]
                 + base)

    models = os.path.join(prj, "qpnet_models")
    si, sd = os.path.join(models, SI_MODEL), os.path.join(models, SD_MODEL)
    assert {"checkpoint-final.pkl", "loss-final.yml",
            "model.conf"} <= set(os.listdir(si))
    assert {"checkpoint-2.pkl", "checkpoint-4.pkl", "checkpoint-final.pkl",
            "model.conf", "validation_result.yml"} <= set(os.listdir(sd))
    for d, name in ((si, "checkpoint-final.pkl"), (sd, "checkpoint-4.pkl"),
                    (sd, "checkpoint-final.pkl")):
        state = j_load(os.path.join(d, name))
        leaves = [np.asarray(v) for v in
                  jax.tree_util.tree_leaves(state["model"])]
        assert leaves and all(np.isfinite(v).all() for v in leaves)
    with open(os.path.join(sd, "validation_result.yml")) as f:
        res = yaml.safe_load(f)
    assert sorted(res) == ["checkpoint-2.pkl", "checkpoint-4.pkl"]
    assert all(np.isfinite(v) for v in res.values())
    assert min(res, key=res.get) == f"checkpoint-{best}.pkl"
    with open(os.path.join(si, "loss-final.yml")) as f:
        assert all(np.isfinite(v) for v in yaml.safe_load(f))
    with open(os.path.join(si, "model.conf")) as a, \
            open(os.path.join(sd, "model.conf")) as b:
        assert a.read() == b.read()

    out_root = os.path.join(prj, "qpnet_output")
    f0 = _h5_sets(os.path.join(prj, "corpus", "MINI", "h5", "train", SPK,
                               "u0.h5"))["f0"]
    for model, it in ((SD_MODEL, best), (SI_MODEL, "final")):
        assert json.load(open(os.path.join(models, model, "model.conf")))[
            "model"]["n_resch"] == 16
        for mode in ("noiseshaped", "restored"):
            d = os.path.join(out_root, model, mode, SPK, it)
            assert os.listdir(d) == ["u0.wav"]
            fs, x = wavfile.read(os.path.join(d, "u0.wav"))
            assert fs == FS and x.dtype == np.int16
            assert x.shape == (len(f0) * UP - 1,), (d, x.shape)
            assert int(x.max()) > int(x.min())


# --- the card's machine: no PyYAML, no matplotlib ------------------------------

NO_YAML = """
import sys
sys.modules["yaml"] = sys.modules["matplotlib"] = sys.modules["h5py"] = None
import contextlib, importlib, io, os, pkgutil
if __name__ == "__main__":
    import qpnet_tpu_torch
    for m in pkgutil.walk_packages(qpnet_tpu_torch.__path__,
                                   "qpnet_tpu_torch."):
        importlib.import_module(m.name)
    from qpnet_tpu_torch import runFE, runQP
    from qpnet_tpu_torch.bin import qpnet_validate
    from qpnet_tpu_torch.utils.yamlconf import read, write_validation_record
    prj, spk = sys.argv[1], sys.argv[2]
    try:
        runFE.main(["-e", "minitr_%s.scp" % spk, "-1", "NEW", "--prj_dir",
                    prj, "--corpus", "MINI", "--n_jobs", "1", "-f",
                    "16000"])
    except SystemExit as e:
        assert e.code == 0, e.code
    conf = read(os.path.join(prj, "corpus/MINI/conf/pow_f0_dict.yml"))
    assert conf["NEW"] == {"f0_min": 40, "f0_max": 800, "pow_th": -30}
    assert os.path.exists(os.path.join(
        prj, "corpus/MINI/hist/NEW_f0histogram.png"))
    sd = os.path.join(prj, "qpnet_models", sys.argv[3])
    os.makedirs(os.path.join(prj, "corpus/MINI/stats"), exist_ok=True)
    open(os.path.join(prj, "corpus/MINI/stats/minitr_stats.h5"), "w").close()
    os.makedirs(sd)
    for it in (100, 200):
        open(os.path.join(sd, "checkpoint-%d.pkl" % it), "w").close()
    write_validation_record(os.path.join(sd, "validation_result.yml"),
                            {"checkpoint-100.pkl": 1.5,
                             "checkpoint-200.pkl": 1.75})
    qpnet_validate.main = lambda argv: None
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runQP.main(["-w", "minitr.scp", "-a", "minitr.scp", "-x",
                    "minitr_%s.scp" % spk, "-u", "minitr_%s.scp" % spk,
                    "-y", "minitr_%s.scp" % spk, "-v", "minitr_%s.scp" % spk,
                    "-U", "200", "-5", "--prj_dir", prj, "--corpus", "MINI",
                    "-f", "16000", "--device", "cpu"])
    print(buf.getvalue())
    assert "best iteration: 100 (loss 1.5000)" in buf.getvalue()
    print("NO_YAML_OK")
"""


def test_recipe_runs_without_pyyaml_matplotlib_and_h5py(tmp_path):
    prj = str(tmp_path / "prj")
    _corpus(prj)
    script = tmp_path / "no_yaml.py"
    script.write_text(NO_YAML)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, str(script), prj, SPK,
                          SD_MODEL.replace("_tiny", "")],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NO_YAML_OK" in res.stdout
