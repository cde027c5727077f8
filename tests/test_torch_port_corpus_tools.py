"""The port's corpus tools against the JAX package's:

  * `tools/make_synth_corpus`: wavs, scp lists and conf bytes equal for one
    seed;
  * `bin/make_corpus_lists` (scan with --make_conf, and --vcc18_assets):
    every file's bytes equal;
  * `bin/initialize_speaker`, inline and spawned: the pooled F0 and power
    bit-equal to the JAX worker's, the densities drawn equal to
    `np.histogram(..., bins=200, density=True)`, the PNGs valid (read by
    matplotlib's `imread`);
  * `tools/evaluate`: the CLI's JSON and `evaluate_pairs` equal to JAX's;
  * `utils/yamlconf`: `dump` gives `yaml.safe_dump`'s bytes and `load`
    reads what `safe_load` reads (a hypothesis test over speaker dicts),
    hand-edited flow mappings and comments read, anything else raises;
  * the recipe scripts: `bash -n`, then each port script and its JAX
    counterpart under one stub `python` that records its argv: the same
    modules and argv, apart from the package name and --device.
"""

import json
import os
import stat
import subprocess

import numpy as np
import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy.io import wavfile

from qpnet_tpu.bin import initialize_speaker as j_init
from qpnet_tpu.bin import make_corpus_lists as j_lists
from qpnet_tpu.tools import evaluate as j_eval
from qpnet_tpu.tools import make_synth_corpus as j_synth
from qpnet_tpu_torch.bin import initialize_speaker as t_init
from qpnet_tpu_torch.bin import make_corpus_lists as t_lists
from qpnet_tpu_torch.tools import evaluate as t_eval
from qpnet_tpu_torch.tools import make_synth_corpus as t_synth
from qpnet_tpu_torch.utils import yamlconf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 16000


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _wavs(root, n=3, seed=0, noise=0.01):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        m = int(0.4 * FS)
        ph = np.cumsum(np.full(m, 150.0 + 10 * i) / FS)
        x = 0.5 * (2 * (ph % 1.0) - 1.0) + noise * rng.normal(size=m)
        p = os.path.join(root, f"u{i}.wav")
        wavfile.write(p, FS, (x * 12000).astype(np.int16))
        paths.append(p)
    return paths


def test_make_synth_corpus_equals_jax(tmp_path, capsys):
    argv = ["--fs", str(FS), "--speakers", "2", "--train_utts", "2",
            "--update_utts", "1", "--valid_utts", "1", "--eval_utts", "1",
            "--seconds", "0.4", "--seed", "3"]
    j_synth.main(["--corpus_dir", str(tmp_path / "j")] + argv)
    j_out = capsys.readouterr().out
    t_synth.main(["--corpus_dir", str(tmp_path / "t")] + argv)
    t_out = capsys.readouterr().out
    j, t = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert sorted(j) == sorted(t)
    assert sum(k.endswith(".wav") for k in j) == 10
    assert sum(k.endswith(".scp") for k in j) == 12
    for k in j:
        assert j[k] == t[k], k
    assert j_out.replace(str(tmp_path / "j"), "") == \
        t_out.replace(str(tmp_path / "t"), "")


def test_make_corpus_lists_equals_jax(tmp_path):
    for pkg in ("j", "t"):
        corpus = tmp_path / pkg / "corpus"
        for spk in ("SPKA", "VCC2SF1", "yes"):
            _wavs(str(corpus / "wav" / "train" / spk), n=2)
        # a hand-edited conf the scan extends: a comment, a flow mapping
        (corpus / "conf").mkdir()
        (corpus / "conf" / "pow_f0_dict.yml").write_text(
            "# curated by hand\nSPKA: {f0_min: 70, f0_max: 300, "
            "pow_th: -25.5}  # from the histogram\n")
    argv = ["--subset", "train", "--prefix", "minitr", "--make_conf"]
    j_lists.main(["--corpus_dir", str(tmp_path / "j" / "corpus")] + argv)
    t_lists.main(["--corpus_dir", str(tmp_path / "t" / "corpus")] + argv)
    j_lists.main(["--corpus_dir", str(tmp_path / "j" / "vcc"),
                  "--vcc18_assets"])
    t_lists.main(["--corpus_dir", str(tmp_path / "t" / "vcc"),
                  "--vcc18_assets"])
    j, t = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert sorted(j) == sorted(t)
    for k in j:
        assert j[k] == t[k], k
    conf = yaml.safe_load(j["corpus/conf/pow_f0_dict.yml"])
    assert conf["SPKA"]["pow_th"] == -25.5
    assert conf["VCC2SF1"] == t_lists.VCC2018_POW_F0["VCC2SF1"]
    assert sum(k.startswith("vcc/scp/") for k in j) == 43


@pytest.fixture(scope="module")
def speaker_wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spk")
    paths = _wavs(str(root / "wav"))
    scp = str(root / "wavs.scp")
    with open(scp, "w") as f:
        f.write("\n".join(paths) + "\n")
    f0, npow = {}, {}
    j_init.world_feature_extract(paths, 0, f0, npow)
    return dict(root=root, paths=paths, scp=scp, f0=f0[0], npow=npow[0])


@pytest.mark.parametrize("n_jobs", [1, 2])
def test_initialize_speaker_equals_jax(speaker_wavs, tmp_path, monkeypatch,
                                       n_jobs):
    """Inline and through spawned workers: the pooled F0 and power the
    port draws equal the JAX worker's bit for bit, and each PNG shows the
    densities np.histogram gives."""
    import matplotlib.image as mpimg

    drawn = {}
    create = t_init.create_histogram

    def spy(data, path, **kw):
        drawn[os.path.basename(path)] = (np.array(data),
                                         create(data, path, **kw), kw)
        return drawn[os.path.basename(path)][1]

    monkeypatch.setattr(t_init, "create_histogram", spy)
    t_init.main(["--speaker", "SPK", "--waveforms", speaker_wavs["scp"],
                 "--figure_dir", str(tmp_path / "hist"), "--n_jobs",
                 str(n_jobs), "--verbose", "0"])
    assert sorted(drawn) == ["SPK_f0histogram.png", "SPK_npowhistogram.png"]
    for name, want in (("SPK_f0histogram.png", speaker_wavs["f0"]),
                       ("SPK_npowhistogram.png", speaker_wavs["npow"])):
        data, dens, kw = drawn[name]
        assert data.dtype == want.dtype and np.array_equal(data, want)
        ref, _ = np.histogram(want, bins=200, density=True,
                              range=(kw["range_min"], kw["range_max"]))
        assert np.array_equal(dens, ref)
        img = mpimg.imread(str(tmp_path / "hist" / name))
        assert img.shape == (t_init.HEIGHT, t_init.WIDTH, 3)
        # the tallest bar reaches the top 5% of the plot area in the bar
        # colour; the rest of the plot area is white or bar
        area = img[t_init.Y0 + 1:t_init.Y1, t_init.X0 + 1:t_init.X1]
        bar = np.all(np.abs(area * 255 - t_init.BAR) < 0.5, axis=-1)
        white = np.all(area == 1.0, axis=-1)
        assert (bar | white).all() and bar.any()
        top = np.argmax(bar.any(axis=1))
        assert top <= 0.06 * (t_init.Y1 - t_init.Y0)
    assert 140 < np.median(drawn["SPK_f0histogram.png"][0]) < 175


def test_histogram_of_nothing_draws_no_bar(tmp_path):
    import matplotlib.image as mpimg
    with np.errstate(invalid="ignore"):
        dens = t_init.create_histogram(np.zeros(0), str(tmp_path / "e.png"))
    assert dens.shape == (200,) and np.isnan(dens).all()
    img = mpimg.imread(str(tmp_path / "e.png"))
    area = img[t_init.Y0 + 1:t_init.Y1, t_init.X0 + 1:t_init.X1]
    assert (area == 1.0).all()


def test_evaluate_cli_and_pairs_equal_jax(speaker_wavs, tmp_path, capsys):
    gen = _wavs(str(tmp_path / "gen"), seed=5, noise=0.05)
    kw = dict(mcep_dim=24, alpha=0.41, minf0=60.0, maxf0=400.0)
    want = j_eval.evaluate_pairs(speaker_wavs["paths"], gen, **kw)
    got = t_eval.evaluate_pairs(speaker_wavs["paths"], gen, **kw)
    assert json.dumps(got) == json.dumps(want)
    assert want["n_utterances"] == 3 and 0 < want["mcd_db_mean"] < 20
    argv = ["--ref_wavs", speaker_wavs["scp"], "--gen_wavs",
            str(tmp_path / "gen"), "--mcep_dim", "24", "--mcep_alpha",
            "0.41", "--minf0", "60", "--maxf0", "400"]
    j_eval.main(argv)
    j_out = capsys.readouterr().out
    t_eval.main(argv)
    assert capsys.readouterr().out == j_out
    assert json.loads(j_out)["n_utterances"] == 3


# --- yamlconf ---------------------------------------------------------------

_SPEAKER = st.from_regex(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,11}", fullmatch=True)
_NUMBER = st.one_of(st.integers(-10 ** 6, 10 ** 6),
                    st.floats(allow_nan=False, width=64))


@settings(max_examples=150, deadline=None)
@given(st.dictionaries(_SPEAKER, st.fixed_dictionaries(
    {"f0_min": _NUMBER, "f0_max": _NUMBER, "pow_th": _NUMBER}),
    max_size=5))
def test_yamlconf_round_trips_speaker_dicts(conf):
    text = yamlconf.dump(conf)
    assert text == yaml.safe_dump(conf)
    assert yamlconf.load(text) == yaml.safe_load(text) == conf


def test_yamlconf_files_read_and_written(tmp_path):
    path = str(tmp_path / "c.yml")
    conf = {"SYN1": {"f0_min": 57, "f0_max": 152, "pow_th": -40},
            "yes": {"f0_min": 1.5e-20, "f0_max": float("inf"),
                    "pow_th": -0.0}, "1": {}, "2020-01-01": {"a": 1}}
    yamlconf.write(path, conf)
    with open(path) as f:
        text = f.read()
    assert text == yaml.safe_dump(conf)
    assert yamlconf.read(path) == conf
    assert yamlconf.dump({}) == yaml.safe_dump({}) == "{}\n"


@pytest.mark.parametrize("text", [
    "# a speaker by hand\nSPK:   # its ranges\n  f0_min: 40 # Hz\n"
    "  f0_max: 800\n  pow_th: -30\n",
    "{SPK: {f0_min: 40, f0_max: 800, pow_th: -30}}  # all in one\n",
    "SPK: {f0_min: 40,\n       f0_max: 8.0e+2, pow_th: -3.0e+1}\n",
    "  SPK:\n      f0_min: 010\n      f0_max: 0x1F\n      pow_th: -1_0\n",
    "'SPK A': {f0_min: .inf, f0_max: -.Inf, pow_th: 1:30}\n\"B\": {x: 1,}\n",
    "checkpoint-100.pkl: 2.5\nit's.pkl: 3.0\n'1000': -1.0\n'a: b': .nan\n",
    "{}\n", "", "# only a comment\n",
])
def test_yamlconf_reads_what_safe_load_reads(text):
    got, want = yamlconf.load(text), yaml.safe_load(text) or {}
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


@pytest.mark.parametrize("text", [
    "a: 1e3", "a: true", "a: null", "a:\n", "a: 'x'", "a: b", "a: [1, 2]",
    "- 1\n- 2\n", "yes: 1", "1: 2", "---\na: 1", "a: &x 1", "a: 1\n  b: 2",
    "a:\n  b: 1\n c: 2", "{a: 1", "{a: 1} b", "a: {b: 'x'}", "{a}",
    "\ta: 1", "a: 'x", "a:1",
])
def test_yamlconf_raises_on_anything_else(text):
    with pytest.raises(ValueError):
        yamlconf.load(text)


@pytest.mark.parametrize("bad", [
    {"a": True}, {"a": "x"}, {"a": None}, {"a": np.float64(1.0)},
    {"": 1}, {"-a": 1}, {"a b": 1}, {1: 2}, {"a" * 128: 1}, {"a": [1]},
])
def test_yamlconf_dump_refuses_what_it_cannot_write(bad):
    with pytest.raises(ValueError):
        yamlconf.dump(bad)


# --- the recipe scripts -------------------------------------------------------

SCRIPTS = ["parse_options.sh", "run_FE.sh", "run_QP.sh", "run_synth.sh",
           "parity_eval.sh"]

STUB = """#!/bin/bash
# records its argv, one call per line, arguments split by \\x1f
if [ "$1" = "-c" ]; then echo "-c" >> "$STUB_LOG"; echo 100; exit 0; fi
for a in "$@"; do printf '%s\\x1f' "$a" >> "$STUB_LOG"; done
echo >> "$STUB_LOG"
"""


@pytest.mark.parametrize("name", SCRIPTS)
def test_recipe_script_parses(name):
    res = subprocess.run(["bash", "-n", os.path.join(
        ROOT, "qpnet_tpu_torch", "recipes", name)], capture_output=True,
        text=True, timeout=30)
    assert res.returncode == 0, res.stderr


def _run_script(path, args, tmp, tag):
    stub_dir = tmp / "stub"
    stub_dir.mkdir(exist_ok=True)
    stub = stub_dir / "python"
    stub.write_text(STUB)
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    prj = tmp / "prj"
    log = tmp / f"{tag}.log"
    env = dict(os.environ, PATH=f"{stub_dir}:{os.environ['PATH']}",
               STUB_LOG=str(log), QPNET_PRJ_DIR=str(prj))
    res = subprocess.run(["bash", path] + args, capture_output=True,
                         text=True, cwd=str(tmp), env=env, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    calls = []
    for line in log.read_text().splitlines():
        calls.append(line.split("\x1f")[:-1] if line != "-c" else ["-c"])
    return calls, res.stdout


def _without_device(argv):
    out, i = [], 0
    while i < len(argv):
        if argv[i] == "--device":
            i += 2
            continue
        out.append(argv[i].replace("qpnet_tpu_torch", "qpnet_tpu"))
        i += 1
    return out


@pytest.mark.parametrize("name,args", [
    ("run_FE.sh", ["--stage", "01234", "--fs", "16000"]),
    ("run_QP.sh", ["--stage", "0123456", "--miter", "300"]),
    ("run_synth.sh", ["--stage", "cftadse", "--speakers", "2",
                      "--decode_batch_size", "0", "--resume", "auto"]),
    ("parity_eval.sh", ["--si_checkpoint", "ck.pkl", "--eval_wavs", "ev",
                        "--ref_gen", "rg", "--stats", "st.h5", "--workdir",
                        "WORK"]),
])
def test_recipe_script_calls_equal_jax(name, args, tmp_path):
    """Each port script makes the JAX script's calls, in order, with the
    same argv but for the package name and --device (cuda by default;
    the port's scripts take --device)."""
    calls = {}
    for tag, path in (("jax", os.path.join(ROOT, "recipes", name)),
                      ("port", os.path.join(ROOT, "qpnet_tpu_torch",
                                            "recipes", name))):
        tmp = tmp_path / tag
        (tmp / "ev").mkdir(parents=True)
        work = tmp / "WORK"
        (work / "h5").mkdir(parents=True)
        # stage e's SD branch decodes at the best iteration (the stub's
        # 100) when the sweep's result and that output exist
        for spk in ("SYN1", "SYN2"):
            sd = f"Asynthtr_Wsynthtr_d8_Usynthup_{spk}_Vsynthup_{spk}"
            os.makedirs(tmp / "prj" / "qpnet_models" / sd)
            (tmp / "prj" / "qpnet_models" / sd /
             "validation_result.yml").write_text("checkpoint-100.pkl: 1.0\n")
            os.makedirs(tmp / "prj" / "qpnet_output" / sd / "restored" / spk
                        / "100")
        script_args = [a.replace("WORK", str(work)).replace(
            "ev", str(tmp / "ev")) if a in ("WORK", "ev") else a
            for a in args]
        extra = ["--device", "cpu"] if tag == "port" else []
        calls[tag], _ = _run_script(path, script_args + extra, tmp, tag)
    jax_calls = [[a.replace(str(tmp_path / "jax"), "<tmp>") for a in c]
                 for c in calls["jax"]]
    port_calls = [[a.replace(str(tmp_path / "port"), "<tmp>") for a in c]
                  for c in calls["port"]]
    assert len(jax_calls) >= 3
    assert [_without_device(c) for c in port_calls] == jax_calls
    # every port call but the stub's -c reads names the port's package
    # and runs on the device asked for
    for c in port_calls:
        if c != ["-c"]:
            assert c[1].startswith("qpnet_tpu_torch."), c
            if c[1].endswith(("runFE", "runQP", "feature_extract",
                              "qpnet_decode")):
                assert c[c.index("--device") + 1] == "cpu", c
