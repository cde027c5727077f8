"""The port's host data layer against the JAX package's: h5 writes read
by the other package both ways, corpus statistics and the streaming scaler
bit for bit, the scp list helpers, the spawn worker pool and the stats
file's scaler."""

import os

import numpy as np
import pytest

from qpnet_tpu.data import h5io as JH
from qpnet_tpu.data import lists as JL
from qpnet_tpu.data import stats as JS
from qpnet_tpu_torch.data import h5io as TH
from qpnet_tpu_torch.data import lists as TL
from qpnet_tpu_torch.data import stats as TS
from qpnet_tpu_torch.utils import multi_processing

DATASETS = {"/world": np.float32, "/f0": np.float64, "/npow": np.float64,
            "/vad_idx": np.int64}


def _feature_sets(rng, F):
    return {"/world": rng.normal(size=(F, 39)).astype(np.float32),
            "/f0": np.abs(rng.normal(size=F)) * 100,
            "/npow": rng.normal(size=F),
            "/vad_idx": np.arange(F)[rng.random(F) > 0.3]}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_h5_written_by_one_package_reads_in_the_other(tmp_path, writer):
    """Same datasets, dtypes and shapes: exact, both ways; an existing
    dataset is replaced, or kept and refused with is_overwrite=False."""
    rng = np.random.default_rng(0)
    sets = _feature_sets(rng, 23)
    path = str(tmp_path / "sub" / "utt.h5")
    write, read, check = ((TH.write_hdf5, JH.read_hdf5, JH.check_hdf5)
                          if writer == "port" else
                          (JH.write_hdf5, TH.read_hdf5, TH.check_hdf5))
    for k, v in sets.items():
        write(path, k, v)
    for k, v in sets.items():
        got = np.asarray(read(path, k))
        assert got.dtype == DATASETS[k] and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v)
        assert TH.check_hdf5(path, k) and JH.check_hdf5(path, k)
        assert TH.shape_hdf5(path, k) == JH.shape_hdf5(path, k) == v.shape
    assert not check(path, "/spc") and not check(str(tmp_path / "no.h5"),
                                                 "/world")
    write(path, "/f0", np.zeros(4))
    np.testing.assert_array_equal(read(path, "/f0"), np.zeros(4))
    with pytest.raises(FileExistsError):
        TH.write_hdf5(path, "/f0", np.ones(4), is_overwrite=False)
    np.testing.assert_array_equal(TH.read_hdf5(path, "/f0"), np.zeros(4))


@pytest.mark.parametrize("n_files", [1, 3])
def test_calc_stats_and_partial_fit_bit_equal(tmp_path, n_files):
    """calc_stats over JAX-written features: the stats file of the port and
    of the JAX package equal bit for bit, uv dimension pinned; the
    streaming scaler's mean_, m2_, n and scale_ too, a constant dimension
    scaled by 1."""
    rng = np.random.default_rng(n_files)
    files = []
    for i in range(n_files):
        f = str(tmp_path / f"u{i}.h5")
        world = rng.normal(size=(17 + 5 * i, 39)) * rng.uniform(0.1, 3, 39)
        world[:, 5] = 2.5                                 # constant dim
        JH.write_hdf5(f, "/world", world.astype(np.float32))
        files.append(f)
    TS.calc_stats(files, str(tmp_path / "t.h5"))
    JS.calc_stats(files, str(tmp_path / "j.h5"))
    for k in ("/world/mean", "/world/scale"):
        t, j = TH.read_hdf5(str(tmp_path / "t.h5"), k), JH.read_hdf5(
            str(tmp_path / "j.h5"), k)
        assert t.dtype == j.dtype == np.float64
        np.testing.assert_array_equal(t, j)
    mean = TH.read_hdf5(str(tmp_path / "t.h5"), "/world/mean")
    scale = TH.read_hdf5(str(tmp_path / "t.h5"), "/world/scale")
    assert mean[0] == 0.0 and scale[0] == 1.0 and scale[5] == 1.0
    ts, js = TS.Scaler(), JS.Scaler()
    for f in files:
        x = JH.read_hdf5(f, "/world")
        ts.partial_fit(x)
        js.partial_fit(x)
    assert ts.n == js.n
    for a in ("mean_", "m2_", "scale_"):
        np.testing.assert_array_equal(getattr(ts, a), getattr(js, a))
    x = rng.normal(size=(6, 39))
    np.testing.assert_array_equal(ts.transform(x), js.transform(x))
    with pytest.raises(ValueError, match="empty"):
        TS.calc_stats([], str(tmp_path / "e.h5"))


def test_load_scaler_gives_the_same_bits_as_before(tmp_path):
    """load_scaler (the decode and serve frontends) keeps the mean and
    sqrt(scale**2) with zeros scaled by 1, the port's stored-stats scaler
    before the streaming one, and the JAX package's transform."""
    rng = np.random.default_rng(4)
    mean, scale = rng.normal(size=39), rng.uniform(-2, 2, 39)
    scale[[3, 7]] = 0.0
    path = str(tmp_path / "stats.h5")
    TH.write_hdf5(path, "/world/mean", mean)
    TH.write_hdf5(path, "/world/scale", scale)
    before = np.sqrt(scale ** 2)
    before[before == 0.0] = 1.0
    sc = TS.load_scaler(path)
    np.testing.assert_array_equal(sc.mean_, mean)
    np.testing.assert_array_equal(sc.scale_, before)
    x = rng.normal(size=(9, 39))
    np.testing.assert_array_equal(sc.transform(x), (x - mean) / before)
    np.testing.assert_array_equal(sc.transform(x),
                                  JS.load_scaler(path).transform(x))
    ts, js = TS.Scaler.from_stats(mean, scale), JS.Scaler.from_stats(
        mean, scale)
    assert ts.n == js.n == 1
    for a in ("mean_", "m2_", "scale_"):
        np.testing.assert_array_equal(getattr(ts, a), getattr(js, a))


def _scp(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_list_helpers_give_equal_files(tmp_path):
    """write_txt, templist, templist_eval (with and without replace),
    list_initial, path_check, path_initial and remove_temp_file: the same
    files and return values as the JAX package's."""
    root = tmp_path / "corpus"
    lines = [f"SF1/wav/utt{i}.wav" for i in range(4)] + ["TM1/wav/x.wav"]
    scp = str(tmp_path / "train.scp")
    _scp(scp, lines)
    kw = (["wav", ".wav"], ["h5", ".h5"])
    for mod, tag in ((TL, "t"), (JL, "j")):
        mod.write_txt(str(tmp_path / tag / "w.txt"), lines)
        mod.templist(scp, str(tmp_path / tag / "tl.scp"), str(root) + "/",
                     *kw)
        mod.templist(scp, str(tmp_path / tag / "tl0.scp"), "", *kw)
    for name in ("w.txt", "tl.scp", "tl0.scp"):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text()
    assert TL.read_txt(str(tmp_path / "t" / "tl.scp"))[0] == \
        str(root) + "/SF1/h5/utt0.h5"

    outdir = str(tmp_path / "gen" / "feat_id.wav")
    os.makedirs(tmp_path / "gen")
    (tmp_path / "gen" / "utt1.wav").write_bytes(b"")      # already done
    for replace in (False, True):
        got = [mod.list_initial(replace, "h5", scp,
                                str(tmp_path / f"{tag}{replace}.scp"),
                                outdir, *kw)
               for mod, tag in ((TL, "t"), (JL, "j"))]
        assert got == [True, True]
        assert (tmp_path / f"t{replace}.scp").read_text() == \
            (tmp_path / f"j{replace}.scp").read_text()
    assert "utt1" not in (tmp_path / "tFalse.scp").read_text()
    assert "utt1" in (tmp_path / "tTrue.scp").read_text()
    one = str(tmp_path / "one.scp")
    _scp(one, ["SF1/wav/utt1.wav"])
    assert TL.templist_eval(False, "h5", one, str(tmp_path / "n.scp"),
                            outdir, *kw) is \
        JL.templist_eval(False, "h5", one, str(tmp_path / "n.scp"), outdir,
                         *kw) is False
    assert not (tmp_path / "n.scp").exists()

    new = [str(tmp_path / "p" / "a"), str(tmp_path / "p" / "b")]
    TL.path_initial(new)
    TL.path_check(new)
    JL.path_check(new)
    with pytest.raises(FileNotFoundError):
        TL.path_check(new + [str(tmp_path / "missing")])
    temps = [str(tmp_path / "t" / "tl.scp"), str(tmp_path / "gone")]
    TL.remove_temp_file(temps)
    assert not os.path.exists(temps[0])


def _write_stem(paths, out_dir, tag):
    """A module-level worker (spawned children import it): one marker file
    per item, named by the worker's pid."""
    for p in paths:
        with open(os.path.join(out_dir, f"{os.path.basename(p)}.{tag}"),
                  "w") as f:
            f.write(str(os.getpid()))


def test_multi_processing_inline_and_capped(tmp_path):
    """n_jobs == 1 runs in this process; n_jobs above the item count is
    capped (one item: inline)."""
    multi_processing(["a", "b"], _write_stem, 1, str(tmp_path), "x")
    multi_processing(["c"], _write_stem, 8, str(tmp_path), "x")
    pids = {(tmp_path / f"{s}.x").read_text() for s in "abc"}
    assert pids == {str(os.getpid())}


def test_multi_processing_spawns_a_port_worker(tmp_path):
    """2 spawned workers run the port's noise_shaping worker over 3 wavs;
    each output equals the worker run inline, and a failing worker raises
    in the parent."""
    from scipy.io import wavfile

    from qpnet_tpu_torch.bin import noise_shaping

    rng = np.random.default_rng(2)
    wavs = []
    for i in range(3):
        p = tmp_path / "wav" / f"u{i}.wav"
        p.parent.mkdir(exist_ok=True)
        wavfile.write(str(p), 16000,
                      (rng.normal(size=1600) * 3000).astype(np.int16))
        wavs.append(str(p))
    stats = str(tmp_path / "stats.h5")
    TH.write_hdf5(stats, "/world/mean", rng.normal(size=39) * 0.2)
    TH.write_hdf5(stats, "/world/scale", np.ones(39))
    args = noise_shaping.get_arguments(
        ["--waveforms", str(tmp_path / "wav"), "--stats", stats, "--fs",
         "16000", "--n_jobs", "2", "--verbose", "0"])
    multi_processing(wavs, noise_shaping.shape_worker, 2, "wav_a", args)
    noise_shaping.shape_worker(wavs, "wav_b", args)
    for w in wavs:
        a = wavfile.read(w.replace("wav", "wav_a").replace(".wav_a",
                                                           ".wav"))[1]
        b = wavfile.read(w.replace("wav", "wav_b").replace(".wav_b",
                                                           ".wav"))[1]
        np.testing.assert_array_equal(a, b)
    args.fs = 22050                          # every worker exits with 1
    with pytest.raises(RuntimeError, match="2 of 2 workers"):
        multi_processing(wavs, noise_shaping.shape_worker, 2, "wav_c", args)
