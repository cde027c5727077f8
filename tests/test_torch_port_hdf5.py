"""The port's HDF5 reader and writer (`qpnet_tpu_torch/data/hdf5_format.py`,
used by `data/h5io.py`) against h5py and the JAX package's `h5io`:

  * files each side writes read bit for bit by the others (dtype, shape,
    bytes), nested groups, scalar and zero-size datasets included;
    `check_hdf5` and `shape_hdf5` equal to the JAX package's on every
    path, through a dataset and to a group too;
  * the JAX package and the port appending to and replacing in one file in
    turn, h5py opening every state in "a" mode;
  * groups of 1-300 children each way (h5py's 300 need a second B-tree
    level), and random trees of up to 3 levels (hypothesis);
  * the committed h5py-written fixture (`tests/data/h5_fixture/`, written
    by `tests/torch_port_h5_fixture.py`) against its `.npz` twin, and
    rewritten by the port;
  * refusals: what the format module does not read raises ValueError
    naming it, and a write leaves such a file byte for byte as it was;
  * a write killed or failing midway leaves the old file readable;
  * the slice end to end where h5py cannot be imported: feature
    extraction, stats, 2 training iterations and decoding on the CPU, the
    files then read by h5py and the JAX package bit for bit.
"""

import glob
import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from qpnet_tpu.data import h5io as JH
from qpnet_tpu_torch.data import h5io as TH
from qpnet_tpu_torch.data import hdf5_format as H

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "h5_fixture")
DTYPES = ("float32", "float64", "int32", "int64", "uint8", "int16",
          ">f4", ">i8", "float16", "uint64")


def _sets(rng):
    """Feature-file and stats schemas, every dtype at ranks 0-3, zero-size
    datasets, groups three deep."""
    out = {"/world": rng.normal(size=(23, 39)).astype(np.float32),
           "/f0": np.abs(rng.normal(size=23)) * 100,
           "/npow": rng.normal(size=23),
           "/vad_idx": np.arange(23)[rng.random(23) > 0.3],
           "/stats/world/mean": rng.normal(size=39),
           "/stats/world/scale": rng.uniform(0.5, 2, 39),
           "/empty": np.zeros((0,), np.float32),
           "/empty2": np.zeros((3, 0), np.int64),
           "/a/b/c/deep": np.arange(6, dtype=np.int32).reshape(2, 3)}
    for dt in DTYPES:
        for shape in ((), (4,), (2, 3), (2, 1, 3)):
            a = rng.normal(size=shape) * 40
            if np.dtype(dt).kind == "u":
                a = np.abs(a)
            out[f"/types/{dt.replace('>', 'be')}/r{len(shape)}"] = \
                np.asarray(a).astype(dt)
    return out


def _h5py_sets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__("/" + k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
    return out


def _h5py_groups(path):
    out = ["/"]
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.append("/" + k)
                     if isinstance(v, h5py.Group) else None)
    return sorted(out)


def _same(got, want, what=""):
    """Equal dtype, shape and bytes; a scalar as h5py's `dataset[()]` gives
    it, a numpy scalar in native byte order."""
    got, want = (np.asarray(np.asarray(a)[()]) for a in (got, want))
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def _write(writer, path, sets):
    if writer == "port":
        H.write(path, sets)
    elif writer == "h5py":
        with h5py.File(path, "w") as f:
            for k, v in sets.items():
                f.create_dataset(k, data=v)
    else:
        for k, v in sets.items():
            JH.write_hdf5(path, k, v)


@pytest.mark.parametrize("writer", ["port", "h5py", "jax"])
def test_each_writer_reads_bit_for_bit_in_the_others(tmp_path, writer):
    sets = _sets(np.random.default_rng(1))
    path = str(tmp_path / "f.h5")
    _write(writer, path, sets)
    by_h5py = _h5py_sets(path)
    by_port = {"/" + k: v for k, v in H.list_datasets(path).items()}
    assert sorted(by_h5py) == sorted(by_port) == sorted(sets)
    for k, v in sets.items():
        _same(by_h5py[k], v, k)
        _same(by_port[k], v, k)
        _same(TH.read_hdf5(path, k), JH.read_hdf5(path, k), k)
        # a scalar dataset reads as h5py's numpy scalar, not a 0-d array
        assert type(TH.read_hdf5(path, k)) is type(JH.read_hdf5(path, k))
    assert _h5py_groups(path) == sorted(
        g.path for g in [H.File(path).root] + [
            n for n in H.File(path).walk() if isinstance(n, H.Group)])


PATHS = ["", "/", "//", ".", "..", "/.", "./world", "world", "/world",
         "/world/", "//world", "/./world", "/world/.", "/world/x",
         "/world/mean", "stats", "/stats", "/stats/", "/stats/world",
         "stats/world/mean", "/stats//world/mean/", "/stats/world/mean/x",
         "/stats/world/nope", "/stats/../stats", "/nope", "/f0", "/f0/",
         "/empty", "/a/b", "/a/b/c/deep", "/a/b/c/deep/", "/types/r0"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_check_and_shape_equal_the_jax_package_on_every_path(tmp_path,
                                                             writer):
    path = str(tmp_path / "f.h5")
    _write(writer, path, _sets(np.random.default_rng(2)))
    for p in PATHS:
        assert TH.check_hdf5(path, p) == JH.check_hdf5(path, p), p
        try:
            want = JH.shape_hdf5(path, p)
        except Exception as e:   # noqa: BLE001 — the type is compared
            with pytest.raises(type(e)):
                TH.shape_hdf5(path, p)
        else:
            assert TH.shape_hdf5(path, p) == want, p
    assert not TH.check_hdf5(str(tmp_path / "no.h5"), "/world")


def test_errors_are_the_ones_h5py_gave(tmp_path):
    path = str(tmp_path / "f.h5")
    TH.write_hdf5(path, "/world", np.ones((3, 2), np.float32))
    TH.write_hdf5(path, "/stats/world/mean", np.ones(2))
    with pytest.raises(FileNotFoundError):
        TH.read_hdf5(str(tmp_path / "no.h5"), "/world")
    with pytest.raises(FileNotFoundError):
        TH.shape_hdf5(str(tmp_path / "no.h5"), "/world")
    for p in ("/f0", "/world/x", ""):
        with pytest.raises(KeyError):
            TH.read_hdf5(path, p)
    with pytest.raises(TypeError):
        TH.read_hdf5(path, "/stats")
    with pytest.raises(AttributeError):
        TH.shape_hdf5(path, "/stats/world")
    with pytest.raises(TypeError):                 # a dataset's child
        TH.write_hdf5(path, "/world/x", np.ones(2))
    with pytest.raises(FileExistsError):
        TH.write_hdf5(path, "/world", np.ones(2), is_overwrite=False)
    for bad in (np.array([True]), np.array(["ab"]), np.ones(2, complex)):
        with pytest.raises(ValueError, match="dtype"):
            TH.write_hdf5(path, "/bad", bad)
    # what failed changed nothing; a group is replaced whole, as h5py's
    # `del` and `create_dataset` do
    TH.write_hdf5(path, "/stats", np.arange(3))
    assert sorted(_h5py_sets(path)) == ["/stats", "/world"]
    _same(JH.read_hdf5(path, "/stats"), np.arange(3))


def test_alternating_writes_lose_nothing(tmp_path):
    """The JAX package and the port append to and replace in one file in
    turn; after each write h5py opens it in "a" mode and every reader
    sees the expected datasets."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "f.h5")
    want = {}
    steps = [("/world", rng.normal(size=(30, 39)).astype(np.float32)),
             ("/f0", rng.normal(size=30)),
             ("/world", rng.normal(size=(12, 39)).astype(np.float32)),
             ("/npow", rng.normal(size=12)),
             ("/vad_idx", np.arange(7)),
             ("/f0", rng.normal(size=12)),
             ("/stats/world/mean", rng.normal(size=39)),
             ("/stats/world/scale", rng.normal(size=39)),
             ("/g/x", np.float64(1.5)),
             ("/world", rng.normal(size=(5, 39)).astype(np.float32)),
             ("/g/y", np.zeros((0, 2), np.int32)),
             ("/stats/world", np.arange(3)),   # a group replaced whole
             ("/g/x", np.float32(2.5))]
    for i, (k, v) in enumerate(steps):
        (TH if i % 2 else JH).write_hdf5(path, k, v)
        for old in [o for o in want if o.startswith(k + "/")]:
            del want[old]
        want[k] = v
        with h5py.File(path, "a"):
            pass
        got = _h5py_sets(path)
        assert sorted(got) == sorted(want), (i, k)
        for name, arr in want.items():
            _same(got[name], arr, (i, name))
            _same(TH.read_hdf5(path, name), JH.read_hdf5(path, name))
    # h5py appends and deletes in a port-written file, the port reads it
    with h5py.File(path, "a") as f:
        f.create_dataset("/late", data=np.arange(4))
        del f["/npow"]
    TH.write_hdf5(path, "/g/z", np.ones(2))
    assert sorted(_h5py_sets(path)) == sorted(
        [k for k in want if k != "/npow"] + ["/late", "/g/z"])


def _levels(path, group):
    """The B-tree level of a group's root node."""
    with H.File(path) as f:
        node = f.find(group)
        return f._at(node.btree, 8)[5]


@pytest.mark.parametrize("writer", ["port", "h5py"])
@pytest.mark.parametrize("n", [1, 8, 9, 33, 300])
def test_groups_of_many_children(tmp_path, writer, n):
    rng = np.random.default_rng(n)
    sets = {f"/g/d{i:03d}": rng.normal(size=i % 3 + 1) for i in range(n)}
    sets["/top"] = np.arange(3)
    path = str(tmp_path / "f.h5")
    _write(writer, path, sets)
    got = _h5py_sets(path) if writer == "port" else {
        "/" + k: v for k, v in H.list_datasets(path).items()}
    assert sorted(got) == sorted(sets)
    for k, v in sets.items():
        _same(got[k], v, k)
    if n == 300:
        assert _levels(path, "/g") >= 1
    # the other side adds and removes children, then this side reads
    with h5py.File(path, "a") as f:
        del f["/g/d000"]
        f.create_dataset("/g/zz", data=np.ones(2))
    TH.write_hdf5(path, "/g/aa", np.zeros(1))
    del sets["/g/d000"]
    sets.update({"/g/zz": np.ones(2), "/g/aa": np.zeros(1)})
    for name, got in _h5py_sets(path).items():
        _same(got, sets[name], name)
    assert len(_h5py_sets(path)) == len(sets)


_NAMES = st.text(alphabet="abXY_0é", min_size=1, max_size=5)
_TREES = st.recursive(
    st.tuples(st.sampled_from(DTYPES),
              st.lists(st.integers(0, 4), max_size=3)),
    lambda kids: st.dictionaries(_NAMES, kids, min_size=1, max_size=5),
    max_leaves=12)


def _flatten(tree, prefix, rng, out):
    for name, kid in tree.items():
        path = f"{prefix}/{name}"
        if isinstance(kid, dict):
            _flatten(kid, path, rng, out)
        else:
            dt, shape = kid
            a = rng.normal(size=tuple(shape)) * 30
            out[path] = (np.abs(a) if np.dtype(dt).kind == "u" else a
                         ).astype(dt)
    return out


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(tree=st.dictionaries(_NAMES, _TREES, min_size=1, max_size=4),
       seed=st.integers(0, 2 ** 16))
def test_random_trees_both_ways(tmp_path, tree, seed):
    sets = _flatten(tree, "", np.random.default_rng(seed), {})
    for writer in ("port", "h5py"):
        path = str(tmp_path / f"{writer}.h5")
        if os.path.exists(path):
            os.unlink(path)
        _write(writer, path, sets)
        got = _h5py_sets(path) if writer == "port" else {
            "/" + k: v for k, v in H.list_datasets(path).items()}
        assert sorted(got) == sorted(sets)
        for k, v in sets.items():
            _same(got[k], v, k)
    assert _h5py_groups(str(tmp_path / "port.h5")) == _h5py_groups(
        str(tmp_path / "h5py.h5"))


FIXTURE_FILES = ("utt1", "utt2", "stats", "rewritten", "group40", "dtypes")


@pytest.mark.parametrize("stem", FIXTURE_FILES)
def test_the_fixture_against_its_npz_and_rewritten(tmp_path, stem):
    """Every dataset of the h5py-written fixture read by the port equal to
    its twin; every dataset written again by the port's write_hdf5 into a
    copy reads back equal in the port and in h5py."""
    twin = np.load(os.path.join(FIXTURE, "arrays.npz"))
    src = os.path.join(FIXTURE, f"{stem}.h5")
    want = {k[len(stem) + 1:]: twin[k] for k in twin
            if k.startswith(stem + "/")}
    got = H.list_datasets(src)
    assert sorted(got) == sorted(want) and want
    for k, v in want.items():
        _same(got[k], v, k)
    dst = str(tmp_path / f"{stem}.h5")
    with open(src, "rb") as a, open(dst, "wb") as b:
        b.write(a.read())
    for k, v in want.items():
        TH.write_hdf5(dst, "/" + k, v)
    by_h5py = _h5py_sets(dst)
    for k, v in want.items():
        _same(TH.read_hdf5(dst, "/" + k), v, k)
        _same(by_h5py["/" + k], v, k)
    if stem == "rewritten":     # the freed bytes are gone
        assert os.path.getsize(dst) < os.path.getsize(src)


def _bad_file(path, feature):
    """A file with /world and one object of `feature` at /bad."""
    libver = "latest" if feature == "latest" else "earliest"
    block = 512 if feature == "user block" else 0
    with h5py.File(path, "w", libver=libver, userblock_size=block) as f:
        f.create_dataset("/world", data=np.ones((3, 2), np.float32))
        if feature == "chunked":
            f.create_dataset("/bad", data=np.arange(10.0), chunks=(4,))
        elif feature == "gzip":
            f.create_dataset("/bad", data=np.arange(10.0),
                             compression="gzip")
        elif feature == "attributes":
            f.create_dataset("/bad", data=np.arange(3.0))
            f["/bad"].attrs["unit"] = 1.0
        elif feature == "bool":
            f.create_dataset("/bad", data=np.array([True, False]))
        elif feature == "string":
            f.create_dataset("/bad", data=np.array([b"ab", b"cd"]))
        elif feature == "vlen string":
            f.create_dataset("/bad", data="a string")
        else:
            f.create_dataset("/bad", data=np.arange(3.0))


@pytest.mark.parametrize("feature,named", [
    ("chunked", "chunked layout"), ("gzip", "filter pipeline"),
    ("latest", "superblock version 3"), ("attributes", "attributes"),
    ("bool", "enumeration"), ("string", r"class 3 \(string\)"),
    ("vlen string", "variable-length"), ("user block", "user block")])
def test_refusals_name_the_feature_and_leave_the_file(tmp_path, feature,
                                                      named):
    path = str(tmp_path / "bad.h5")
    _bad_file(path, feature)
    before = open(path, "rb").read()
    with pytest.raises(ValueError, match=named):
        TH.write_hdf5(path, "/f0", np.ones(3))
    assert open(path, "rb").read() == before
    if feature in ("attributes", "user block"):   # the data reads as it is
        _same(TH.read_hdf5(path, "/bad"), np.arange(3.0))
    else:
        with pytest.raises(ValueError, match=named):
            TH.read_hdf5(path, "/bad")
    if feature != "latest":
        _same(TH.read_hdf5(path, "/world"), np.ones((3, 2), np.float32))
    assert not glob.glob(str(tmp_path / ".*.tmp"))


KILLED = """
import os, signal, sys
import numpy as np
from qpnet_tpu_torch.data import h5io, hdf5_format

real_open = open


class Half:
    def __init__(self, f):
        self.f = f

    def write(self, b):        # midway: half the image written
        self.f.write(b[:len(b) // 2])
        self.f.flush()
        os.kill(os.getpid(), signal.SIGKILL)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.f.close()


hdf5_format.open = lambda name, mode="r": (
    Half(real_open(name, mode)) if "x" in mode else real_open(name, mode))
h5io.write_hdf5(sys.argv[1], "/world", np.zeros((50, 39), np.float32))
"""


@pytest.mark.parametrize("how", ["killed", "raised"])
def test_a_write_cut_midway_leaves_the_old_file(tmp_path, how, monkeypatch):
    path = str(tmp_path / "f.h5")
    old = np.arange(12, dtype=np.float32).reshape(3, 4)
    TH.write_hdf5(path, "/world", old)
    TH.write_hdf5(path, "/f0", np.ones(3))
    before = open(path, "rb").read()
    if how == "killed":
        res = subprocess.run([sys.executable, "-c", KILLED, path],
                             env=dict(os.environ, PYTHONPATH=ROOT),
                             capture_output=True, timeout=120)
        assert res.returncode == -9, res.stderr
        left = glob.glob(str(tmp_path / ".f.h5.*.tmp"))
        assert len(left) == 1 and 0 < os.path.getsize(left[0])
    else:
        real_open = open

        class Fails:
            def __init__(self, f):
                self.f = f

            def write(self, b):
                self.f.write(b[:len(b) // 2])
                raise OSError("disk full")

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                self.f.close()

        monkeypatch.setattr(H, "open", lambda name, mode="r": (
            Fails(real_open(name, mode)) if "x" in mode
            else real_open(name, mode)), raising=False)
        with pytest.raises(OSError, match="disk full"):
            TH.write_hdf5(path, "/world", np.zeros((50, 39), np.float32))
        monkeypatch.undo()
        assert not glob.glob(str(tmp_path / ".f.h5.*.tmp"))
    assert open(path, "rb").read() == before
    _same(TH.read_hdf5(path, "/world"), old)
    _same(_h5py_sets(path)["/world"], old)
    TH.write_hdf5(path, "/npow", np.zeros(3))
    assert sorted(_h5py_sets(path)) == ["/f0", "/npow", "/world"]


# --- the slice end to end where h5py cannot be imported --------------------

E2E_FS, E2E_UP = 22050, 110
E2E_NET = ["--n_quantize", "32", "--n_resch", "16", "--n_skipch", "8",
           "--dilationF_depth", "2", "--dilationF_repeat", "1",
           "--dilationA_depth", "2", "--dilationA_repeat", "1",
           "--upsampling_factor", str(E2E_UP)]
E2E = """
import sys
sys.modules["h5py"] = None
import json, os
import numpy as np
import torch

if __name__ == "__main__":
    torch.set_num_threads(1)
    from qpnet_tpu_torch.bin import (calc_stats, feature_extract,
                                     qpnet_decode, qpnet_train)
    from qpnet_tpu_torch.data import h5io, stats
    root, net = sys.argv[1], json.loads(sys.argv[2])
    fs = sys.argv[3]
    written = {}
    real = h5io.write_hdf5

    def record(name, path, data, is_overwrite=True):
        real(name, path, data, is_overwrite)
        written[os.path.abspath(name) + ":" + path] = np.asarray(data)

    for mod in (h5io, feature_extract, stats):
        mod.write_hdf5 = record
    common = ["--fs", fs, "--verbose", "0"]
    feature_extract.main(["--waveforms", os.path.join(root, "wav.scp"),
                          "--n_jobs", "1", "--minf0", "60", "--maxf0",
                          "400", "--save_extended", "true"] + common)
    feats = sorted(os.path.join(root, "h5", n)
                   for n in os.listdir(os.path.join(root, "h5")))
    with open(os.path.join(root, "feats.scp"), "w") as f:
        f.write("\\n".join(feats) + "\\n")
    st = os.path.join(root, "stats", "stats.h5")
    calc_stats.main(["--features", os.path.join(root, "feats.scp"),
                     "--stats", st, "--verbose", "0"])
    exp = os.path.join(root, "exp")
    qpnet_train.main(["--waveforms", os.path.join(root, "wav.scp"),
                      "--feats", os.path.join(root, "feats.scp"),
                      "--stats", st, "--expdir", exp, "--config",
                      os.path.join(exp, "model.conf"), "--batch_length",
                      "400", "--max_length", "4800", "--iters", "2",
                      "--checkpoint_interval", "2", "--intervals", "1",
                      "--device", "cpu", "--verbose", "0"] + net)
    qpnet_decode.main(["--feats", os.path.join(root, "feats.scp"),
                       "--stats", st, "--config",
                       os.path.join(exp, "model.conf"), "--outdir",
                       os.path.join(root, "gen", "feat_id.wav"),
                       "--checkpoint",
                       os.path.join(exp, "checkpoint-final.pkl"),
                       "--batch_size", "2", "--device", "cpu"] + common)
    np.savez(os.path.join(root, "written.npz"), **{
        str(i): v for i, v in enumerate(written.values())})
    with open(os.path.join(root, "written.json"), "w") as f:
        json.dump(list(written), f)
    print("E2E_OK", sorted(written))
"""


def test_the_slice_runs_without_h5py_and_h5py_reads_its_files(tmp_path):
    """In a process where h5py cannot be imported: the port's
    feature_extract (host backends, /world_extend too), calc_stats, 2
    training iterations of a tiny net and qpnet_decode on wavs of 0.15
    and 0.2 s; then h5py and the JAX package read every dataset it wrote
    bit for bit, and each decoded wav has F * up - 1 samples."""
    from scipy.io import wavfile
    from torch_port_h5_fixture import FS, voiced
    assert FS == E2E_FS
    root = tmp_path / "e2e"
    (root / "wav").mkdir(parents=True)
    rng = np.random.default_rng(18)
    wavs = []
    for i, secs in enumerate((0.15, 0.2)):
        p = str(root / "wav" / f"u{i}.wav")
        wavfile.write(p, E2E_FS, voiced(rng, secs))
        wavs.append(p)
    (root / "wav.scp").write_text("\n".join(wavs) + "\n")
    script = tmp_path / "e2e.py"
    script.write_text(E2E)
    res = subprocess.run(
        [sys.executable, str(script), str(root), json.dumps(
            E2E_NET + ["--n_aux", "39"]), str(E2E_FS)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "E2E_OK" in res.stdout
    keys = json.load(open(root / "written.json"))
    arrays = np.load(root / "written.npz")
    files = {k.rsplit(":", 1)[0] for k in keys}
    assert len(files) == 3           # two feature files and the stats
    for i, key in enumerate(keys):
        name, path = key.rsplit(":", 1)
        _same(_h5py_sets(name)[path], arrays[str(i)], key)
        _same(JH.read_hdf5(name, path), arrays[str(i)], key)
    for name in files:               # nothing else in the files
        assert sorted(_h5py_sets(name)) == sorted(
            k.rsplit(":", 1)[1] for k in keys if k.startswith(name + ":"))
    for i in range(2):
        n_frames = len(JH.read_hdf5(str(root / "h5" / f"u{i}.h5"), "/f0"))
        fs, x = wavfile.read(str(root / "gen" / f"u{i}.wav"))
        assert fs == E2E_FS and x.dtype == np.int16
        assert x.shape == (n_frames * E2E_UP - 1,)
        assert np.isfinite(x).all() and int(x.max()) > int(x.min())
