"""The committed HDF5 fixture of the port's h5 tests and of chip_smoke.py's
phase 16 (`tests/data/h5_fixture/`), written by the JAX package (h5py)
only:

  * `utt1.h5`, `utt2.h5`: `feature_extract.main` with the host backends and
    the CLI's defaults (22,050 Hz, harvest, mcep 34) on two synthetic voiced
    utterances of 0.25 and 0.3 s (seed 18): /world, /f0, /npow, /vad_idx;
  * `stats.h5`: `calc_stats.main` over them (/world/mean, /world/scale);
  * `rewritten.h5`: /world written twice, the first one's bytes left behind
    as free space;
  * `group40.h5`: a group of 40 datasets (several symbol-table nodes),
    written by h5py in one session (through `write_hdf5`, which opens
    the file once a dataset, h5py's metadata blocks made it 83 KB);
  * `dtypes.h5`: float32, float64, int32, int64 and uint8 arrays of ranks
    0-3, a zero-size one among them;
  * `arrays.npz`: every dataset's array, keyed `<file stem>/<path>`.

/world_extend is left out: at 22,050 Hz it holds 110 times /world's
values, about 1 MB a file for 0.3 s.

Write it again (needs JAX and h5py) with
  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_h5_fixture.py
"""

import os
import shutil
import tempfile

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "h5_fixture")
FS = 22050
SECONDS = (0.25, 0.3)
FEATURES = ("utt1", "utt2")          # the feature files, with stats.h5


def voiced(rng, seconds):
    """int16 PCM: harmonics of an F0 gliding over 110-170 Hz under a
    raised-cosine envelope, with a little noise."""
    n = int(seconds * FS)
    t = np.arange(n) / FS
    f0 = 110 + 60 * t / seconds + 3 * np.sin(2 * np.pi * 5.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / FS
    x = sum(np.sin(k * phase) / k for k in range(1, 25))
    env = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
    x = 6000 * env * x + rng.normal(scale=30, size=n)
    return np.clip(x, -32768, 32767).astype(np.int16)


def main():
    import h5py
    from scipy.io import wavfile

    from qpnet_tpu.bin import calc_stats, feature_extract
    from qpnet_tpu.data.h5io import write_hdf5

    rng = np.random.default_rng(18)
    shutil.rmtree(FIXTURE, ignore_errors=True)
    os.makedirs(FIXTURE)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "fx")      # no "wav" above the wav dir
        os.makedirs(os.path.join(root, "wav"))
        for name, secs in zip(FEATURES, SECONDS):
            wavfile.write(os.path.join(root, "wav", f"{name}.wav"), FS,
                          voiced(rng, secs))
        feature_extract.main(["--waveforms", os.path.join(root, "wav"),
                              "--n_jobs", "1", "--verbose", "0"])
        feats = [os.path.join(FIXTURE, f"{n}.h5") for n in FEATURES]
        for n, dst in zip(FEATURES, feats):
            shutil.copy(os.path.join(root, "h5", f"{n}.h5"), dst)
        lst = os.path.join(tmp, "feats.scp")
        with open(lst, "w") as f:
            f.write("\n".join(feats) + "\n")
        calc_stats.main(["--features", lst, "--stats",
                         os.path.join(FIXTURE, "stats.h5"), "--verbose",
                         "0"])
    path = os.path.join(FIXTURE, "rewritten.h5")
    write_hdf5(path, "/world", rng.normal(size=(40, 39)).astype(np.float32))
    write_hdf5(path, "/f0", rng.uniform(80, 200, 30))
    write_hdf5(path, "/world", rng.normal(size=(30, 39)).astype(np.float32))
    with h5py.File(os.path.join(FIXTURE, "group40.h5"), "w") as f:
        for i in range(40):
            f.create_dataset(f"/g/d{i:02d}", data=rng.normal(size=i % 5 + 1))
    path = os.path.join(FIXTURE, "dtypes.h5")
    shapes = ((), (5,), (3, 4), (2, 3, 2))
    for dt in ("float32", "float64", "int32", "int64", "uint8"):
        for shape in shapes:
            a = (rng.normal(size=shape) * 50 if dt.startswith("f") else
                 rng.integers(0, 200, size=shape)).astype(dt)
            write_hdf5(path, f"/{dt}/rank{len(shape)}", a)
    write_hdf5(path, "/empty", np.zeros((0, 3), np.float32))
    arrays = {}
    for name in sorted(os.listdir(FIXTURE)):
        with h5py.File(os.path.join(FIXTURE, name), "r") as f:
            f.visititems(lambda k, v: arrays.__setitem__(
                f"{name[:-3]}/{k}", np.asarray(v[()]))
                if isinstance(v, h5py.Dataset) else None)
    np.savez_compressed(os.path.join(FIXTURE, "arrays.npz"), **arrays)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    main()
