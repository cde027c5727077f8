"""The committed orbax fixture of the port's checkpoint tests
(`tests/data/orbax_fixture/`): a tiny net trained 2 steps by the JAX
package's trainer under QPNET_CKPT_BACKEND=orbax, its `checkpoint-2.orbax`
(orbax's default OCDBT layout, zstd level 1), and `checkpoint-2.pkl`, the
same state as the JAX package's pickle backend writes it.  Its weight
arrays are large enough that zstd codes them in compressed blocks with
Huffman literals and FSE sequences.

Write it again (needs JAX, orbax and h5py) with
  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_orbax_fixture.py
"""

import os
import shutil
import sys
import tempfile

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "orbax_fixture")
# the model.conf widths of the fixture's net
CONFIG = dict(n_quantize=64, n_aux=8, n_resch=16, n_skipch=16,
              dilationF_depth=2, dilationF_repeat=1, dilationA_depth=1,
              dilationA_repeat=1, kernel_size=2, upsampling_factor=10)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from helpers import make_synthetic_corpus
    from qpnet_tpu.config import ModelConfig, TrainConfig
    from qpnet_tpu.data.stats import calc_stats
    from qpnet_tpu.models import init_params
    from qpnet_tpu.train import checkpoint as JC
    from qpnet_tpu.train.step import make_optimizer
    from qpnet_tpu.train.trainer import run_training

    cfg = ModelConfig(**CONFIG)
    tcfg = TrainConfig(lr=2e-3, iters=2, checkpoint_interval=2,
                       batch_length=300, batch_size=1, max_length=900,
                       intervals=1)
    os.environ["QPNET_CKPT_BACKEND"] = "orbax"
    with tempfile.TemporaryDirectory() as tmp:
        wavs, feats = make_synthetic_corpus(tmp, n_utts=2, fs=1000, up=10,
                                            n_aux=CONFIG["n_aux"])
        stats = os.path.join(tmp, "stats.h5")
        calc_stats(feats, stats)
        expdir = os.path.join(tmp, "exp")
        run_training(cfg, tcfg, wavs, feats, stats, expdir)
        params = init_params(jax.random.PRNGKey(0), cfg)
        src = os.path.join(expdir, "checkpoint-2.orbax")
        ck = JC.load_checkpoint(src, template={
            "model": params, "optimizer": make_optimizer().init(params),
            "iterations": 0})
        shutil.rmtree(FIXTURE, ignore_errors=True)
        os.makedirs(FIXTURE)
        shutil.copytree(src, os.path.join(FIXTURE, "checkpoint-2.orbax"))
        JC.save_checkpoint(FIXTURE, ck["model"], ck["optimizer"],
                           ck["iterations"], backend="pickle")


if __name__ == "__main__":
    main()
