"""The FLOP, byte, roofline and mfu functions against hand-worked values."""

import json

import pytest

from qpbench import flops
from qpbench.harness import ROOT


def cfg(name):
    with open(ROOT / "qpbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_decode_sample_flops_by_hand():
    # default: L = 16, R = 512, S = 256, Q = 256
    main, rest = flops.decode_sample_flops(cfg("qpnet_default"))
    assert main == 2 * 16 * (1024 * 1024 + 512 * 768) == 46_137_344
    assert rest == 2 * (256 * 256 + 256 * 256) == 262_144
    assert main + rest == 46_399_488            # 46.4 MFLOP a sample
    # the deep net: L = 34
    main, rest = flops.decode_sample_flops(cfg("qpnet_rd10"))
    assert main + rest == 98_304_000            # 98.3 MOP a sample
    assert flops.aux_frame_flops(cfg("qpnet_default")) == 2 * 16 * 39 * 1024


def test_train_forward_flops_by_hand():
    per = 2 * 16 * (1024 * 1024 + 39 * 1024 + 512 * 768) + 262_144
    assert per == 47_677_440
    fl = flops.train_forward_flops(cfg("qpnet_default"), 1, 30_030)
    assert fl == 30_030 * per
    assert 1.42e12 < fl < 1.44e12               # about 1.42 TFLOP a step
    # 3 x forward over 150 ms at 495 TFLOP/s
    assert flops.train_mfu(cfg("qpnet_default"), 1, 30_030, 0.150) == \
        pytest.approx(100 * 3 * fl / 0.150 / 495e12)


def test_peaks_combine_by_time():
    fl = {"main": 1979e12, "rest": 989e12}
    assert flops.seconds_at_peak(fl, "w8a8") == pytest.approx(2.0)
    assert flops.seconds_at_peak(fl, "none") == pytest.approx(
        1979 / 989 + 1.0)
    assert flops.share(0.5, 2.0) == 25.0
    assert flops.share(1.0, 0.0) is None


def test_decode_mfu_by_hand():
    c = cfg("qpnet_default")
    # one second of 90,000 useful samples over 818 frames at bf16
    fl = flops.decode_flops(c, 90_000, 818)
    assert fl["main"] == 90_000 * 46_137_344
    assert fl["rest"] == 90_000 * 262_144 + 818 * 1_277_952
    assert flops.share(flops.seconds_at_peak(fl, "none"), 1.0) == \
        pytest.approx(100 * (fl["main"] + fl["rest"]) / 989e12)


def test_k1_bound_is_by_operations_at_batch_20():
    c = cfg("qpnet_default")
    n = 20 * 66_000
    secs, by = flops.k1_bound(c, 20, 31, n, n // 110, "none")
    assert by == "operations"
    assert secs == pytest.approx(flops.seconds_at_peak(
        flops.decode_flops(c, n, n // 110), "none"))
    # weights alone: 24.1 M parameters mostly bf16, about 48 MB
    b = flops.k1_bytes(c, 1, 1, 0, 0, "none")
    assert 45e6 < b < 52e6
    # w8a8 halves the main products' bytes
    assert flops.k1_bytes(c, 1, 1, 0, 0, "w8a8") < 0.6 * b


def test_weights_tree_has_the_configurations_parameter_count():
    from qpbench.weights import count
    for name in ("qpnet_default", "qpnet_rd10"):
        assert count(cfg(name)) == cfg(name)["n_params"]
    assert cfg("qpnet_default")["n_params"] == 24_130_671
