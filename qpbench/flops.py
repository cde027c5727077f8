"""Operations, bytes, peaks, rooflines and mfu of the QPNet cells.

Every count follows the model's shapes from the configuration file, never
what a kernel does, so it stays the same whatever implements the work.
`cfg` is the configuration file's dict (qpbench/configs/*.json).

Peaks are NVIDIA's data sheet for one H100 SXM, dense rates: 989 TFLOP/s
bf16, 1,979 TOP/s int8, 495 TFLOP/s TF32 (the fastest rate at which the
card runs f32-typed products), 3.35 TB/s HBM.
"""

from __future__ import annotations

BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
TF32_FLOP_PER_S = 495e12
HBM_BYTES_PER_S = 3.35e12


def dilations(cfg):
    """(fixed, adaptive) dilations: 2**i for i < depth, repeated."""
    return ([2 ** i for i in range(cfg["dilationF_depth"])]
            * cfg["dilationF_repeat"],
            [2 ** i for i in range(cfg["dilationA_depth"])]
            * cfg["dilationA_repeat"])


def n_layers(cfg) -> int:
    fixed, adaptive = dilations(cfg)
    return len(fixed) + len(adaptive)


def _widths(cfg):
    return (n_layers(cfg), cfg["n_resch"], cfg["n_skipch"],
            cfg["n_quantize"], cfg["n_aux"])


def decode_sample_flops(cfg):
    """(main, rest) FLOPs of one generated sample: per layer the gate
    product [o | past] (2R) x 2R and the out product R x (S + R), that is
    main = 2 L (2R 2R + R (S + R)); and the post-net,
    rest = 2 (S S + S Q).  The aux projection runs once per frame
    (`aux_frame_flops`).  Priming, the teacher-forced pass that fills the
    rings before the first step, is not counted: it is the same for every
    call and no sample comes of it."""
    L, R, S, Q, _ = _widths(cfg)
    return 2 * L * (2 * R * 2 * R + R * (S + R)), 2 * (S * S + S * Q)


def aux_frame_flops(cfg) -> int:
    """FLOPs of one frame's aux projection: 2 L A 2R."""
    L, R, _, _, A = _widths(cfg)
    return 2 * L * A * 2 * R


def decode_flops(cfg, n_samples: int, n_frames: int) -> dict:
    """{"main": the W_in and W_out products, "rest": post-net and aux} of
    n_samples generated samples over n_frames frames."""
    main, rest = decode_sample_flops(cfg)
    return {"main": n_samples * main,
            "rest": n_samples * rest + n_frames * aux_frame_flops(cfg)}


def seconds_at_peak(flops: dict, quantize: str) -> float:
    """The least time the card needs for `flops` at the peaks of the
    configuration's product types: the main products at the int8 rate
    under w8a8, everything else at the bf16 rate, added by time."""
    main_rate = INT8_OP_PER_S if quantize == "w8a8" else BF16_FLOP_PER_S
    return flops["main"] / main_rate + flops["rest"] / BF16_FLOP_PER_S


def share(least_s: float, wall_s: float):
    """100 * least_s / wall_s, or None without a wall."""
    if not wall_s or wall_s <= 0:
        return None
    return 100.0 * least_s / wall_s


def train_forward_flops(cfg, B: int, T: int) -> int:
    """FLOPs of one teacher-forced forward over B rows of T samples: every
    sample the step computes, per layer the gate product with the aux at
    its A channels (2R 2R + A 2R) and the out product (R (S + R)), and
    the post-net."""
    L, R, S, Q, A = _widths(cfg)
    per = 2 * L * (2 * R * 2 * R + A * 2 * R + R * (S + R)) \
        + 2 * (S * S + S * Q)
    return B * T * per


def train_mfu(cfg, B: int, T: int, step_s: float):
    """3 x the forward's FLOPs (forward, and the backward's two products a
    product) per step over the step time and the TF32 peak, in %."""
    return share(3 * train_forward_flops(cfg, B, T) / TF32_FLOP_PER_S,
                 step_s)


def k1_bytes(cfg, B: int, maxd: int, n_samples: int, n_frames: int,
             quantize: str) -> int:
    """Bytes one generation call must move at least: its weights read once
    (bf16; int8 W_in and W_out with f32 column scales under w8a8; f32
    biases), its ring state read and written once (bf16: the fixed rings'
    sum(dilsF) rows, the adaptive rings' maxd * dil + 1 rows a layer; the
    last two samples), its aux (bf16) and dilation factors (f32) read once
    a frame, and one int32 sample written for each useful sample."""
    L, R, S, Q, A = _widths(cfg)
    fixed, adaptive = dilations(cfg)
    w = 1 if quantize == "w8a8" else 2
    weights = L * (2 * R * 2 * R + R * (S + R)) * w
    if quantize == "w8a8":
        weights += L * (2 * R + S + R) * 4
    weights += L * A * 2 * R * 2 + L * (2 * R + R) * 4 + S * 4
    weights += Q * 2 * R * 2 + R * 4 + (S * S + Q * S) * 2 + (S + Q) * 4
    rows = sum(fixed) + sum(maxd * d + 1 for d in adaptive)
    state = 2 * (rows * B * R * 2 + 2 * B * 4)
    inputs = n_frames * B * (A * 2 + 4)
    return weights + state + inputs + n_samples * 4


def k1_bound(cfg, B: int, maxd: int, n_samples: int, n_frames: int,
             quantize: str):
    """(seconds, "bytes" or "operations"): the least time for a generation
    call that yields n_samples useful samples over n_frames frames, the
    larger of its bytes over the HBM rate and its useful operations at the
    peaks of their types."""
    b = k1_bytes(cfg, B, maxd, n_samples, n_frames, quantize) \
        / HBM_BYTES_PER_S
    o = seconds_at_peak(decode_flops(cfg, n_samples, n_frames), quantize)
    return (b, "bytes") if b >= o else (o, "operations")
