"""Continuous-F0 conversion (reference feature_extract.py:173-199):
voiced/unvoiced mask + linear interpolation over unvoiced gaps, with
start/end extension by the first/last voiced value."""

from __future__ import annotations

import logging

import numpy as np


def convert_continuous_f0(f0: np.ndarray):
    """Returns (uv, cont_f0) — matches the reference's exact semantics,
    including the degenerate all-unvoiced case returning the raw f0."""
    f0 = np.asarray(f0, dtype=np.float64)
    uv = np.float32(f0 != 0)
    if (f0 == 0).all():
        logging.warning("all of the f0 values are 0.")
        return uv, f0
    start_f0 = f0[f0 != 0][0]
    end_f0 = f0[f0 != 0][-1]
    cont_f0 = f0.copy()
    start_idx = np.where(cont_f0 == start_f0)[0][0]
    end_idx = np.where(cont_f0 == end_f0)[0][-1]
    cont_f0[:start_idx] = start_f0
    cont_f0[end_idx:] = end_f0
    nz_frames = np.where(cont_f0 != 0)[0]
    cont_f0 = np.interp(np.arange(len(cont_f0)), nz_frames, cont_f0[nz_frames])
    return uv, cont_f0


def smoothed_continuous_f0(f0: np.ndarray, shiftms: float,
                           cutoff: float = 20):
    """(uv, cont_f0_lpf): continuous-F0 low-passed at `cutoff` Hz; if the
    smoothing ringing drives any frame non-positive, retry with
    progressively wider cutoffs until the track stays positive (the
    reference's escalation policy, feature_extract.py:329-335)."""
    from qpnet_tpu_torch.dsp.filters import low_pass_filter

    uv, cont_f0 = convert_continuous_f0(f0)
    if not np.any(cont_f0 > 0):
        # fully-unvoiced input: no cutoff can make the track positive
        # (the reference's escalation would run the cutoff past Nyquist)
        return uv, cont_f0
    frame_rate = int(1.0 / (shiftms * 0.001))
    smoothed = low_pass_filter(cont_f0, frame_rate, cutoff=cutoff)
    widened = 70
    while not (smoothed > 0).all():
        if widened >= frame_rate / 2:
            # the widening escalation has reached Nyquist, where the
            # filter tends to identity — and the unfiltered continuous
            # track is strictly positive by construction, so use it
            # rather than crash firwin on a super-Nyquist cutoff
            logging.warning("cont-F0 smoothing stayed non-positive up to "
                            "Nyquist; using the unsmoothed track")
            smoothed = cont_f0
            break
        logging.info("cont-F0 smoothing went non-positive; widening the "
                     "low-pass cutoff to %d Hz", widened)
        smoothed = low_pass_filter(cont_f0, frame_rate, cutoff=widened)
        widened *= 2
    return uv, smoothed
