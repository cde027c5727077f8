"""Inputs that pin the edge cases of W2 (the Viterbi) and W4 (the
fractional-box smoothing) of `ops/world_kernel.py`, made from a seed with
numpy as float32 arrays.

W2's min over predecessors must keep the first index of exact ties and let
NaN win (LessOrNan), whatever order its lanes combine in; W4's sums must
keep their order through the register-blocked tiles, their remainders at
W = 513 and 1025 and offset counts that are not a multiple of the tile.
The CPU tests hold numpy models of the kernels' orders to the plain
versions on these inputs; chip_smoke.py phase 15 holds the kernels
themselves to the plain versions on them, on the card.
"""

from __future__ import annotations

import numpy as np

UNVOICED_COST = 0.35   # harvest's unvoiced and transition costs
TRANSITION_COST = 8.0


def viterbi_edge_inputs(seed: int, F: int, K: int):
    """(emits (F, K+1), logf (F, K), refined (F, K)) float32 for W2.

    Candidates come from four frequencies and emission costs from four
    values, so equal totals (ties between predecessors) are common; the
    unvoiced cost equals some emissions too.  Invalid candidates cost
    1e30 (absorbing small costs: more ties).  Planted from the middle on
    (F >= 16): a frame where every candidate costs 1e30, -0.0 emissions,
    +inf emissions in a few states (their totals tie at inf), a -inf logf
    (inf transitions), then near the end -inf in one candidate of two
    frames running (-inf - -inf: a NaN transition) and NaN emissions in
    the last frames; from the first NaN on, NaN wins every min."""
    rng = np.random.default_rng(seed)
    levels = np.array([100.0, 150.0, 200.0, 300.0], np.float32)
    refined = levels[rng.integers(0, len(levels), (F, K))]
    refined[rng.random((F, K)) < 0.2] = 0.0
    logf = np.log(np.maximum(refined, np.float32(1e-9))).astype(np.float32)
    costs = np.array([0.0, 0.25, 0.35, 0.5], np.float32)
    emits = np.empty((F, K + 1), np.float32)
    emits[:, 0] = UNVOICED_COST
    emits[:, 1:] = np.where(refined > 0,
                            costs[rng.integers(0, len(costs), (F, K))],
                            np.float32(1e30))
    if F >= 16 and K >= 1:
        m = F // 2
        emits[m, 1:] = 1e30
        emits[m + 1, rng.integers(0, K + 1, 2)] = -0.0
        emits[m + 2, 1 + rng.integers(0, K, max(1, K // 3))] = np.inf
        logf[m + 3, rng.integers(0, K)] = -np.inf
        tail = max(1, F // 32)
        logf[F - tail - 3: F - tail - 1, rng.integers(0, K)] = -np.inf
        rows = F - tail + rng.integers(0, tail, 2)
        emits[rows, rng.integers(0, K + 1, 2)] = np.nan
    return emits, logf, refined


def smooth_edge_inputs(seed: int, F: int, W: int, n_off: int):
    """(ext (F, W + n_off), ov (F, n_off)) float32 for W4: log-normal
    spectra and normalised box weights like the analysis's, with NaN,
    +-inf, +-0, 1e30 and subnormal values planted in the rows and zero,
    -0.0 and NaN weights in a few frames."""
    rng = np.random.default_rng(seed)
    ext = np.exp(rng.normal(0.0, 3.0, (F, W + n_off))).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, 1e-40,
                        -1.5], np.float32)
    n = max(1, ext.size // 400)
    ext.reshape(-1)[rng.integers(0, ext.size, n)] = \
        special[rng.integers(0, len(special), n)]
    ov = rng.random((F, n_off)).astype(np.float32)
    ov[ov < 0.3] = 0.0
    ov = (ov / np.maximum(ov.sum(1, keepdims=True), 1e-9)).astype(np.float32)
    if F >= 4:
        ov[1] = 0.0
        ov[2, rng.integers(0, n_off)] = -0.0
        ov[3, rng.integers(0, n_off)] = np.nan
    return ext, ov
