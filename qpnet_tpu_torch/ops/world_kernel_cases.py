"""Inputs that pin the edge cases of W1 (the candidate pooling), W2 (the
Viterbi), W3 (DIO's contour walks) and W4 (the fractional-box smoothing)
of `ops/world_kernel.py`, made from a seed with numpy as float32 arrays.

W1's rounds must keep exactly the ranks the serial walk keeps: ties on the
5% edge, duplicates, tiny candidates against the empty slots, NaN, +inf
(which turns the other slots to NaN in the plain version) and rank counts
around the warp's 32 lanes; past 16 slots (K up to 255, slots in shared
memory) a ladder of values 6% apart fills them.  W2's min over
predecessors and W3's nearest candidate must keep the first index of
exact ties and let NaN win (LessOrNan), whatever order their lanes, warps
or trees combine in (up to 256 states and 256 candidates); W3's walks
must carry their state through gaps at either end, sections of one or two
frames and NaN.  W4's sums must keep their order through the
register-blocked tiles, their remainders at W = 513 and 1025 and offset
counts that are not a multiple of the tile.
The CPU tests hold numpy models of the kernels' orders to the plain
versions on these inputs; chip_smoke.py phase 15 holds the kernels
themselves to the plain versions on them, on the card.  That phase and
tools/world_kernel_ab.py also share the recording of the wrappers' calls
in a pass and the kernels' device timing kept here.
"""

from __future__ import annotations

import numpy as np

PASS_SECONDS = (3.0, 10.0)   # the analysis passes timed (VCC2018 lengths)
# W3 inputs past its shared memory, (seed, F, C): 6,500 frames at C = 7,
# just past its 6,456, and 2,001 at C = 32
FIX_CONTOUR_LONG = [(30, 6500, 7), (31, 2001, 32)]
SPIN_CYCLES = 20_000_000   # about 10 ms of the device, longer than the
                           # host takes to queue the timed calls
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


AGREEMENT_THRESHOLD = 0.10   # harvest's agreement threshold
ALLOWED_RANGE = 0.10         # DIO's allowed range
SCREENED = 1e30              # a screened-out candidate's spread


def harvest_like_inputs(seed: int, F: int, K: int):
    """(refined (F, K), score (F, K)) float32 like harvest's: candidates
    around a wandering contour (distinct per frame), octave errors and
    misses, every fifth 40-frame stretch unvoiced; device_f0._viterbi makes
    W2's emits and logf of them."""
    rng = np.random.default_rng(seed)
    track = 150.0 * np.exp(np.cumsum(rng.normal(0, 0.02, F)))
    mult = rng.choice([1.0, 2.0, 0.5, 1.3], size=(F, K), p=[.4, .2, .2, .2])
    refined = track[:, None] * mult * (1 + rng.normal(0, 0.01, (F, K)))
    refined[rng.random((F, K)) < 0.25] = 0.0
    refined[(np.arange(F) // 40) % 5 == 4] = 0.0
    score = np.where(mult == 1.0, rng.uniform(0.6, 1.0, (F, K)),
                     rng.uniform(0.0, 0.7, (F, K)))
    return refined.astype(np.float32), score.astype(np.float32)


def pool_edge_inputs(seed: int, n_ch: int, F: int,
                     agreeing_inf: bool = False, ladder: int = 0):
    """(f_sorted, sp_sorted) (n_ch, F) float32 for W1, each frame's ranks
    sorted by spread (stably, NaN last), as device_f0._pool_candidates
    hands them over.  Per frame a base of 20 m Hz with candidates on the
    5% edge (21 m, 19 m: kept) and one ulp inside it (a duplicate), exact
    duplicates, octave errors, zeros and negatives, tiny candidates around
    0.05 * 1e-9 (dropped while a slot is empty: |f - 0| is under the
    empty slot's limit), NaN candidates and spreads; spreads from a few
    levels (0.1 is the threshold itself) or screened out.

    agreeing_inf also plants an agreeing +inf in frames 1 and 3: the plain
    version then adds 0 * inf = NaN to the other slots, whose duplicate
    tests then fail; and in frame 5 (F >= 6) the first three ranks +inf, a
    tiny candidate and +inf again, so that at K = 2 the tiny one, no
    longer a duplicate, takes the last slot before the second +inf could.  Harvest never
    lets one through (a candidate above f0_ceil is screened out), and
    jax_f0._pool_candidates under jax.jit keeps 0 there (XLA multiplies by
    the one-hot as a select), so only the port's plain version is the
    reference on these.

    ladder > 0 draws half of the candidates from base * 1.06**j, j = 1 ..
    ladder, instead (each 6% from the next, so no duplicates among them),
    enough distinct values to fill K slots past 16."""
    rng = np.random.default_rng(seed)
    m = rng.integers(4, 16, size=F).astype(np.float32)
    base = np.float32(20.0) * m
    lim0 = np.float32(0.05) * np.float32(1e-9)
    choices = np.stack([
        base, np.float32(21.0) * m, np.float32(19.0) * m,
        np.nextafter(np.float32(21.0) * m, np.float32(0.0)),
        np.float32(2.0) * base, np.float32(0.5) * base,
        base * np.float32(1.02),
        np.zeros(F, np.float32), np.full(F, -base[0], np.float32),
        np.full(F, np.nextafter(lim0, np.float32(0.0)), np.float32),
        np.full(F, lim0, np.float32), np.full(F, 1e-11, np.float32),
        np.full(F, 6e-11, np.float32), np.full(F, np.nan, np.float32)])
    pick = rng.choice(len(choices), size=(n_ch, F),
                      p=np.r_[[0.16] * 7, [0.04] * 7] / 1.4)
    f = choices[pick, np.arange(F)[None, :]].astype(np.float32)
    if ladder:
        steps = rng.integers(1, ladder + 1, (n_ch, F))
        rungs = (base[None, :] * np.float32(1.06) ** steps).astype(np.float32)
        f = np.where(rng.random((n_ch, F)) < 0.5, rungs, f)
    levels = np.array([0.01, 0.02, 0.05, AGREEMENT_THRESHOLD, 0.2,
                       SCREENED, np.nan], np.float32)
    sp = levels[rng.choice(len(levels), size=(n_ch, F),
                           p=[0.2, 0.2, 0.2, 0.15, 0.1, 0.1, 0.05])]
    if agreeing_inf and F >= 4:
        # first in one frame, after a kept one in the other
        rows = rng.integers(0, n_ch, 2)
        f[rows[0], 1], sp[rows[0], 1] = np.inf, 0.0
        f[rows[1], 3], sp[rows[1], 3] = np.inf, 0.03
    if agreeing_inf and F >= 6 and n_ch >= 3:
        f[:3, 5] = [np.inf, np.nextafter(lim0, np.float32(0.0)), np.inf]
        sp[:3, 5] = 0.0
    order = np.argsort(sp, axis=0, kind="stable")
    return (np.take_along_axis(f, order, 0),
            np.take_along_axis(sp, order, 0))


def fix_contour_edge_inputs(seed: int, F: int, C: int, kind: str = "mixed"):
    """(step2 (F,), cands_t (F, C)) float32 for W3.

    kind "mixed": voiced sections (step2 > 0) of 1-40 frames, some of one
    or two frames and some held at exactly 100 Hz, between gaps of 1-12
    frames; even seeds start and end in a gap, odd seeds voiced.  Each
    frame's candidates follow its contour with octave errors and invalid
    (0) bands; at the first gap frame after a section of three or more,
    two candidates lie the same distance (1 Hz) from the extrapolation
    (3 prev1 - prev2) / 2, and after a 100 Hz section one lies exactly
    the allowed 10% away.  NaN and +inf candidates and NaN in step2 are
    planted here and there (NaN at frame F - 2 from F >= 8 on).  kind
    "unvoiced": step2 all 0; "voiced": all voiced.

    Past 32 candidates (W3's lane blocks of ceil(C / 32)) a third candidate
    ties with the first two, next to one of them (so often in the same
    lane's block), and NaN and +inf are planted about once in 4 frames
    each rather than once in 40 candidates, so that ties still reach the
    selects."""
    rng = np.random.default_rng(seed)
    step2 = np.zeros(F, np.float32)
    track = 150.0 * np.exp(np.cumsum(rng.normal(0.0, 0.01, F)))
    if kind == "voiced":
        step2[:] = track
    elif kind == "mixed":
        t = int(rng.integers(1, 6)) if seed % 2 == 0 else 0
        while t < F:
            n = int(rng.choice([1, 2, 3, 5, 12, 40]))
            held = rng.random() < 0.25
            step2[t:t + n] = 100.0 if held else track[t:t + n]
            t += n + int(rng.integers(1, 13))
        if seed % 2 == 0:
            step2[-1] = 0.0
        else:
            step2[-1] = track[-1]
    cands = (track[:, None] * rng.choice([1.0, 1.0, 1.0, 2.0, 0.5, 0.0],
                                         size=(F, C))
             * (1.0 + rng.normal(0.0, 0.003, (F, C)))).astype(np.float32)
    cands[step2 == 100.0] = 100.0
    voiced = step2 > 0
    for t in range(3, F):
        if voiced[t] or not voiced[t - 3:t].all():
            continue
        # the forward walk's extrapolation at the first gap frame
        p1, p2 = step2[t - 1], step2[t - 2]
        ref = (p1 * np.float32(3.0) - p2) / np.float32(2.0)
        ks = rng.permutation(C)
        if p1 == p2 == 100.0:
            cands[t, ks[0]] = 110.0          # e / ref = 0.1: fails
            if C > 1:
                cands[t, ks[1]] = 90.0       # the same distance: ties
        elif C > 1:
            cands[t, ks[0]] = ref + np.float32(1.0)
            cands[t, ks[1]] = ref - np.float32(1.0)
            if C > 32:
                cands[t, ks[0] ^ 1 if ks[0] ^ 1 < C else ks[0] - 1] = \
                    ref - np.float32(1.0)
    n_bad = max(1, F * C // 40 if C <= 32 else F // 4)
    cands.reshape(-1)[rng.integers(0, F * C, n_bad)] = np.nan
    cands.reshape(-1)[rng.integers(0, F * C, n_bad)] = np.inf
    if kind == "mixed":
        step2[rng.integers(0, F, max(1, F // 50))] = np.nan
        if F >= 8:
            step2[F - 2] = np.nan
    return step2, cands


class recording:
    """Records [(kernel, args)] of every W1-W4 wrapper call made inside the
    block: the analysis calls the wrappers as `world_kernel.<name>`, so
    they are replaced by recording ones for its duration."""

    def __enter__(self):
        from qpnet_tpu_torch.ops import world_kernel as WK
        self.WK, self.calls = WK, []
        self.saved = {n: getattr(WK, n) for n in WK.KERNELS}
        for n, fn in self.saved.items():
            setattr(WK, n, self._recorder(n, fn))
        return self.calls

    def _recorder(self, name, fn):
        def call(*args):
            self.calls.append((name, args))
            return fn(*args)
        return call

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.WK, n, fn)


def device_ms(fn, calls: int = 10) -> float:
    """Device ms of one call of fn on the card: the mean over `calls` calls
    queued back to back behind a spin of the device, so that the CUDA
    events around them time the device and not the host's queueing."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls
