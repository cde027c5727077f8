"""PyTorch port: the orders of operations of the redesigned W1 (harvest's
candidate pooling), W2 (its Viterbi), W3 (DIO's contour walks) and W4 (the
fractional-box smoothing) in `qpnet_tpu_torch/csrc/world_kernel.cu`,
modelled in numpy and held bit for bit to the plain versions of
`qpnet_tpu_torch/ops/world_kernel.py` and (W1, W3) to the JAX stages.
(The wrappers' plain versions past W2's shared-memory capacity against JAX
are test_torch_port_world_viterbi_spill_s16.py and _s7.py: each case in a
file of its own, so that the test workers take them apart.)

The kernels build and run only on the card (chip_smoke.py phase 15 holds
them to the plain versions there, on these tests' inputs too); these
models show on the CPU that the redesigned orders give the plain versions'
bits:
  * W2's min over predecessors, P lanes a state (`viterbi_lanes`), each
    lane a first-index min over its block of predecessors as a tree, then
    a butterfly over the P lanes whose ties go to the lower block (so the
    first index wins with no index compare), equals `torch.min(dim=1)`'s
    values (bits) and indices on rows with planted ties, NaN, +-inf, +-0
    and 1e30 (hypothesis, S = 1..16); the whole kernel (that min, the
    emission add, the segmented back-track of G = 128 // S segments) gives
    the plain version's back-pointers, states and f0 bit for bit;
  * W4's register-blocked loop (SMOOTH_R bins a thread over a 16-byte
    window, the offsets 4 at a time then the remainder, the staged row's
    padding never reaching a stored bin) equals `smooth_reference` bit for
    bit at CheapTrick's and D4C's widths and offset counts;
  * W1's ballot rounds (a warp a frame, lane r holding ranks r, r + 32,
    ..; the lowest lane past the last kept whose rank agrees and is no
    duplicate is the next kept; each lane then tests the new slot only)
    give `pool_reference`'s slots, +inf's NaN slots included, and inside
    device_f0's stage JAX's `_pool_candidates`, at 1-97 ranks and K 1-16;
  * W3's walks (step 3 starting as each frame's value where the carry
    cannot reach it; frame by frame only where it can, the nearest
    candidate a tree of selects over CW slots in registers, the halving a
    multiply by 0.5; the runs between jumped 32 frames a ballot, the carry
    read back from step 3; the backward walk on the forward's step 3 in
    place) give `fix_contour_reference`'s contour, and inside device_f0's
    stage JAX's `_fix_contour_scan`, at C = 1-32.
Tolerances: none; every comparison is of bits (float32 viewed as int32),
except that W4's NaN outputs are compared as NaN: on the CPU the sign of a
NaN that an add of two NaNs returns depends on the operand order of the
vector instruction (x86 returns the first operand's), while the card's
float32 arithmetic returns one canonical NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from qpnet_tpu.dsp.world import jax_f0
from qpnet_tpu_torch.dsp.world import device_f0
from qpnet_tpu_torch.ops import world_kernel as WK
from qpnet_tpu_torch.ops import world_kernel_cases as CASES
from torch_port_threads import one_thread  # noqa: F401

TC, UC = CASES.TRANSITION_COST, CASES.UNVOICED_COST
VIT_THREADS = 128    # csrc VIT_THREADS: the back-track's threads
SMEM_MAX = WK.SMEM_MAX   # shared memory an H100 block may use


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _replaces(v, b):
    """csrc replaces(): v, at later indices, replaces b (less, or NaN over
    non-NaN)."""
    return np.isnan(v) & ~np.isnan(b) | (v < b)


def _positions(P):
    """csrc vit_positions: positions a lane holds for every S that P
    serves."""
    return -(-min(16, 32 // P) // P)


def lane_min(tot):
    """W2's min over predecessors as the kernel's warp takes it: tot (R, S)
    rows, one per state.  Up to VITERBI_NARROW states, lane q of the
    state's P lanes holds positions q * NPOS .. q * NPOS + NPOS - 1 (csrc
    vit_positions: NPOS fixed by P; a position past S holds a +inf that
    never wins) and takes their first-index min as a tree over positions;
    past it (the wide build: P lanes of 8 warps, csrc vitw_lanes) lane q
    walks q * NP .. q * NP + NP - 1, NP = ceil(S / P), in index order from
    +inf, taking a pair where it replaces the running one.  The butterfly
    over offsets 1, 2, .. < P then makes the kernel's select (csrc
    replaces() with the lane's side of the partner), so ties go to the
    lower block, with the index riding along.  Returns (values (R,),
    indices (R,))."""
    R, S = tot.shape
    P = WK.viterbi_lanes(S)
    q = np.arange(P)
    if S <= WK.VITERBI_NARROW:
        NPM = _positions(P)
        pos = q[:, None] * NPM + np.arange(NPM)[None, :]     # (P, NPOS)
        ok = pos < S
        v = np.where(ok[None], tot[:, np.minimum(pos, S - 1)], np.inf)
        ix = np.broadcast_to(pos, v.shape).copy()
        w = 1
        while w < NPM:
            for k in range(0, NPM - w, 2 * w):
                take = _replaces(v[..., k + w], v[..., k])
                v[..., k] = np.where(take, v[..., k + w], v[..., k])
                ix[..., k] = np.where(take, ix[..., k + w], ix[..., k])
            w *= 2
        best, idx = v[..., 0].astype(np.float32), ix[..., 0]
    else:
        NP = -(-S // P)
        best = np.full((R, P), np.inf, np.float32)
        idx = np.broadcast_to(q * NP, (R, P)).copy()
        for k in range(NP):
            p = q * NP + k
            real = p < S
            v = np.where(real[None], tot[:, np.minimum(p, S - 1)], np.inf)
            take = real[None] & _replaces(v, best)
            best = np.where(take, v, best).astype(np.float32)
            idx = np.where(take, p[None], idx)
    off = 1
    while off < P:
        bo, io = best[:, q ^ off], idx[:, q ^ off]
        # the kernel's select: an upper lane keeps its pair only where it
        # replaces the lower partner's; a lower lane takes the upper's only
        # where that replaces its own
        take = np.where((q & off) != 0, ~_replaces(best, bo),
                        _replaces(bo, best))
        best, idx = np.where(take, bo, best), np.where(take, io, idx)
        off *= 2
    # every lane of the state now holds the same pair
    assert (idx == idx[:, :1]).all()
    return best[:, 0], idx[:, 0]


SPECIAL = [np.nan, np.inf, -np.inf, 1e30, -1e30, 0.0, -0.0, 0.35, 0.5, 1.0]


@settings(max_examples=200, deadline=None)
@given(S=st.integers(1, 16), R=st.integers(1, 6), data=st.data())
def test_lane_min_equals_torch_min(S, R, data):
    vals = data.draw(st.lists(
        st.one_of(st.sampled_from(SPECIAL),
                  st.floats(-4.0, 4.0, width=32)),
        min_size=R * S, max_size=R * S))
    tot = np.array(vals, np.float32).reshape(R, S)
    want_v, want_i = torch.min(torch.from_numpy(tot), dim=1)
    got_v, got_i = lane_min(tot)
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v.numpy()))
    np.testing.assert_array_equal(got_i, want_i.numpy())


@pytest.mark.parametrize("S", range(1, 17))
def test_lane_min_ties_keep_the_first_index(S):
    """All-equal rows, a row of NaNs, -0.0 against +0.0 and inf rows: the
    first index wins each (S = 1..16, every lane layout)."""
    rows = np.stack([np.full(S, 0.35), np.full(S, np.nan), np.full(S, np.inf),
                     np.where(np.arange(S) % 2, -0.0, 0.0),
                     np.where(np.arange(S) >= S // 2, np.nan, 1.0)])
    tot = rows.astype(np.float32)
    want_v, want_i = torch.min(torch.from_numpy(tot), dim=1)
    got_v, got_i = lane_min(tot)
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v.numpy()))
    np.testing.assert_array_equal(got_i, want_i.numpy())
    assert list(got_i[:3]) == [0, 0, 0]


def plain_backs(emits, logf, tc, uc):
    """viterbi_reference's forward loop, returning its back-pointers
    (F - 1, S) and its last costs."""
    e, lf = torch.from_numpy(emits), torch.from_numpy(logf)
    F, S = e.shape
    trans = torch.full((F - 1, S, S), uc)
    trans[:, 0, 0] = 0.0
    trans[:, 1:, 1:] = tc * torch.abs(lf[1:, :, None] - lf[:-1, None, :])
    cost, backs = e[0], []
    for t in range(1, F):
        best, bp = torch.min(cost[None, :] + trans[t - 1], dim=1)
        cost = best + e[t]
        backs.append(bp)
    backs = (torch.stack(backs).numpy() if backs
             else np.zeros((0, S), np.int64))
    return backs, cost.numpy()


def viterbi_model(emits, logf, refined, tc, uc):
    """The kernel's W2 in numpy: per frame the producers' transitions
    (0, uc, or tc * |logf_t[s-1] - logf_{t-1}[p-1]|, each product and
    difference rounded in float32), the chain's lane_min over the previous
    costs plus those, and the emission add; the last frame's first-index
    argmin; the back-track in G = viterbi_threads(S) // S segments (128 //
    S up to VITERBI_NARROW states, 256 // S past it; each segment's map
    from end states to start states, chained from the last frame, then
    each segment walked again).  Returns (back-pointers, states, f0)."""
    F, S = emits.shape
    tc32, uc32 = np.float32(tc), np.float32(uc)
    s_ix, p_ix = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    cost = emits[0].copy()
    back = np.zeros((F - 1, S), np.int64)
    with np.errstate(all="ignore"):
        for t in range(1, F):
            tr = np.where((s_ix == 0) | (p_ix == 0),
                          np.where((s_ix == 0) & (p_ix == 0),
                                   np.float32(0.0), uc32), np.float32(0.0))
            if S > 1:
                d = logf[t][:, None] - logf[t - 1][None, :]
                tr[1:, 1:] = tc32 * np.abs(d)
            tot = (cost[None, :] + tr).astype(np.float32)
            best, bp = lane_min(tot)
            cost = (best + emits[t]).astype(np.float32)
            back[t - 1] = bp
    last = 0
    for s in range(1, S):
        if np.isnan(cost[s]) and not np.isnan(cost[last]) \
                or cost[s] < cost[last]:
            last = s
    rows = F - 1
    G = WK.viterbi_threads(S) // S
    assert G >= 1
    seg = -(-rows // G) if rows else 0
    bounds = [(min(g * seg, rows), min(min(g * seg, rows) + seg, rows))
              for g in range(G)]
    maps = np.zeros((G, S), np.int64)
    for g, (a, e) in enumerate(bounds):
        for s0 in range(S):
            x = s0
            for u in range(e, a, -1):
                x = back[u - 1, x]
            maps[g, s0] = x
    ends, x = [0] * G, last
    for g in range(G - 1, -1, -1):
        ends[g], x = x, maps[g, x]
    states = np.zeros(F, np.int64)
    for g, (a, e) in enumerate(bounds):
        x = ends[g]
        for u in range(e, a, -1):
            states[u], x = x, back[u - 1, x]
        if g == 0:
            states[0] = x
    f0 = np.zeros(F, np.float32)
    v = states > 0
    f0[v] = refined[np.arange(F)[v], states[v] - 1]
    return back, states, f0


@pytest.mark.parametrize("seed,F,K", [
    (0, 1, 6), (1, 2, 6), (2, 33, 6), (3, 601, 6), (4, 200, 15),
    (5, 97, 4), (6, 130, 2), (7, 150, 3), (8, 260, 8), (9, 129, 1)])
def test_viterbi_model_bit_equal_to_plain(seed, F, K):
    emits, logf, refined = CASES.viterbi_edge_inputs(seed, F, K)
    back, states, f0 = viterbi_model(emits, logf, refined, TC, UC)
    want_back, _ = plain_backs(emits, logf, TC, UC)
    np.testing.assert_array_equal(back, want_back)
    want = WK.viterbi_reference(torch.from_numpy(emits),
                                torch.from_numpy(logf),
                                torch.from_numpy(refined), TC, UC).numpy()
    np.testing.assert_array_equal(_bits(f0), _bits(want))
    if F >= 200:
        # the planted cases reach the mins: ties, inf and the NaN tail
        assert (states > 0).any() and (states == 0).any()


def test_viterbi_edge_inputs_plant_nan_and_ties():
    emits, logf, refined = CASES.viterbi_edge_inputs(3, 601, 6)
    _, cost = plain_backs(emits, logf, TC, UC)
    assert np.isnan(emits).any() and np.isneginf(logf).any()
    assert np.isnan(cost).all()          # NaN won from the tail on
    _, idx = np.unique(emits[:, 1:], return_counts=True)
    assert idx.max() > 100               # repeated emission costs: ties


@pytest.mark.parametrize("K", range(0, 16))
def test_viterbi_shared_memory_fits(K):
    """The kernel's shared memory at the largest unspilled length fits a
    block (csrc vit_layout): barriers and maps, a ring of 4 stages of 32
    frames (transitions for 32 lanes x NPOS, emissions, logf rows), and the
    back-pointers."""
    S = K + 1
    P = WK.viterbi_lanes(S)
    NP = _positions(P)
    assert NP * P >= S
    F = WK.VITERBI_BACK_SMEM // S + 1
    assert not WK.viterbi_spills(F, K) and WK.viterbi_spills(F + 1, K)
    assert S * P <= 32 and (P == 32 or S * 2 * P > 32)
    head = 2 * 4 * 8 + (2 * VIT_THREADS + 4) * 4
    ring = 4 * 32 * (NP * 32 + S) * 4 + 4 * 33 * K * 4
    assert head + ring + (F - 1) * S <= SMEM_MAX


# ---------------------------------------------------------------------------
# W4
# ---------------------------------------------------------------------------

def smooth_model(ext, ov, items=1):
    """The kernel's W4 in numpy: blocks of SMOOTH_THREADS * items
    consecutive (frame, group) items, each the SMOOTH_R bins 4*gi .. of its frame; the
    block's rows staged rs floats apart, only the columns its items read
    (the first row from its first group's bin, the last to its last
    group's window), NaN elsewhere (the kernel's unstaged shared memory
    holds anything), the weights os apart likewise; offsets j0 = 0, 4, .. while 4 fit, with the window
    a (4 values) and b (the next 4), then the n_off % 4 left; each
    acc[r] += w[j] * x[j + r] rounded twice; a bin past W is not stored."""
    F, n_off = ov.shape
    W = ext.shape[1] - n_off
    L = WK.smooth_layout(F, W, n_off, items)
    block = WK.SMOOTH_THREADS * items
    ng, rs, os_ = L["ng"], L["rs"], L["os"]
    out = np.full((F, W), np.nan, np.float32)
    total = F * ng
    for g0 in range(0, total, block):
        g = np.arange(g0, min(g0 + block, total))
        f_first, f_last = g0 // ng, min((g0 + block - 1) // ng, F - 1)
        assert f_last - f_first + 1 <= L["rows"]
        # the staged columns: the first row from its first group's bin,
        # the last up to its last group's window; NaN elsewhere
        g_last = min(g0 + block, total) - 1
        c_first = WK.SMOOTH_R * (g0 - f_first * ng)
        c_last = min(W + n_off,
                     WK.SMOOTH_R * (g_last - f_last * ng) + n_off + 3)
        s_ext = np.full((f_last - f_first + 1, rs), np.nan, np.float32)
        for r in range(f_last - f_first + 1):
            c0 = c_first if r == 0 else 0
            c1 = c_last if r == f_last - f_first else W + n_off
            s_ext[r, :c1 - c0] = ext[f_first + r, c0:c1]
        s_ov = np.full((f_last - f_first + 1, os_), np.nan, np.float32)
        s_ov[:, :n_off] = ov[f_first: f_last + 1]
        f, gi = g // ng, g % ng
        row = f - f_first
        base = WK.SMOOTH_R * gi - np.where(row == 0, c_first, 0)
        acc = np.zeros((len(g), WK.SMOOTH_R), np.float32)

        def window(j):       # a float4 load at base + j (16-byte aligned)
            assert ((base + j) % 4 == 0).all() and (base + j + 4 <= rs).all()
            return s_ext[row[:, None], (base + j)[:, None] + np.arange(4)]

        def step(j0, m, a, b):
            x = np.concatenate([a, b], axis=1)
            w = s_ov[row, j0: j0 + 4]
            for jj in range(m):
                for r in range(WK.SMOOTH_R):
                    acc[:, r] = acc[:, r] + w[:, jj] * x[:, jj + r]
        with np.errstate(all="ignore"):
            a, j0 = window(0), 0
            while j0 + 4 <= n_off:
                b = window(j0 + 4)
                step(j0, 4, a, b)
                a, j0 = b, j0 + 4
            if j0 < n_off:
                step(j0, n_off - j0, a, window(j0 + 4))
        for r in range(WK.SMOOTH_R):
            ok = WK.SMOOTH_R * gi + r < W
            out[f[ok], (WK.SMOOTH_R * gi + r)[ok]] = acc[ok, r]
    return out


@pytest.mark.parametrize("items", [1, 2, 4])
@pytest.mark.parametrize("F,W,n_off", [
    (37, 513, 20),      # CheapTrick at 22,050 Hz: fftl 1024, kmax 10
    (23, 1025, 42),     # D4C: fftd 2048, kmax 21 (42 % 4 = 2)
    (11, 1025, 98),     # D4C with f0_ceil 1000 Hz: kmax 49
    (9, 257, 30),       # 16 kHz CheapTrick, fftl 512 (kmax 15: 30 % 4 = 2)
    (5, 7, 6),          # a frame shorter than two bin groups
    (3, 2, 1)])         # one offset: the remainder alone
def test_smooth_model_bit_equal_to_plain(F, W, n_off, items):
    ext, ov = CASES.smooth_edge_inputs(F * W + n_off, F, W, n_off)
    got = smooth_model(ext, ov, items)
    want = WK.smooth_reference(torch.from_numpy(ext),
                               torch.from_numpy(ov)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(_bits(np.where(np.isnan(got), 0.0, got)),
                                  _bits(np.where(np.isnan(want), 0.0, want)))
    assert np.isnan(got).any() == np.isnan(ext).any()


def test_smooth_edge_inputs_reach_the_sums():
    """The planted values reach the outputs: NaN and inf bins, zero rows,
    and finite bins elsewhere."""
    ext, ov = CASES.smooth_edge_inputs(1, 23, 1025, 42)
    out = WK.smooth_reference(torch.from_numpy(ext),
                              torch.from_numpy(ov)).numpy()
    assert np.isnan(out).any() and np.isinf(out).any()
    assert (out[1] == 0).all() and np.isfinite(out[5:]).mean() > 0.5


@pytest.mark.parametrize("items", [1, 2, 4])
@pytest.mark.parametrize("W,n_off", [(513, 20), (1025, 42), (1025, 98),
                                     (2, 1), (7, 6)])
def test_smooth_layout_fits_a_block(W, n_off, items):
    """Every block's items span at most `rows` frames (checked over all
    block starts), the staged rows keep the last group's window inside
    them, and the shared memory fits a block."""
    L = WK.smooth_layout(10_000, W, n_off, items)
    ng, block = L["ng"], WK.SMOOTH_THREADS * items
    spans = [(g0 + block - 1) // ng - g0 // ng + 1
             for g0 in range(0, 4 * ng * block, block)]
    assert max(spans) <= L["rows"]
    last_read = WK.SMOOTH_R * (ng - 1) + (n_off - 1) // 4 * 4 + 8
    assert last_read <= L["rs"] and L["rs"] % 4 == 0 and L["os"] % 4 == 0
    assert L["bytes"] <= SMEM_MAX


def test_smooth_layout_past_a_block_is_refused():
    """Rows too short for a bin group to span a block's frames, with many
    offsets, need more shared memory than a block has: the kernel's entry
    point refuses such a shape before it launches (cudaErrorInvalidValue,
    which the wrapper raises)."""
    assert WK.smooth_layout(1000, 1, 400)["bytes"] > SMEM_MAX
    assert WK.smooth_layout(3, 1, 400)["rows"] == 3


# ---------------------------------------------------------------------------
# W1
# ---------------------------------------------------------------------------

F32 = np.float32
THR = CASES.AGREEMENT_THRESHOLD
ALLOWED = CASES.ALLOWED_RANGE


def _pool_dup(f, p):
    """csrc pool_dup: |f - p| < 0.05 * clamp_min(p, 1e-9), each step
    rounded in float32 (np.maximum keeps NaN, as clamp_min does)."""
    with np.errstate(all="ignore"):
        return np.abs(f - p) < F32(0.05) * np.maximum(p, F32(1e-9))


def pool_model(f_sorted, sp_sorted, thr, K):
    """The kernel's W1 in numpy: a warp a frame; lane r holds rank r0 + r
    of each group of 32 ranks, its ok (spread <= thr, f > 0) and its dup
    flag against all K slots (the empty ones hold 0); rounds: the lowest
    lane past the last kept with ok and not dup is kept (__ffs of a
    ballot), its f broadcast, slot n taking 0 + f and the others + 0 * f
    (NaN for +inf), and each lane's dup ORed with its test against the new
    slot alone (reset first when the kept f is +inf: every other slot is
    then NaN); the groups stop once K are kept.  Past POOL_REGS slots the
    kernel keeps them in shared memory, lane l adding to slots l, l + 32,
    .. in a round (each slot still one add a round) and every lane reading
    each slot for its tests.  Returns (F, K)."""
    n_ch, F = f_sorted.shape
    thr = F32(thr)
    lanes = np.arange(32)
    out = np.zeros((F, K), F32)
    with np.errstate(all="ignore"):
        for t in range(F):
            p, n = np.zeros(K, F32), 0
            for r0 in range(0, n_ch, 32):
                if n >= K:
                    break
                r = r0 + lanes
                valid = r < n_ch
                f = np.where(valid, f_sorted[np.minimum(r, n_ch - 1), t],
                             F32(0.0))
                sp = np.where(valid, sp_sorted[np.minimum(r, n_ch - 1), t],
                              F32(0.0))
                ok = valid & (sp <= thr) & (f > 0)
                dup = np.zeros(32, bool)
                for k in range(K):
                    dup |= _pool_dup(f, p[k])
                m = ok & ~dup
                while m.any() and n < K:
                    src = int(np.argmax(m))
                    fn = f[src]
                    if K <= WK.POOL_REGS:
                        p = p + np.where(np.arange(K) == n, fn,
                                         F32(0.0) * fn)
                    else:
                        for lane in range(32):
                            ks = np.arange(lane, K, 32)
                            p[ks] = p[ks] + np.where(ks == n, fn,
                                                     F32(0.0) * fn)
                    pn, n = p[n], n + 1
                    dup = (np.zeros(32, bool) if np.isinf(fn) else dup) \
                        | _pool_dup(f, pn)
                    m = ok & ~dup & (lanes > src)
            out[t] = p
    return out


POOL_CASES = [(0, 81, 37, 6), (1, 1, 9, 1), (2, 31, 17, 6), (3, 33, 16, 15),
              (4, 97, 23, 16), (5, 81, 8, 16), (6, 40, 1, 6), (7, 64, 12, 1),
              (8, 33, 9, 2)]


@pytest.mark.parametrize("seed,n_ch,F,K", POOL_CASES)
def test_pool_model_bit_equal_to_plain_with_agreeing_inf(seed, n_ch, F, K):
    """With an agreeing +inf planted, the model keeps the plain version's
    NaN slots (0 * inf added to the slots it does not fill)."""
    f, sp = CASES.pool_edge_inputs(seed, n_ch, F, agreeing_inf=True)
    got = pool_model(f, sp, THR, K)
    want = WK.pool_reference(torch.from_numpy(f), torch.from_numpy(sp), THR,
                             K).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed,n_ch,F,K", POOL_CASES)
def test_pool_model_bit_equal_to_plain_and_jax(seed, n_ch, F, K,
                                                monkeypatch):
    f, sp = CASES.pool_edge_inputs(seed, n_ch, F)
    got = pool_model(f, sp, THR, K)
    want = WK.pool_reference(torch.from_numpy(f), torch.from_numpy(sp), THR,
                             K).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # inside the stage (device_f0 sorts by spread, stably, then calls W1)
    # against JAX's: the inputs are already in spread order
    monkeypatch.setattr(device_f0.world_kernel, "pool", lambda a, b, c, k:
                        torch.from_numpy(pool_model(a.numpy(), b.numpy(),
                                                    c, k)))
    stage = device_f0._pool_candidates(torch.from_numpy(f),
                                       torch.from_numpy(sp), THR, K).numpy()
    jax_out = np.asarray(jax_f0._pool_candidates(jnp.asarray(f),
                                                 jnp.asarray(sp), THR, K))
    np.testing.assert_array_equal(_bits(stage), _bits(got))
    np.testing.assert_array_equal(_bits(jax_out), _bits(got))


def test_pool_edge_inputs_reach_the_rules():
    """The planted cases reach the kept slots: an agreeing +inf turns the
    other slots to NaN, tiny candidates are dropped while a slot is empty,
    rows fill to K."""
    f, sp = CASES.pool_edge_inputs(0, 81, 37, agreeing_inf=True)
    out = WK.pool_reference(torch.from_numpy(f), torch.from_numpy(sp), THR,
                            6).numpy()
    assert np.isinf(out).any() and np.isnan(out).any()
    lim0 = F32(0.05) * F32(1e-9)
    agree = (f > 0) & (sp <= THR)
    below, at = agree & (f < lim0), agree & (f >= lim0) & (f < 1e-9)
    assert below.any() and not np.isin(out, f[below]).any()
    assert np.isin(out, f[at]).any()
    assert ((out > 0).sum(1) == 6).any() and (out == 0).any()
    assert np.isnan(sp).any() and np.isnan(f).any()
    # frame 5 at K = 2: the tiny rank fills slot 1, so the second +inf is
    # not kept and slot 0 stays +inf
    f, sp = CASES.pool_edge_inputs(8, 33, 9, agreeing_inf=True)
    out = WK.pool_reference(torch.from_numpy(f), torch.from_numpy(sp), THR,
                            2).numpy()
    assert np.isinf(out[5, 0]) and np.isnan(out[5, 1])


def test_pool_keeps_exactly_the_5_percent_edge():
    """A rank 5% from a kept one stays (|f - p| equals the limit); one ulp
    inside is a duplicate; below 0.05f * 1e-9f a candidate is a duplicate
    of the empty slots, at it one is kept: the model as the plain
    version."""
    lim0 = F32(0.05) * F32(1e-9)
    f = np.array([[100.0, lim0, lim0], [105.0, 100.0, 1.0],
                  [np.nextafter(F32(105.0), F32(0.0)), 0.0, 0.0],
                  [np.nextafter(lim0, F32(0.0)), 0.0, 0.0]], F32)
    sp = np.full_like(f, 0.05)
    got = pool_model(f, sp, THR, 4)
    want = WK.pool_reference(torch.from_numpy(f), torch.from_numpy(sp), THR,
                             4).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(got[0], [100.0, 105.0, 0.0, 0.0])
    assert got[1, 0] == lim0 and got[2, 0] == lim0


def test_pool_max_ranks_fits_a_block():
    """W1's block stages n_ch x (POOL_TILE + 1) f and sp values: at the
    limit they fit a block's shared memory, one more rank does not."""
    n = WK.pool_max_ranks()
    row = 2 * (WK.POOL_TILE + 1) * 4
    assert n * row <= SMEM_MAX < (n + 1) * row and n >= 97


# ---------------------------------------------------------------------------
# W3
# ---------------------------------------------------------------------------

def select_tree(e, c):
    """csrc fix_select's arg-min: a tree over the CW slots, the upper
    half's pair taken only where it comes strictly first (replaces: NaN
    first, ties to the lower index), the candidate c riding along.
    Returns (e, c) of the winner."""
    e, c = np.array(e, F32), np.array(c, F32)
    w = 1
    while w < len(e):
        for k in range(0, len(e) - w, 2 * w):
            if _replaces(e[k + w], e[k]):
                e[k], c[k] = e[k + w], c[k + w]
        w *= 2
    return e[0], c[0]


def select_lanes(e, c):
    """csrc fix_select past FIX_NARROW candidates: e, c (C,) split over 32
    lanes in blocks of m = ceil(C / 32) (lane l: l * m .. l * m + m - 1,
    in FIX_LANE_SLOTS = 8 slots, +inf past its block), each lane's tree
    (select_tree), then the butterfly over offsets 1, 2, .., 16: the upper
    lane of a pair keeps its own only where it replaces the lower's, the
    lower takes the upper's only where it replaces its own, the candidate
    riding along.  Returns (e, c) of the winner, which every lane holds."""
    C = len(e)
    m = WK.fix_contour_block(C)
    lanes = []
    for lane in range(32):
        el = np.full(8, np.inf, F32)
        cl = np.zeros(8, F32)
        blk = slice(lane * m, min(lane * m + m, C))
        n = len(range(C)[blk])
        el[:n], cl[:n] = e[blk], c[blk]
        lanes.append(select_tree(el, cl))
    be = np.array([x[0] for x in lanes], F32)
    bc = np.array([x[1] for x in lanes], F32)
    q = np.arange(32)
    off = 1
    while off < 32:
        eo, co = be[q ^ off], bc[q ^ off]
        take = np.where((q & off) != 0, ~_replaces(be, eo),
                        _replaces(eo, be))
        be, bc = np.where(take, eo, be), np.where(take, co, bc)
        off *= 2
    assert (_bits(be) == _bits(be[0])).all()
    assert (_bits(bc) == _bits(bc[0])).all()
    return be[0], bc[0]


def fix_select_model(prev1, prev2, cv, C, allowed, stats=None):
    """csrc fix_select on one frame's CW slots cv (the first C real): the
    extrapolation with the halving as a multiply by 0.5, errors |ref - c|
    (+inf past C), the tree, the fail test's IEEE division; past
    FIX_NARROW candidates cv is the frame's C candidates and the arg-min
    is select_lanes'."""
    CW = len(cv)
    with np.errstate(all="ignore"):
        ref = (prev1 * F32(3.0) - prev2) * F32(0.5)
        e = np.where(np.arange(CW) < C, np.abs(ref - cv), F32(np.inf))
        e = e.astype(F32)
        eb, cb = (select_tree(e, cv) if C <= WK.FIX_NARROW
                  else select_lanes(e, cv))
        cr = ref if np.isnan(ref) else max(ref, F32(1e-12))
        fail = eb / cr >= F32(allowed)
    if stats is not None:
        real = e[:C]
        stats["selects"] += 1
        stats["nan"] += bool(np.isnan(eb))
        stats["ties"] += bool(not np.isnan(eb)
                              and (real == eb).sum() > 1)
        stats["fails"] += bool(fail)
    return F32(0.0) if fail else cb


def _next(s2, t, end, want):
    """csrc fix_next: the first frame u in [t, end) with (s2[u] > 0) ==
    want, or end, 32 frames a ballot."""
    for t0 in range(t, end, 32):
        u = np.arange(t0, min(t0 + 32, end))
        hit = (s2[u] > 0) == want
        if hit.any():
            return int(u[np.argmax(hit)])
    return end


def _prev(s2, t, lo, want):
    """csrc fix_prev: the last frame u in [lo, t] with (s2[u] > 0) ==
    want, or lo - 1."""
    for t0 in range(t, lo - 1, -32):
        u = np.arange(t0, max(t0 - 32, lo - 1), -1)
        hit = (s2[u] > 0) == want
        if hit.any():
            return int(u[np.argmax(hit)])
    return lo - 1


def fix_contour_model(step2, cands_t, allowed, stats=None):
    """The kernel's W3 in numpy: s3 starts as step2 where inside and 0
    elsewhere (the value of every frame the carry does not reach); the
    forward walk selects at a gap frame while the chain is alive and at
    a section's first frame that a surviving chain reaches, writing s3,
    and otherwise jumps a section to its next gap or a dead gap to its
    next section (fix_next), reading (prev1, prev2) back from s3; the
    backward walk, on the same s3 in place, selects at gap frames while
    alive and jumps the rest (fix_prev), down to frame 1.  Each select on
    the CW slots of the frame's row (csrc fix_row: 0 past C; past
    FIX_NARROW the row's C candidates, which select_lanes splits over the
    lanes).  Returns s3, which the kernel writes to out."""
    F, C = cands_t.shape
    CW = WK.fix_contour_slots(C) if C <= WK.FIX_NARROW else C
    rows = np.zeros((F, CW), F32)
    rows[:, :C] = cands_t
    s2 = step2
    with np.errstate(invalid="ignore"):
        s3 = np.where(s2 > 0, s2, F32(0.0)).astype(F32)

    def select(p1, p2, t):
        return fix_select_model(p1, p2, rows[t], C, allowed, stats)

    prev2 = prev1 = F32(0.0)
    alive = was_gap = False
    t = 0
    while t < F:
        inside = bool(s2[t] > 0)
        if (inside and was_gap and alive) or (
                not inside and alive and bool(prev1 > 0)):
            v = select(prev1, prev2, t)
            s3[t] = v
            alive, was_gap = inside or bool(v > 0), not inside
            prev2, prev1, t = prev1, v, t + 1
            continue
        t = _next(s2, t + 1, F, not inside)
        alive, was_gap = inside, not inside
        if t < F:
            prev1, prev2 = s3[t - 1], s3[t - 2] if t >= 2 else F32(0.0)

    prev2 = prev1 = F32(0.0)
    alive = False
    t = F - 1
    while t >= 1:
        inside = bool(s2[t] > 0)
        if not inside and alive and bool(prev1 > 0):
            v = select(prev1, prev2, t)
            s3[t] = v
            alive = bool(v > 0)
            prev2, prev1, t = prev1, v, t - 1
            continue
        t = _prev(s2, t - 1, 1, not inside)
        alive = inside
        if t >= 1:
            prev1 = s3[t + 1]
            prev2 = s3[t + 2] if t + 2 < F else F32(0.0)
    return s3


SPECIAL_E = [np.nan, np.inf, 0.0, 1.0, 1e30, 0.5, 2.0 ** -149]


@settings(max_examples=300, deadline=None)
@given(C=st.integers(1, 32), data=st.data())
def test_select_tree_equals_torch_argmin(C, data):
    """The tree over CW = 8, 16 or 32 slots (+inf past C) picks the pair
    torch.argmin picks over the C real errors: NaN first, ties to the
    first index."""
    vals = data.draw(st.lists(
        st.one_of(st.sampled_from(SPECIAL_E),
                  st.floats(0.0, 4.0, width=32)), min_size=C, max_size=C))
    CW = WK.fix_contour_slots(C)
    e = np.full(CW, np.inf, F32)
    e[:C] = vals
    _, idx = select_tree(e, np.arange(CW, dtype=F32))
    want = int(torch.argmin(torch.tensor(e[:C])))
    assert int(idx) == want


def test_halving_by_multiply_is_bit_equal():
    """x / 2 and x * 0.5 are the same exact value, each correctly rounded,
    so the same bits for every float32 (subnormals, the largest, +-inf;
    NaN stays NaN): numpy's and PyTorch's float32 division and multiply."""
    rng = np.random.default_rng(15)
    x = rng.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(
        np.uint32).view(F32)
    x = np.concatenate([x, np.array([0.0, -0.0, 2.0 ** -149, -(2.0 ** -149),
                                     2.0 ** -126, 3.0 * 2.0 ** -149,
                                     np.finfo(F32).max, np.inf, -np.inf,
                                     np.nan], F32)])
    with np.errstate(all="ignore"):
        div, mul = x / F32(2.0), x * F32(0.5)
    nan = np.isnan(x)
    np.testing.assert_array_equal(np.isnan(div), nan)
    np.testing.assert_array_equal(np.isnan(mul), nan)
    np.testing.assert_array_equal(_bits(div[~nan]), _bits(mul[~nan]))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(_bits((t / 2.0).numpy()[~nan]),
                                  _bits((t * 0.5).numpy()[~nan]))
    assert (np.abs(x[~nan]) < 2.0 ** -125).sum() > 1000   # subnormal halves


FIX_CASES = [(0, 200, 7, "mixed"), (1, 200, 7, "mixed"), (2, 1, 7, "mixed"),
             (3, 2, 1, "mixed"), (4, 150, 32, "mixed"),
             (5, 60, 7, "unvoiced"), (6, 60, 32, "voiced"),
             (7, 200, 16, "mixed"), (8, 151, 32, "mixed"), (9, 90, 1, "mixed")]


@pytest.mark.parametrize("seed,F,C,kind", FIX_CASES)
def test_fix_contour_model_bit_equal_to_plain(seed, F, C, kind):
    """On the edge inputs (the walk is the same in shared and in device
    memory)."""
    step2, cands = CASES.fix_contour_edge_inputs(seed, F, C, kind)
    got = fix_contour_model(step2, cands, ALLOWED)
    want = WK.fix_contour_reference(torch.from_numpy(step2),
                                    torch.from_numpy(cands), ALLOWED).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fix_contour_edge_inputs_reach_the_select():
    """The planted cases reach the walks' selects: exact ties, NaN errors,
    the 10% edge failing, extensions kept, NaN in step2."""
    stats = dict.fromkeys(("selects", "nan", "ties", "fails"), 0)
    for seed in range(4):
        step2, cands = CASES.fix_contour_edge_inputs(seed, 200, 7)
        out = fix_contour_model(step2, cands, ALLOWED, stats=stats)
        assert np.isnan(step2).any()
        assert ((out > 0) & ~(step2 > 0)).any()    # extended into gaps
    assert stats["ties"] >= 4 and stats["nan"] >= 1 and stats["fails"] >= 4
    assert stats["selects"] > 40


@pytest.mark.parametrize("seed,F,C", [(20, 7, 7), (21, 8, 7), (22, 9, 1),
                                      (23, 200, 7), (24, 120, 32),
                                      (25, 160, 16)])
def test_fix_contour_model_in_stage_matches_jax(seed, F, C, monkeypatch):
    """The edge contours as f0 through device_f0's stage (steps 1-2, then
    W3 as the model) against JAX's _fix_contour_scan at DIO's defaults
    (5 ms, f0_floor 71 Hz: vrm = 7; F = 7 returns f0 before any walk, F = 8
    walks); NaN in the last frames reaches step 2."""
    f0, cands = CASES.fix_contour_edge_inputs(seed, F, C)
    monkeypatch.setattr(device_f0.world_kernel, "fix_contour",
                        lambda s2, c, a: torch.from_numpy(fix_contour_model(
                            s2.numpy(), c.contiguous().numpy(), a)))
    got = device_f0._fix_contour_scan(torch.from_numpy(f0),
                                      torch.from_numpy(cands.T.copy()), 5.0,
                                      ALLOWED, 71.0).numpy()
    want = np.asarray(jax_f0._fix_contour_scan(
        jnp.asarray(f0), jnp.asarray(cands.T.copy()), 5.0, ALLOWED, 71.0))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(_bits(np.nan_to_num(got)),
                                  _bits(np.nan_to_num(want)))


@pytest.mark.parametrize("C", [1, 7, 8, 9, 16, 17, 32])
def test_fix_contour_staged_fits_a_block(C):
    """The pass is staged while its F (C + 2) floats fit a block's shared
    memory (6,456 frames, 32 s, at C = 7; 1,709 at C = 32); the 10 s pass
    is, 15,001 frames are not; the slots hold every candidate."""
    CW = WK.fix_contour_slots(C)
    assert C <= CW <= 32 and CW in (8, 16, 32)
    most = SMEM_MAX // (4 * (C + 2))
    assert WK.fix_contour_staged(most, C)
    assert not WK.fix_contour_staged(most + 1, C)
    if C == 7:
        assert most == 6456 and WK.fix_contour_staged(2001, C)
        assert not WK.fix_contour_staged(15001, C)


@pytest.mark.parametrize("seed", range(6))
def test_fix_contour_model_jumps_match_plain_on_dense_gaps(seed):
    """Sections and gaps of one to three frames (every jump short, chains
    carried across one-frame sections), at C = 1..32."""
    rng = np.random.default_rng(seed)
    F, C = 97, int(rng.integers(1, 33))
    step2, cands = CASES.fix_contour_edge_inputs(seed, F, C)
    step2[rng.random(F) < 0.35] = 0.0
    got = fix_contour_model(step2, cands, ALLOWED)
    want = WK.fix_contour_reference(torch.from_numpy(step2),
                                    torch.from_numpy(cands), ALLOWED).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_world_kernel_ab_records_the_pass_inputs():
    """tools/world_kernel_ab records W1-W3's arguments from a device
    harvest and a DIO pass at each of PASS_SECONDS (here on the CPU, where
    the wrappers run the plain versions, at a cut length), contiguous,
    through world_kernel_cases.recording, which restores the wrappers;
    without a card it exits 2."""
    from qpnet_tpu_torch.tools import world_kernel_ab as AB
    saved = {n: getattr(WK, n) for n in WK.KERNELS}
    orig = CASES.PASS_SECONDS
    CASES.PASS_SECONDS = (0.6,)
    try:
        got = AB.pass_inputs(torch.device("cpu"))
    finally:
        CASES.PASS_SECONDS = orig
    assert {n: getattr(WK, n) for n in WK.KERNELS} == saved
    assert sorted(got) == [("fix_contour", 0.6), ("pool", 0.6),
                           ("viterbi", 0.6)]
    F = got[("fix_contour", 0.6)][0].shape[0]
    assert got[("fix_contour", 0.6)][1].shape == (F, 7)
    assert got[("pool", 0.6)][0].shape[1] == F
    assert all(t.is_contiguous() for a in got.values() for t in a
               if torch.is_tensor(t))
    assert WK.fix_contour_reference(*got[("fix_contour", 0.6)]).shape == (F,)
    if not torch.cuda.is_available():
        assert AB.main(["--other", "none.cu"]) == 2


def test_entry_points_match_the_source():
    """world_kernel.ENTRY_POINTS, the one table that types the library's
    entry points (for the wrappers and for tools/world_kernel_ab), names
    every `extern "C"` function of csrc/world_kernel.cu with its number of
    arguments, pointers where the source has pointers."""
    import ctypes
    import re
    from qpnet_tpu_torch.ops import _build
    src = (_build.CSRC / "world_kernel.cu").read_text()
    found = {}
    for name, params in re.findall(
            r'extern "C" int (qp_world_\w+)\(([^)]*)\)', src):
        params = [q.strip() for q in params.split(",") if q.strip()]
        found[name] = ["*" in q for q in params]
    assert found and set(found) == set(WK.ENTRY_POINTS)
    for name, ptrs in found.items():
        assert [t is ctypes.c_void_p for t in WK.ENTRY_POINTS[name]] == ptrs


def test_launching_swaps_and_restores_the_library():
    """world_kernel.launching puts a library under the wrappers for the
    block only."""
    before = list(WK._loaded)
    lib = object()
    with WK.launching(lib):
        assert WK._lib() is lib
    assert WK._loaded == before
