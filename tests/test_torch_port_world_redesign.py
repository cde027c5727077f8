"""PyTorch port: the orders of operations of the redesigned W2 (harvest's
Viterbi) and W4 (the fractional-box smoothing) in
`qpnet_tpu_torch/csrc/world_kernel.cu`, modelled in numpy and held bit for
bit to the plain versions of `qpnet_tpu_torch/ops/world_kernel.py`; and the
wrappers' plain versions past W2's shared-memory capacity against JAX.

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
    bit at CheapTrick's and D4C's widths and offset counts.
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

TC, UC = CASES.TRANSITION_COST, CASES.UNVOICED_COST
VIT_THREADS = 128    # csrc VIT_THREADS: the back-track's threads
SMEM_MAX = 232448    # csrc SMEM_MAX: shared memory an H100 block may use


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
    rows, one per state.  Lane q of the state's P lanes holds positions
    q * NPOS .. q * NPOS + NPOS - 1 (csrc vit_positions: NPOS fixed by P;
    a position past S holds a +inf that never wins) and takes their
    first-index min as a tree over positions; the butterfly over offsets
    1, 2, .. < P then makes the kernel's select (csrc replaces() with the
    lane's side of the partner), so ties go to the lower block, with the
    index riding along.  Returns (values
    (R,), indices (R,))."""
    R, S = tot.shape
    P = WK.viterbi_lanes(S)
    NPM = _positions(P)
    q = np.arange(P)
    pos = q[:, None] * NPM + np.arange(NPM)[None, :]        # (P, NPOS)
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
    argmin; the back-track in G = 128 // S segments (each segment's map
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
    G = VIT_THREADS // S
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


def _long_inputs(seed, F, K):
    """Harvest-like candidates around a wandering contour (values distinct
    per frame), with unvoiced stretches."""
    rng = np.random.default_rng(seed)
    track = 150.0 * np.exp(np.cumsum(rng.normal(0, 0.02, F)))
    mult = rng.choice([1.0, 2.0, 0.5, 1.3], size=(F, K), p=[.4, .2, .2, .2])
    refined = track[:, None] * mult * (1 + rng.normal(0, 0.01, (F, K)))
    refined[rng.random((F, K)) < 0.25] = 0.0
    refined[(np.arange(F) // 40) % 5 == 4] = 0.0
    score = np.where(mult == 1.0, rng.uniform(0.6, 1.0, (F, K)),
                     rng.uniform(0.0, 0.7, (F, K)))
    return refined.astype(np.float32), score.astype(np.float32)


@pytest.mark.parametrize("F,K", [(15001, 15), (12001, 6)])
def test_viterbi_past_shared_capacity_matches_jax(F, K):
    """At lengths whose back-pointers spill from W2's shared memory (75 s
    at S = 16, 60 s at S = 7), the wrapper on CPU tensors runs the plain
    version, whose states and f0 equal JAX's _viterbi."""
    assert WK.viterbi_spills(F, K) and not WK.viterbi_spills(F // 2, K // 2)
    refined, score = _long_inputs(F + K, F, K)
    want = np.asarray(jax_f0._viterbi(jnp.asarray(refined),
                                      jnp.asarray(score), TC, UC))
    WK.reset_launch_count()
    got = device_f0._viterbi(torch.from_numpy(refined),
                             torch.from_numpy(score), TC, UC).numpy()
    assert WK.launch_count("viterbi") == 0
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert 0.2 < (got > 0).mean() < 0.95


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
