"""PyTorch port: the wide layouts of W1 (harvest's pooling past 16 slots),
W2 (its Viterbi past 16 states) and W3 (DIO's contour walks past 32
candidates) in `qpnet_tpu_torch/csrc/world_kernel.cu`, modelled in numpy
and held bit for bit to the plain versions of
`qpnet_tpu_torch/ops/world_kernel.py`, and inside device_f0's stages to
the JAX stages; the wrappers' shape checks at the new limits (K up to 255
candidates, S = K + 1 up to 256 states, C up to 256 bands); and the
layouts' shared memory at those limits.

The kernels build and run only on the card (chip_smoke.py phase 15 holds
the wide branches to the plain versions there, on these tests' inputs
too).  The models (`test_torch_port_world_redesign`'s, which take the
wide layout past the narrow limits) show on the CPU that the wide orders
give the plain versions' bits:
  * W2 past 16 states: P lanes a state over 8 warps (P the largest power
    of two <= 32 with S * P <= 256), lane q walking its block of NP =
    ceil(S / P) predecessors in index order, then the butterfly over the P
    lanes (ties to the lower block); the back-track in G = 256 // S >= 1
    segments (S = 17, 32, 33, 129, 256);
  * W3 past 32 candidates: lane l holding the block l * m .. l * m + m -
    1, m = ceil(C / 32), its tree of selects, then a butterfly over the 32
    lanes carrying the candidate, ties to the lower block (C = 33, 64,
    256);
  * W1 past 16 slots: the K slots in shared memory, lane l adding to slots
    l, l + 32, .. in a round, every dup test against all K slots (K = 17,
    64, 255; K past the ranks too).
Tolerances: none; every comparison is of bits (float32 viewed as int32).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from qpnet_tpu.dsp.world import jax_f0
from qpnet_tpu_torch.dsp.world import device_f0
from qpnet_tpu_torch.ops import _build
from qpnet_tpu_torch.ops import world_kernel as WK
from qpnet_tpu_torch.ops import world_kernel_cases as CASES
from torch_port_threads import one_thread  # noqa: F401
from test_torch_port_world_redesign import (ALLOWED, SPECIAL, SPECIAL_E, THR,
                                            _bits, fix_contour_model,
                                            lane_min, plain_backs,
                                            pool_model, select_lanes,
                                            viterbi_model)

TC, UC = CASES.TRANSITION_COST, CASES.UNVOICED_COST
SMEM_MAX = WK.SMEM_MAX

# ---------------------------------------------------------------------------
# W2 past 16 states
# ---------------------------------------------------------------------------


@settings(max_examples=150, deadline=None)
@given(S=st.integers(17, 256), R=st.integers(1, 3), data=st.data())
def test_wide_lane_min_equals_torch_min(S, R, data):
    vals = data.draw(st.lists(
        st.one_of(st.sampled_from(SPECIAL),
                  st.floats(-4.0, 4.0, width=32)),
        min_size=R * S, max_size=R * S))
    tot = np.array(vals, np.float32).reshape(R, S)
    want_v, want_i = torch.min(torch.from_numpy(tot), dim=1)
    got_v, got_i = lane_min(tot)
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v.numpy()))
    np.testing.assert_array_equal(got_i, want_i.numpy())


@pytest.mark.parametrize("S", [17, 32, 33, 129, 256])
def test_wide_lane_min_ties_keep_the_first_index(S):
    """All-equal rows, NaN rows, -0.0 against +0.0, inf rows, NaN from the
    middle on and a tie at the two ends of every lane's block: the first
    index wins each."""
    P = WK.viterbi_lanes(S)
    NP = -(-S // P)
    assert P * NP >= S and S * P <= WK.VITERBI_WIDE_THREADS
    ends = np.full(S, 2.0)
    ends[np.minimum(np.arange(P) * NP + NP - 1, S - 1)] = 1.0
    ends[np.arange(P) * NP % S] = 1.0
    rows = np.stack([np.full(S, 0.35), np.full(S, np.nan), np.full(S, np.inf),
                     np.where(np.arange(S) % 2, -0.0, 0.0),
                     np.where(np.arange(S) >= S // 2, np.nan, 1.0), ends,
                     ends[::-1]])
    tot = rows.astype(np.float32)
    want_v, want_i = torch.min(torch.from_numpy(tot), dim=1)
    got_v, got_i = lane_min(tot)
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v.numpy()))
    np.testing.assert_array_equal(got_i, want_i.numpy())
    assert list(got_i[:3]) == [0, 0, 0]


@pytest.mark.parametrize("seed,F,S", [(40, 200, 17), (41, 150, 32),
                                      (42, 130, 33), (43, 60, 129),
                                      (44, 40, 256), (45, 2, 256),
                                      (46, 1, 33)])
def test_wide_viterbi_model_bit_equal_to_plain(seed, F, S):
    """The wide chain (lane_min past 16 states, the emission add) and its
    back-track in G = 256 // S segments (15 at S = 17, 1 past 128) give
    the plain version's back-pointers, states and f0 on the edge inputs
    (ties, 1e30, +-inf, -0.0, the NaN tail)."""
    K = S - 1
    emits, logf, refined = CASES.viterbi_edge_inputs(seed, F, K)
    back, states, f0 = viterbi_model(emits, logf, refined, TC, UC)
    want_back, cost = plain_backs(emits, logf, TC, UC)
    np.testing.assert_array_equal(back, want_back)
    want = WK.viterbi_reference(torch.from_numpy(emits),
                                torch.from_numpy(logf),
                                torch.from_numpy(refined), TC, UC).numpy()
    np.testing.assert_array_equal(_bits(f0), _bits(want))
    assert WK.viterbi_threads(S) // S >= 1
    if F >= 40:
        assert (states > 0).any() and (states == 0).any()
        assert np.isnan(cost).all()


@pytest.mark.parametrize("K", [24, 40])
def test_wide_viterbi_plain_matches_jax(K):
    """device_f0._viterbi's plain version at S = 25 and 41 against JAX's
    _viterbi on harvest-like candidates, bit for bit (short: 301 frames)."""
    refined, score = CASES.harvest_like_inputs(K, 301, K)
    want = np.asarray(jax_f0._viterbi(jnp.asarray(refined),
                                      jnp.asarray(score), TC, UC))
    got = device_f0._viterbi(torch.from_numpy(refined),
                             torch.from_numpy(score), TC, UC).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert 0.2 < (got > 0).mean() < 0.95


# ---------------------------------------------------------------------------
# W1 past 16 slots
# ---------------------------------------------------------------------------

# (seed, n_ch, F, K, ladder): a ladder fills the slots past 16 (K = 17 and
# 64 fill in some frames, K = 255 in none at 600 ranks); K = 255 at 97 and
# 21 ranks is K past the ranks, whose slots stay 0
POOL_WIDE = [(50, 40, 9, 17, 30), (51, 200, 9, 64, 150),
             (52, 600, 5, 255, 500), (53, 97, 7, 255, 0),
             (54, 21, 6, 40, 0), (55, 1500, 4, 255, 1200)]


@pytest.mark.parametrize("inf", [False, True])
@pytest.mark.parametrize("seed,n_ch,F,K,ladder", POOL_WIDE)
def test_wide_pool_model_bit_equal_to_plain(seed, n_ch, F, K, ladder, inf):
    f, sp = CASES.pool_edge_inputs(seed, n_ch, F, agreeing_inf=inf,
                                   ladder=ladder)
    got = pool_model(f, sp, THR, K)
    want = WK.pool_reference(torch.from_numpy(f), torch.from_numpy(sp), THR,
                             K).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if inf:
        assert np.isnan(want).any() and np.isinf(want).any()


def test_wide_pool_edge_inputs_fill_the_slots():
    """The ladder fills every slot of K = 17, 64 and 255 in some frame; at
    K past the ranks the slots the walk never reaches stay 0."""
    for seed, n_ch, F, K, ladder in POOL_WIDE:
        f, sp = CASES.pool_edge_inputs(seed, n_ch, F, ladder=ladder)
        out = WK.pool_reference(torch.from_numpy(f), torch.from_numpy(sp),
                                THR, K).numpy()
        kept = (out > 0).sum(1)
        if K > n_ch:
            assert (out[:, n_ch:] == 0).all()
        elif K in (17, 64) or n_ch >= 1500:
            assert kept.max() == K, (K, kept)


@pytest.mark.parametrize("K,channels_in_octave", [(24, 24.0), (40, 6.0)])
def test_wide_pool_model_in_stage_matches_jax(K, channels_in_octave,
                                              monkeypatch):
    """device_f0's stage (stable sort by spread, then W1 as the model) at
    K = 24 over harvest's 84 ranks (71-800 Hz, 24 an octave) and K = 40
    over 21 ranks (6 an octave, so K past the ranks) against JAX's
    _pool_candidates, bit for bit."""
    n_ch = 1 + int(np.log2(800.0 / 71.0) * channels_in_octave)
    assert n_ch == {24: 84, 40: 21}[K]
    f, sp = CASES.pool_edge_inputs(K, n_ch, 23, ladder=n_ch)
    monkeypatch.setattr(device_f0.world_kernel, "pool", lambda a, b, c, k:
                        torch.from_numpy(pool_model(a.numpy(), b.numpy(),
                                                    c, k)))
    got = device_f0._pool_candidates(torch.from_numpy(f),
                                     torch.from_numpy(sp), THR, K).numpy()
    want = np.asarray(jax_f0._pool_candidates(jnp.asarray(f),
                                              jnp.asarray(sp), THR, K))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    kept = (got > 0).sum(1)
    assert kept.max() > (16 if K < n_ch else 8)
    assert (got[:, n_ch:] == 0).all()


# ---------------------------------------------------------------------------
# W3 past 32 candidates
# ---------------------------------------------------------------------------

@settings(max_examples=150, deadline=None)
@given(C=st.integers(33, 256), data=st.data())
def test_select_lanes_equals_torch_argmin(C, data):
    """The lanes' blocks, each lane's tree and the butterfly pick the pair
    torch.argmin picks over the C errors: NaN first, ties to the first
    index."""
    vals = data.draw(st.lists(
        st.one_of(st.sampled_from(SPECIAL_E),
                  st.floats(0.0, 4.0, width=32)), min_size=C, max_size=C))
    e = np.array(vals, np.float32)
    _, idx = select_lanes(e, np.arange(C, dtype=np.float32))
    assert int(idx) == int(torch.argmin(torch.from_numpy(e)))


@pytest.mark.parametrize("C", [33, 64, 256])
def test_select_lanes_ties_keep_the_first_index(C):
    """A tie inside one lane's block, across lanes, and at the last lane's
    short block; NaN in an upper lane beats a lower lane's finite error."""
    m = WK.fix_contour_block(C)
    assert m <= 8 and 32 * m >= C > 32 * (m - 1)
    for ties in ([0, 1], [m - 1, m], [5, C - 1], [C - 2, C - 1]):
        e = np.full(C, 3.0, np.float32)
        e[ties] = 1.0
        _, idx = select_lanes(e, np.arange(C, dtype=np.float32))
        assert int(idx) == min(ties)
    e = np.full(C, 3.0, np.float32)
    e[0], e[C - 1] = 1.0, np.nan
    assert int(select_lanes(e, np.arange(C, dtype=np.float32))[1]) == C - 1


@pytest.mark.parametrize("kind", ["mixed", "voiced"])
@pytest.mark.parametrize("seed,F,C", [(60, 200, 33), (61, 200, 64),
                                      (62, 150, 256), (63, 97, 256),
                                      (64, 2, 40), (65, 250, 100)])
def test_wide_fix_contour_model_bit_equal_to_plain(seed, F, C, kind):
    step2, cands = CASES.fix_contour_edge_inputs(seed, F, C, kind)
    got = fix_contour_model(step2, cands, ALLOWED)
    want = WK.fix_contour_reference(torch.from_numpy(step2),
                                    torch.from_numpy(cands), ALLOWED).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_wide_fix_contour_edge_inputs_reach_the_select():
    """Past 32 candidates the planted cases still reach the walks'
    selects: exact ties (in one lane's block and across lanes), NaN
    errors, the 10% edge failing."""
    stats = dict.fromkeys(("selects", "nan", "ties", "fails"), 0)
    for seed, C in zip(range(8), [33, 64, 256, 100] * 2):
        step2, cands = CASES.fix_contour_edge_inputs(seed, 200, C)
        fix_contour_model(step2, cands, ALLOWED, stats=stats)
    assert stats["ties"] >= 8 and stats["nan"] >= 8 and stats["fails"] >= 8
    assert stats["selects"] > 200


@pytest.mark.parametrize("seed,F,C", [(66, 200, 42), (67, 160, 64)])
def test_wide_fix_contour_model_in_stage_matches_jax(seed, F, C,
                                                     monkeypatch):
    """The edge contours as f0 through device_f0's stage (steps 1-2, then
    W3 as the model) against JAX's _fix_contour_scan at C = 42 (DIO at 12
    bands an octave over 71-800 Hz) and 64."""
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


# ---------------------------------------------------------------------------
# the limits and the layouts
# ---------------------------------------------------------------------------

def test_shape_checks_take_every_shape_up_to_the_limits():
    """On the card the wrappers run W1 at K = 1..255, W2 at S = K + 1 up
    to 256 states and W3 at C = 1..256: their shape checks (which run
    before a launch, and here on the CPU) pass them all."""
    for K in range(1, WK.MAX_POOL + 1):
        WK.check_pool((84, 601), (84, 601), K)
        WK.check_viterbi((601, K + 1), (601, K), (601, K))
    WK.check_viterbi((601, 1), (601, 0), (601, 0))
    for C in range(1, WK.MAX_CANDS + 1):
        WK.check_fix_contour((601,), (601, C))
    assert (WK.MAX_POOL, WK.MAX_STATES, WK.MAX_CANDS) == (255, 256, 256)


def test_shape_checks_refuse_past_the_limits():
    """Past each limit the check raises ValueError naming it."""
    with pytest.raises(ValueError, match="MAX_POOL=255"):
        WK.check_pool((84, 601), (84, 601), 256)
    with pytest.raises(ValueError, match="MAX_POOL=255"):
        WK.check_pool((84, 601), (84, 601), 0)
    n = WK.pool_max_ranks(255)
    WK.check_pool((n, 9), (n, 9), 255)
    with pytest.raises(ValueError, match=f"1..{n} ranks at K=255"):
        WK.check_pool((n + 1, 9), (n + 1, 9), 255)
    with pytest.raises(ValueError, match="MAX_STATES=256"):
        WK.check_viterbi((601, 257), (601, 256), (601, 256))
    with pytest.raises(ValueError, match="MAX_CANDS=256"):
        WK.check_fix_contour((601,), (601, 257))
    with pytest.raises(ValueError, match="MAX_CANDS=256"):
        WK.check_fix_contour((601,), (601, 0))


def test_plain_versions_take_any_shape_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions, past the card's
    limits too: no refusal and no launch."""
    WK.reset_launch_count()
    f, sp = CASES.pool_edge_inputs(70, 300, 3, ladder=280)
    out = WK.pool(torch.from_numpy(f), torch.from_numpy(sp), THR, 300)
    assert out.shape == (3, 300)
    emits, logf, refined = CASES.viterbi_edge_inputs(71, 5, 300)
    assert WK.viterbi(*map(torch.from_numpy, (emits, logf, refined)), TC,
                      UC).shape == (5,)
    s2, c = CASES.fix_contour_edge_inputs(72, 20, 300)
    assert WK.fix_contour(torch.from_numpy(s2), torch.from_numpy(c),
                          ALLOWED).shape == (20,)
    assert sum(WK.launch_count(k) for k in WK.KERNELS) == 0


def _csrc_ints():
    src = (_build.CSRC / "world_kernel.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_limits_match_the_source():
    """The wrappers' limits and layout constants are the kernel source's."""
    c = _csrc_ints()
    assert (c["MAX_POOL"], c["MAX_STATES"], c["MAX_CANDS"]) == (
        WK.MAX_POOL, WK.MAX_STATES, WK.MAX_CANDS)
    assert (c["POOL_REGS"], c["VIT_NARROW"], c["FIX_NARROW"]) == (
        WK.POOL_REGS, WK.VITERBI_NARROW, WK.FIX_NARROW)
    assert (c["VITW_THREADS"], c["VITW_CH"], c["SMEM_MAX"]) == (
        WK.VITERBI_WIDE_THREADS, WK.VITERBI_WIDE_CH, WK.SMEM_MAX)
    assert c["POOL_TILE"] == WK.POOL_TILE
    assert c["VIT_BACK_SMEM"] == WK.VITERBI_BACK_SMEM
    assert c["FIX_LANE_SLOTS"] == WK.fix_contour_slots(WK.FIX_NARROW + 1)


@pytest.mark.parametrize("K", [16, 31, 63, 127, 128, 200, 255])
def test_wide_viterbi_shared_memory_fits(K):
    """The wide W2's shared memory (csrc vitw_layout: the back-track's
    maps, the costs twice, two chunks of emission and logf rows, the
    back-pointers) fits a block at its largest unspilled length and past
    it; the back-pointers spill past VITERBI_BACK_SMEM bytes as before, in
    the wrapper's (F - 1, K + 1) uint8 scratch, and hold every state."""
    S = K + 1
    F = WK.VITERBI_BACK_SMEM // S + 1
    assert not WK.viterbi_spills(F, K) and WK.viterbi_spills(F + 1, K)
    assert WK.viterbi_wide_smem(F, K) <= SMEM_MAX
    assert WK.viterbi_wide_smem(F + 1, K) < WK.viterbi_wide_smem(F, K)
    assert S - 1 <= np.iinfo(np.uint8).max
    assert WK.viterbi_threads(S) // S >= 1
    assert WK.viterbi_spills(2001, 127) and not WK.viterbi_spills(2001, 31)


@pytest.mark.parametrize("K", [17, 64, 127, 255])
def test_wide_pool_shared_memory_fits(K):
    """W1's block past 16 slots stages its ranks and 8 x K slots: at
    pool_max_ranks(K) ranks they fit a block, one more rank does not, and
    harvest's 84 ranks (71-800 Hz, 24 an octave) fit at every K."""
    n = WK.pool_max_ranks(K)
    assert WK.pool_smem(n, K) <= SMEM_MAX < WK.pool_smem(n + 1, K)
    assert WK.pool_smem(n, K) - WK.pool_smem(n, 1) == 8 * K * 4
    assert n >= 84


@pytest.mark.parametrize("C", [33, 42, 64, 128, 129, 256])
def test_wide_fix_contour_staging_fits(C):
    """Past 32 candidates W3 stages while F (C + 2) floats fit a block
    (225 frames at C = 256), else walks device memory; a lane's block
    fits its 8 slots."""
    most = SMEM_MAX // (4 * (C + 2))
    assert WK.fix_contour_staged(most, C)
    assert not WK.fix_contour_staged(most + 1, C)
    assert WK.fix_contour_block(C) <= WK.fix_contour_slots(C) == 8
    if C == 256:
        assert most == 225
    if C == 42:
        assert WK.fix_contour_staged(601, C)
