"""The device WORLD analysis's sequential stages as CUDA kernels (W1-W4),
each beside its plain PyTorch version.

Under `jax.jit` the JAX package compiles each of these stages into the
analysis pass's one XLA program; run eagerly, each is a Python loop of
small tensor ops that queues thousands of CUDA kernels a pass.  Here each
is one launch of a kernel of `csrc/world_kernel.cu` (see the note there
for each kernel's design and bound):

  W1 `pool`: harvest's candidate pooling over channel ranks
     (qpnet_tpu/dsp/world/jax_f0.py::_pool_candidates, its fori_loop): a
     warp a frame, lanes over ranks, the kept ranks found in ballot rounds;
     K slots in registers up to POOL_REGS, in shared memory up to MAX_POOL;
  W2 `viterbi`: harvest's contour Viterbi, forward and back-track
     (jax_f0.py::_viterbi, its two scans): up to VITERBI_NARROW states,
     three warps stage the transitions and one runs the chain with
     shuffles; up to MAX_STATES, 8 warps share the states, each lane
     computing its transitions, a block barrier a frame;
  W3 `fix_contour`: DIO's FixF0Contour steps 3-4, the forward and the
     backward extension loops (jax_f0.py::_fix_contour_scan, its scans):
     the pass staged in shared memory, one warp walking the frames whose
     value the carry decides (the nearest candidate a tree of selects in
     registers, past FIX_NARROW candidates over each lane's block, then a
     butterfly over the lanes) and jumping the runs it cannot reach 32
     frames a ballot;
  W4 `smooth`: the fractional-box spectral smoothing over 2*kmax offsets
     (qpnet_tpu/dsp/world/jax_analysis.py::_jax_linear_smoothing),
     SMOOTH_R bins a thread over a window held in registers.

Each wrapper runs its plain version (`*_reference`) on CPU tensors and
launches its kernel on CUDA tensors; any other device raises ValueError.
Nothing else selects between the two.  On CUDA tensors a shape past a
kernel's limit (`check_pool`, `check_viterbi`, `check_fix_contour`: K up to
MAX_POOL = 255 candidates, S = K + 1 up to MAX_STATES = 256 states, C up to
MAX_CANDS = 256 bands) raises ValueError naming it; the plain versions take
any shape.  A kernel keeps its plain version's
order of operations and rounding (IEEE division, no contraction, first
index on ties), so on the card the two give the same bits.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from qpnet_tpu_torch.utils import profiler

KERNELS = ("pool", "viterbi", "fix_contour", "smooth")
MAX_POOL = 255     # W1: the most candidates a frame keeps (harvest's K)
POOL_REGS = 16     # W1: K up to this keeps its slots in registers, past it
                   # in shared memory (csrc POOL_REGS)
POOL_TILE = 8      # W1: frames a block, a warp each
MAX_STATES = 256   # W2: the most states, K + 1 (uint8 back-pointers)
VITERBI_NARROW = 16  # W2: states up to this run on one chain warp, past it
                     # over a block of VITERBI_WIDE_THREADS (csrc VIT_NARROW)
VITERBI_WIDE_THREADS = 256
VITERBI_WIDE_CH = 16   # W2 past VITERBI_NARROW: frames a staged chunk
MAX_CANDS = 256    # W3: the most band candidates
FIX_NARROW = 32    # W3: candidates up to this in 8, 16 or 32 slots, past it
                   # in blocks of ceil(C / 32) a lane (csrc FIX_NARROW)
SMEM_MAX = 232448  # shared memory an H100 block may use (csrc SMEM_MAX)
# W2 keeps its (F - 1, S) uint8 back-pointers in shared memory up to this
# many bytes; past it they go to device memory (csrc VIT_BACK_SMEM)
VITERBI_BACK_SMEM = 81920
SMOOTH_THREADS = 256   # W4: threads a block
SMOOTH_R = 4           # W4: consecutive bins an item (a thread's group)

# kernel launches made through the wrappers, one per call on CUDA tensors,
# are the registry's counters world.<kernel>


def launch_count(name: str) -> int:
    return profiler.counters().get(f"world.{name}", 0)


def reset_launch_count() -> None:
    profiler.reset_counters("world.")


def viterbi_lanes(S: int) -> int:
    """W2's lanes a state: up to VITERBI_NARROW states the largest power
    of two P with S * P <= 32 (csrc vit_lanes; lane q of a state holds the
    predecessors q * NPOS .. q * NPOS + NPOS - 1, NPOS = ceil(min(16, 32 /
    P) / P)); past it the largest power of two P <= 32 with S * P <=
    VITERBI_WIDE_THREADS (csrc vitw_lanes; lane q holds q * NP .. q * NP +
    NP - 1, NP = ceil(S / P))."""
    threads = 32 if S <= VITERBI_NARROW else VITERBI_WIDE_THREADS
    P = 32
    while P > 1 and S * P > threads:
        P //= 2
    return P


def viterbi_threads(S: int) -> int:
    """The threads of W2's block, whose back-track runs threads // S >= 1
    segments: 128 (csrc VIT_THREADS) up to VITERBI_NARROW states, else
    VITERBI_WIDE_THREADS."""
    return 128 if S <= VITERBI_NARROW else VITERBI_WIDE_THREADS


def viterbi_wide_smem(F: int, K: int) -> int:
    """Shared bytes of W2's block past VITERBI_NARROW states (csrc
    vitw_layout): the back-track's maps, the costs double-buffered, two
    chunks of emission and logf rows, and the back-pointers unless they
    spill."""
    S = K + 1
    head = (2 * VITERBI_WIDE_THREADS + 4) * 4
    body = (2 * S + 2 * VITERBI_WIDE_CH * S
            + 2 * (VITERBI_WIDE_CH + 1) * K) * 4
    return head + body + (0 if viterbi_spills(F, K) else (F - 1) * S)


def viterbi_spills(F: int, K: int) -> bool:
    """True when W2's back-pointers, (F - 1) * (K + 1) bytes, do not fit in
    its shared memory and go to device memory instead."""
    return (F - 1) * (K + 1) > VITERBI_BACK_SMEM


def pool_smem(n_ch: int, K: int) -> int:
    """Shared bytes of W1's block (csrc pool_smem): n_ch x POOL_TILE f and
    sp values, each rank's row POOL_TILE + 1 floats, and past POOL_REGS
    each of its POOL_TILE warps' K slots."""
    return (2 * n_ch * (POOL_TILE + 1)
            + (POOL_TILE * K if K > POOL_REGS else 0)) * 4


def pool_max_ranks(K: int = 1) -> int:
    """The most ranks W1 takes at K candidates: its block's pool_smem fits
    SMEM_MAX."""
    return (SMEM_MAX - pool_smem(0, K)) // (2 * (POOL_TILE + 1) * 4)


def fix_contour_slots(C: int) -> int:
    """W3's candidate slots a lane (csrc CW): up to FIX_NARROW candidates
    8, 16 or 32, the first C real, the same in every lane; past it 8, of
    which the lane's block of fix_contour_block(C) is real."""
    return 8 if C <= 8 else 16 if C <= 16 else 32 if C <= FIX_NARROW else 8


def fix_contour_block(C: int) -> int:
    """W3's candidates a lane past FIX_NARROW: lane l holds the contiguous
    block l * m .. l * m + m - 1, m = ceil(C / 32) (csrc fix_first)."""
    return -(-C // 32)


def fix_contour_staged(F: int, C: int) -> bool:
    """True when W3 stages the pass in shared memory (csrc fix_staged):
    F frames of C candidates, step2 and step 3, F (C + 2) floats; longer
    passes walk the same way on device memory."""
    return F * (C + 2) * 4 <= SMEM_MAX


def smooth_layout(F: int, W: int, n_off: int, items: int = 1) -> dict:
    """W4's launch shape (csrc smooth_layout; the kernel takes 1, 2 or 4
    items a thread as the grid grows): ng bin groups of SMOOTH_R a frame;
    a block's SMOOTH_THREADS * items consecutive (frame, group) items span
    at most `rows` frames, each staged as rs floats (16-byte aligned, room
    for the last group's window) beside os weights; `bytes` of shared
    memory."""
    ng = -(-W // SMOOTH_R)
    rows = min(F, -(-SMOOTH_THREADS * items // ng) + 1)
    rs = (SMOOTH_R * ng + n_off + 3 + 3) // 4 * 4
    os_ = (n_off + 3) // 4 * 4
    return {"ng": ng, "rows": rows, "rs": rs, "os": os_,
            "bytes": rows * (rs + os_) * 4}


# ---------------------------------------------------------------------------
# plain versions (the eager loops the kernels replace)
# ---------------------------------------------------------------------------

def pool_reference(f_sorted, sp_sorted, agreement_threshold: float,
                   max_candidates: int):
    """W1's plain version: walk the channel ranks of (n_ch, F) candidates
    and spreads, sorted by spread per frame, and keep per frame up to K
    candidates that agree (spread <= threshold) and are not within 5% of
    one already kept.  Returns (F, K)."""
    n_ch, F = f_sorted.shape
    K = max_candidates
    dev = f_sorted.device
    slots = torch.arange(K, device=dev)
    pooled = torch.zeros((F, K), dtype=torch.float32, device=dev)
    n_chosen = torch.zeros((F,), dtype=torch.int32, device=dev)
    for r in range(n_ch):
        f, sp = f_sorted[r], sp_sorted[r]
        ok = (sp <= agreement_threshold) & (f > 0)
        dup = torch.any(torch.abs(f[:, None] - pooled)
                        < 0.05 * pooled.clamp_min(1e-9), dim=1)
        take = ok & ~dup & (n_chosen < K)
        slot = (n_chosen[:, None] == slots[None, :]).to(torch.float32)
        pooled = pooled + torch.where(take[:, None], slot * f[:, None], 0.0)
        n_chosen = n_chosen + take.to(torch.int32)
    return pooled


def viterbi_reference(emits, logf, refined, transition_cost: float,
                      unvoiced_cost: float):
    """W2's plain version: min-plus forward over S = K+1 states {unvoiced,
    K candidates} with emission costs emits (F, S) and transitions
    tc*|logf_t[s] - logf_{t-1}[p]| between candidates (unvoiced_cost to or
    from the unvoiced state, 0 from it to itself), then the back-track;
    `min` takes the first index of a tie, as jnp.argmin does.  Returns the
    (F,) f0 of the best path (refined's value, 0 where unvoiced)."""
    F, S = emits.shape
    dev = emits.device
    # every frame's (s, p) transition matrix at once
    trans = torch.full((F - 1, S, S), unvoiced_cost, device=dev)
    trans[:, 0, 0] = 0.0
    trans[:, 1:, 1:] = transition_cost * torch.abs(
        logf[1:, :, None] - logf[:-1, None, :])

    cost = emits[0]
    backs = []
    for t in range(1, F):
        best, bp = torch.min(cost[None, :] + trans[t - 1], dim=1)
        cost = best + emits[t]
        backs.append(bp)

    # back[t] maps frame-(t+1) states to their frame-t predecessors
    s = torch.argmin(cost).reshape(1)
    states = [s]
    for bp in reversed(backs):
        s = torch.gather(bp, 0, s)
        states.append(s)
    states = torch.cat(states[::-1])                    # (F,)
    return torch.where(states > 0, torch.gather(
        refined, 1, (states - 1).clamp_min(0)[:, None])[:, 0], 0.0)


def _select_best_f0(prev1, prev2, cands_t, allowed_range: float):
    """dio._select_best_f0 on a candidate vector: the candidate closest to
    the half-step linear extrapolation, 0 when even it disagrees."""
    reference = (prev1 * 3.0 - prev2) / 2.0
    errors = torch.abs(reference - cands_t)
    b = torch.argmin(errors).reshape(1)
    fail = (torch.gather(errors, 0, b)[0] / reference.clamp_min(1e-12)
            >= allowed_range)
    return torch.where(fail, 0.0, torch.gather(cands_t, 0, b)[0])


def fix_contour_reference(step2, cands_t, allowed_range: float):
    """W3's plain version: FixF0Contour steps 3-4 on the step-2 contour
    (F,) and the band candidates cands_t (F, C), as a forward and a
    backward loop over frames carrying (prev2, prev1, alive, was_gap); the
    comments of jax_f0._fix_contour_scan give the host walk's semantics
    they reproduce."""
    n = step2.shape[0]
    dev = step2.device
    inside = step2 > 0.0
    zero = torch.zeros((), device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)

    # forward: an extension chain that survives its gap overwrites the
    # next section's first frame (the host loop's last write lands there)
    prev2, prev1, alive, was_gap = zero, zero, false, false
    out = []
    for t in range(n):
        v_ext = _select_best_f0(prev1, prev2, cands_t[t], allowed_range)
        overwrite = inside[t] & was_gap & alive
        can = ~inside[t] & alive & (prev1 > 0.0)
        v = torch.where(inside[t], torch.where(overwrite, v_ext, step2[t]),
                        torch.where(can, v_ext, 0.0))
        alive = inside[t] | (can & (v_ext > 0.0))
        prev2, prev1, was_gap = prev1, v, ~inside[t]
        out.append(v)
    step3 = torch.stack(out)

    # backward: overwrites forward fills while it succeeds and writes its
    # terminating 0; section frames are never overwritten going backward
    prev2, prev1, alive = zero, zero, false
    out = []
    for t in range(n - 1, -1, -1):
        can = ~inside[t] & alive & (prev1 > 0.0)
        v_ext = _select_best_f0(prev1, prev2, cands_t[t], allowed_range)
        v = torch.where(can, v_ext, step3[t])
        alive = inside[t] | (can & (v_ext > 0.0))
        prev2, prev1 = prev1, v
        out.append(v)
    out = torch.stack(out[::-1])
    # the host backward loop's bound for the first section is limit=1:
    # frame 0 is never written
    return torch.cat([step3[:1], out[1:]])


def smooth_reference(ext, ov):
    """W4's plain version: out[f, i] = sum_j ov[f, j] * ext[f, i + j] over
    the 2*kmax offsets j in order, from the mirror-extended rows ext (F,
    W + 2*kmax) and the per-frame box weights ov (F, 2*kmax)."""
    n_off = ov.shape[1]
    W = ext.shape[1] - n_off
    out = torch.zeros((ext.shape[0], W), dtype=ext.dtype, device=ext.device)
    for jj in range(n_off):
        out = out + ov[:, jj: jj + 1] * ext[:, jj: jj + W]
    return out


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the library's plain C entry points and their arguments; each returns int
ENTRY_POINTS = {
    "qp_world_pool": [_P, _P, _I, _I, _I, _F, _P, _P],
    "qp_world_viterbi": [_P, _P, _P, _I, _I, _F, _F, _P, _P, _P],
    "qp_world_fix_contour": [_P, _P, _I, _I, _F, _P, _P],
    "qp_world_smooth": [_P, _P, _I, _I, _I, _P, _P],
    "qp_world_chain_probe": [_P, _I, _I, _P, _P],
    "qp_world_launch_floor": [_I, _I, _I, _P],
    "qp_world_viterbi_back_smem": [],
    "qp_world_fix_staged": [_I, _I],
}


_loaded = []


def load(src: bytes | None = None, name: str = "world_kernel"):
    """The library built from csrc/world_kernel.cu, or from the CUDA source
    `src` (another version of that file) built as `name`, with the entry
    points it has typed."""
    from qpnet_tpu_torch.ops import _build
    lib = (_build.load("world_kernel") if src is None
           else ctypes.CDLL(str(_build.build_source(name, src))))
    for entry, argtypes in ENTRY_POINTS.items():
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _lib():
    """The built library with its entry points typed, once per process."""
    if not _loaded:
        _loaded.append(load())
    return _loaded[0]


@contextlib.contextmanager
def launching(lib):
    """Within the block the wrappers launch the kernels of `lib` (from
    load(src, name)): for timing versions of csrc/world_kernel.cu in one
    process."""
    saved = list(_loaded)
    _loaded[:] = [lib]
    try:
        yield
    finally:
        _loaded[:] = saved


def build() -> None:
    """Compile and load the CUDA library now (otherwise at first launch)."""
    _lib()


def _on_card(name: str, *tensors) -> bool:
    """False for CPU tensors (the plain version runs), True for CUDA
    tensors (the kernel launches); raises for anything else or a mix."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {dev}")
    return True


def _f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise ValueError(f"expected float32, got {t.dtype}")
    return t.contiguous()


def _launch(name: str, fn, dev, *args) -> None:
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"world_kernel {name} launch failed: CUDA error "
                           f"{err}")
    profiler.count(f"world.{name}")


def check_pool(f_shape, sp_shape, K: int) -> None:
    """W1's shapes on the card: f and sp (n_ch, F) alike, K candidates
    from 1 to MAX_POOL, 1 to pool_max_ranks(K) ranks; raises ValueError
    naming the limit otherwise."""
    n_ch, F = tuple(f_shape)
    if (tuple(sp_shape) != tuple(f_shape) or not 1 <= K <= MAX_POOL
            or not 1 <= n_ch <= pool_max_ranks(K) or F < 1):
        raise ValueError(f"pool: shapes {tuple(f_shape)} {tuple(sp_shape)} "
                         f"(1..{pool_max_ranks(K)} ranks at K={K}), K={K} "
                         f"(1..MAX_POOL={MAX_POOL})")


def pool(f_sorted, sp_sorted, agreement_threshold: float,
         max_candidates: int):
    """W1: see pool_reference.  f_sorted, sp_sorted (n_ch, F) float32."""
    if not _on_card("pool", f_sorted, sp_sorted):
        return pool_reference(f_sorted, sp_sorted, agreement_threshold,
                              max_candidates)
    f_sorted, sp_sorted = _f32(f_sorted), _f32(sp_sorted)
    n_ch, F = f_sorted.shape
    K = int(max_candidates)
    check_pool(f_sorted.shape, sp_sorted.shape, K)
    out = torch.empty((F, K), dtype=torch.float32, device=f_sorted.device)
    _launch("pool", _lib().qp_world_pool, f_sorted.device,
            f_sorted.data_ptr(), sp_sorted.data_ptr(), n_ch, F, K,
            float(agreement_threshold), out.data_ptr())
    return out


def check_viterbi(emits_shape, logf_shape, refined_shape) -> None:
    """W2's shapes on the card: emits (F, K + 1), logf and refined (F, K),
    F >= 1, S = K + 1 states up to MAX_STATES; raises ValueError naming
    the limit otherwise."""
    F, K = tuple(refined_shape)
    if (tuple(emits_shape) != (F, K + 1) or tuple(logf_shape) != (F, K)
            or F < 1 or K + 1 > MAX_STATES):
        raise ValueError(f"viterbi: emits {tuple(emits_shape)}, logf "
                         f"{tuple(logf_shape)}, refined {tuple(refined_shape)}"
                         f" (at most MAX_STATES={MAX_STATES} states, K + 1)")


def viterbi(emits, logf, refined, transition_cost: float,
            unvoiced_cost: float):
    """W2: see viterbi_reference.  emits (F, K+1), logf and refined (F, K)
    float32."""
    if not _on_card("viterbi", emits, logf, refined):
        return viterbi_reference(emits, logf, refined, transition_cost,
                                 unvoiced_cost)
    emits, logf, refined = _f32(emits), _f32(logf), _f32(refined)
    F, K = refined.shape
    check_viterbi(emits.shape, logf.shape, refined.shape)
    dev = emits.device
    # back-pointers (F-1, S) uint8 live in the kernel's shared memory unless
    # they spill; then they go here, written forward and read back
    back = (torch.empty((F - 1, K + 1), dtype=torch.uint8, device=dev)
            if viterbi_spills(F, K) else None)
    f0 = torch.empty((F,), dtype=torch.float32, device=dev)
    _launch("viterbi", _lib().qp_world_viterbi, dev, emits.data_ptr(),
            logf.data_ptr(), refined.data_ptr(), F, K,
            float(transition_cost), float(unvoiced_cost),
            None if back is None else back.data_ptr(), f0.data_ptr())
    return f0


def check_fix_contour(step2_shape, cands_shape) -> None:
    """W3's shapes on the card: step2 (F,), cands_t (F, C), F >= 1, C from
    1 to MAX_CANDS; raises ValueError naming the limit otherwise."""
    F, C = tuple(cands_shape)
    if tuple(step2_shape) != (F,) or F < 1 or not 1 <= C <= MAX_CANDS:
        raise ValueError(f"fix_contour: step2 {tuple(step2_shape)}, cands_t "
                         f"{tuple(cands_shape)} (1..MAX_CANDS={MAX_CANDS} "
                         f"candidates)")


def fix_contour(step2, cands_t, allowed_range: float):
    """W3: see fix_contour_reference.  step2 (F,), cands_t (F, C)
    float32."""
    if not _on_card("fix_contour", step2, cands_t):
        return fix_contour_reference(step2, cands_t, allowed_range)
    step2, cands_t = _f32(step2), _f32(cands_t)
    F, C = cands_t.shape
    check_fix_contour(step2.shape, cands_t.shape)
    out = torch.empty((F,), dtype=torch.float32, device=step2.device)
    _launch("fix_contour", _lib().qp_world_fix_contour, step2.device,
            step2.data_ptr(), cands_t.data_ptr(), F, C, float(allowed_range),
            out.data_ptr())
    return out


def smooth(ext, ov):
    """W4: see smooth_reference.  ext (F, W + 2*kmax), ov (F, 2*kmax)
    float32; returns (F, W)."""
    if not _on_card("smooth", ext, ov):
        return smooth_reference(ext, ov)
    ext, ov = _f32(ext), _f32(ov)
    F, n_off = ov.shape
    W = ext.shape[1] - n_off
    if ext.shape[0] != F or W < 1 or n_off < 1:
        raise ValueError(f"smooth: ext {tuple(ext.shape)}, ov "
                         f"{tuple(ov.shape)}")
    out = torch.empty((F, W), dtype=torch.float32, device=ext.device)
    _launch("smooth", _lib().qp_world_smooth, ext.device, ext.data_ptr(),
            ov.data_ptr(), F, W, n_off, out.data_ptr())
    return out


CHAIN_PROBES = ("viterbi", "fix_contour")


def chain_probe(name: str, steps: int, inp: torch.Tensor) -> torch.Tensor:
    """Launch the chain probe of W2 ("viterbi": one shuffle-min and one add
    a step) or W3 ("fix_contour": one carried compare and select a step)
    over `steps` dependent steps on one warp of the card, starting from
    inp (96,) float32 on the card: the floor of that kernel's frame chain,
    for timing.  Not a path kernel, so not counted.  Returns (32,)."""
    if inp.device.type != "cuda" or inp.shape != (96,):
        raise ValueError(f"chain_probe takes (96,) on the card, got "
                         f"{tuple(inp.shape)} on {inp.device}")
    out = torch.empty(32, dtype=torch.float32, device=inp.device)
    with torch.cuda.device(inp.device):
        err = _lib().qp_world_chain_probe(
            _f32(inp).data_ptr(), CHAIN_PROBES.index(name), int(steps),
            out.data_ptr(),
            torch.cuda.current_stream(inp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"world_kernel chain probe {name} failed: CUDA "
                           f"error {err}")
    return out


LAUNCH_FLOORS = ("pool", "fix_contour")


def launch_floor(name: str, dims, device) -> None:
    """Launch an empty kernel with the grid, block and shared memory that
    W1 ("pool", dims (n_ch, F)) or W3 ("fix_contour", dims (F, C)) takes,
    on `device` (a card): the floor of that kernel's launch, for timing.
    Not a path kernel, so not counted."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"launch_floor runs on the card, got {dev}")
    with torch.cuda.device(dev):
        err = _lib().qp_world_launch_floor(
            LAUNCH_FLOORS.index(name), int(dims[0]), int(dims[1]),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"world_kernel launch floor {name} failed: CUDA "
                           f"error {err}")


def viterbi_back_smem() -> int:
    """The built kernel's back-pointer capacity in bytes (VIT_BACK_SMEM),
    which must equal VITERBI_BACK_SMEM."""
    return _lib().qp_world_viterbi_back_smem()


def fix_staged_built(F: int, C: int) -> bool:
    """The built kernel's answer to fix_contour_staged(F, C), which must
    be the same."""
    return bool(_lib().qp_world_fix_staged(int(F), int(C)))
