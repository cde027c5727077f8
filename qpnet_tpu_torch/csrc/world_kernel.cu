// The device WORLD analysis's sequential stages on Hopper (sm_90a), one
// launch each (W1-W4).  Wrapped by qpnet_tpu_torch/ops/world_kernel.py,
// whose plain PyTorch versions (`*_reference`) these kernels reproduce bit
// for bit on the card.
//
// None of them replaces a Pallas kernel.  Each replaces a sequential stage
// that the JAX package compiles into the analysis pass's one XLA program
// under jax.jit, and that eager PyTorch would run as a Python loop of small
// kernels (thousands a pass, the device idle most of the time):
//   W1 pool_kernel        qpnet_tpu/dsp/world/jax_f0.py::_pool_candidates
//                         (its lax.fori_loop over channel ranks)
//   W2 viterbi_kernel     jax_f0.py::_viterbi (the forward lax.scan and the
//                         back-track lax.scan)
//   W3 fix_contour_kernel jax_f0.py::_fix_contour_scan, FixF0Contour steps
//                         3-4 (the forward and the reversed lax.scan)
//   W4 smooth_kernel      qpnet_tpu/dsp/world/jax_analysis.py::
//                         _jax_linear_smoothing (the fractional-box
//                         convolution over 2*kmax offsets)
//
// Bits.  Every kernel keeps its plain version's order of operations: each
// multiply and add rounded on its own (__fmul_rn/__fadd_rn; the file is
// built with -fmad=false as well), IEEE division, clamp_min propagating
// NaN, and every min/argmin taking the first index of a tie with NaN
// winning, as PyTorch's reductions do (LessOrNan).  That order on (value,
// index) pairs is total, so a min taken as a tree of pairwise choices picks
// the same pair, bits and index, as the serial walk.  Python scalars enter
// as float32, as PyTorch casts them for float32 tensors.
//
// Bounds on the H100 (3.35 TB/s; float32 outside the tensor cores 67e12
// operations/s counting a fused multiply-add as two, so 33.5e12 separate
// multiplies or adds a second, which is what -fmad=false issues):
//   W1: bytes (2 * n_ch * F + F * K floats, about 1.4 MB at 10 s), far
//     less than a launch costs; chip_smoke.py times an empty launch over
//     W1's grid (launch_floor_kernel) as its measured floor.  A block takes
//     POOL_TILE = 8 frames, a warp each: it stages the tile's n_ch x 8 f and
//     sp values in shared memory (a rank's 8 frames are one 32-byte sector),
//     then lane r of a warp holds ranks r, r + 32, r + 64, .., 32 at a time:
//     its ok and its dup flag against every slot (the K slots, the same in
//     every lane, empty ones 0 as in the plain version).  Selection goes in
//     rounds: __ballot_sync of (ok and not dup) over lanes past the last
//     kept, __ffs, and a shuffle of that rank's f give the next rank the
//     serial walk keeps; the slots take pooled + one_hot * f as the plain
//     version adds it (0 * f is NaN for f = +inf), and each lane tests the
//     new slot only, since dup only grows as slots fill (but for +inf,
//     after which every other slot is NaN).  At most K + ceil(n_ch / 32)
//     rounds a frame, where the serial walk takes n_ch steps.
//     K > POOL_REGS = 16 (up to MAX_POOL = 255, harvest's limit: its S = K
//     + 1 states keep uint8 back-pointers): the slots leave the registers
//     for shared memory, K floats a warp past the tile (8 K floats a block,
//     which ops/world_kernel.py pool_max_ranks counts).  Lane l writes
//     slots l, l + 32, .. in a round, every lane reads each slot (a
//     broadcast, no bank conflict), __syncwarp between; the dup tests run
//     against all K slots as above, the empty ones included.  Harvest's K =
//     6 keeps the register build, whose slots need no shared round trip.
//   W4: bytes and operations about even (F * (W + 4 kmax) + F * W floats,
//     17-21 MB, and 2 * F * W * 2 kmax multiplies and adds a D4C call at
//     10 s).  Register-blocked: a thread's item is SMOOTH_R = 4
//     consecutive bins of one frame, summed over a sliding window of the
//     extended row held in registers, so one 16-byte shared load of 4
//     values and one of 4 weights feed 16 products (0.125 shared loads a
//     product, against 2 in the one-bin-a-thread design).  A block's 256
//     threads take 256 * items consecutive (frame, bin-group) items of the
//     flattened grid, so no block is ragged (only the grid's last); it
//     stages only the columns of the rows they read with asynchronous
//     copies.  The rows lie in device memory at 4-byte alignment only
//     (W + 2 kmax is odd at W = 513 and 1025), so the copies are 4-byte
//     cp.async into 16-byte-aligned shared rows, coalesced.  The host
//     gives a thread 1, 2 or 4 items as the grid holds under 0.75, under
//     1.5 or more waves of resident threads: staging and a barrier are a
//     block's fixed cost, worth sharing on long passes, while short passes
//     need every block they can get.  Each output's sum still runs over
//     the offsets in order, one rounded product and one rounded add each;
//     an item's 4 outputs are stored as one float4 where 16-byte aligned.
//   W2, W3: a chain of dependent steps over F frames (F = 601 at 3 s, 2001
//     at 10 s; W3 twice).  Their bytes (a few floats a frame) and
//     operations are a microsecond's work; each step waits for the one
//     before.  chip_smoke.py times a probe kernel of each chain with a
//     minimal step at every frame (chain_probe_kernel), the floor of a walk
//     over every frame, and for W3, which walks only the frames whose value
//     its carry decides, an empty launch with its block as well.
//     W2 (viterbi_kernel), a block of 4 warps, min-plus over S = K + 1 <= 16
//       states.  Warps 1-3 produce: for each chunk of VIT_CH frames they
//       copy its emission rows and logf rows into a ring of VIT_STAGES
//       shared-memory stages with cp.async, compute its (S, S) transition
//       costs with the plain version's expression, and hand the stage over
//       on an mbarrier ("full"); warp 0 hands it back on another ("empty").
//       Warp 0 runs the chain alone: P lanes a state (the largest power of
//       two with S * P <= 32; P = 4 for S = 7), lane q of state s holding
//       the state's running cost in a register and the NP = ceil(S / P)
//       predecessors q * NP .. q * NP + NP - 1, so a lower lane holds lower
//       indices.  A step broadcasts the previous costs with __shfl_sync,
//       adds the staged transitions, takes the lane's first-index min as a
//       tree over its positions, then the state's min over its P lanes as a
//       butterfly of __shfl_xor_sync over blocks of lanes growing from 1,
//       so a partner's block lies wholly below or above and a tie goes to
//       the lower (no index compare on the chain; the index rides along),
//       and adds the emission.  Every choice is a select, not a branch:
//       about log2(P) + 1 shuffle latencies a frame, no shared round trip
//       and no device memory on the chain.  Back-pointers
//       (F - 1, S) uint8 stay in shared memory while (F - 1) * S <=
//       VIT_BACK_SMEM (80 KiB: 11,703 frames, 58 s at 5 ms, for S = 7; 25 s
//       for S = 16); past that they go to device memory (the wrapper's
//       scratch), the same code with the other address space, read back
//       after the block's barrier.  The back-track is
//       segmented across the block: with G = 128 / S segments, thread
//       (g, s) walks segment g from state s at its end to its start,
//       thread 0 chains the G maps from the last frame's argmin, and
//       thread g walks segment g once more from its known end state,
//       writing f0: about 2 (F - 1) / G + G dependent loads instead of F.
//     W2 past VIT_NARROW = 16 states (viterbi_wide_kernel, S up to
//       MAX_STATES = 256), a block of 8 warps.  A staged (S, S) ring no
//       longer fits (16 KB a frame at S = 64), so each thread computes its
//       transitions itself with the plain version's expression (3 rounded
//       operations) from logf rows that all threads stage with cp.async,
//       VITW_CH = 16 frames a chunk in two buffers (the next chunk copied
//       while this one runs, waited for at its last frame).  P lanes a
//       state, the largest power of two <= 32 with S * P <= 256 (8 at S <=
//       32, 1 past 128): lane q walks its predecessors q * NP .. q * NP +
//       NP - 1 in index order (replaces()), then the butterfly over the P
//       lanes as above.  The previous frame's costs come from shared
//       memory, double-buffered, one block barrier a frame.  The work is
//       S^2 transitions a frame, about 10 instructions each, so S = 256
//       takes about 5,000 cycles a frame on the SM's 4 schedulers; the
//       back-track is the one above with G = 256 / S >= 1 segments (128 /
//       S would be 0 past 128); back-pointers spill past VIT_BACK_SMEM as
//       above.  Harvest's S = 7 keeps the one-warp build, whose chain runs
//       on shuffles with no barrier a frame.
//     W3 (fix_contour_kernel), a block of 8 warps.  A frame's value
//       depends on the carried (prev2, prev1, alive, was_gap) only where it
//       selects: a gap frame while the extension chain is alive, and a
//       section's first frame reached by a chain that survived its gap.
//       Everywhere else it is a copy: step2 inside a section, 0 (forward)
//       or step 3 (backward) in a gap whose chain is dead.  So all 256
//       threads stage the candidates (F, C) and step2 in shared memory with
//       cp.async and start step 3 as those copies (while F (C + 2) floats
//       fit a block: 6,456 frames, 32 s, at C = 7; 1,709 at C = 32; longer
//       passes run the same walks on device memory, step 3 in out).  Then
//       warp 0 walks, every lane with the same carry: frame by frame where
//       the carry decides, holding the frame's C candidates in CW = 8, 16
//       or 32 register slots (read while the frame before selects) and
//       taking the nearest to (3 prev1 - prev2) / 2 as a tree of selects in
//       registers (no shuffle; the first index of a tie, NaN first, the
//       candidate riding along; slots past C never win), then the plain
//       version's IEEE division for the fail test.  A run of copied frames
//       (a section up to its next gap, a dead gap up to its next section)
//       is jumped 32 frames a __ballot_sync, and the carry is read back
//       from step 3.  The forward walk writes its selects into step 3, the
//       backward reads and overwrites it in place, and the block writes out
//       once, coalesced, at the end.  At 3 s a pass selects at a few dozen
//       of its 1,201 walk steps.
//     W3 past FIX_NARROW = 32 candidates (C up to MAX_CANDS = 256): the
//       same walks, but lane l holds the contiguous block of m = ceil(C /
//       32) candidates l * m .. l * m + m - 1 (FIX_LANE_SLOTS = 8 register
//       slots, past C +inf), so a lower lane holds wholly lower indices;
//       each lane takes its nearest as the tree above, and a butterfly of
//       __shfl_xor_sync with the candidate riding along picks the warp's,
//       a tie to the lower block (W2's rule), then the IEEE division.
//       Staged while F (C + 2) floats fit (225 frames at C = 256), else on
//       device memory, as above.  DIO's C = 7 keeps the 8-slot build: the
//       butterfly's 5 shuffle rounds would lengthen every select.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_POOL = 255;    // ops/world_kernel.py MAX_POOL
constexpr int MAX_STATES = 256;  // MAX_STATES (uint8 back-pointers)
constexpr int MAX_CANDS = 256;   // MAX_CANDS
constexpr int POOL_REGS = 16;    // W1: K up to this: slots in registers
constexpr int VIT_NARROW = 16;   // W2: S up to this: one chain warp
constexpr int FIX_NARROW = 32;   // W3: C up to this: 8, 16 or 32 slots
constexpr int FIX_LANE_SLOTS = 8;  // W3 past it: ceil(C / 32) <= 8 a lane
constexpr int POOL_TILE = 8;     // W1: frames a block, a warp each
constexpr int POOL_THREADS = 32 * POOL_TILE;
constexpr int FIX_THREADS = 256;  // W3: all stage, warp 0 walks
constexpr int VIT_THREADS = 128;               // W2: warp 0 the chain,
constexpr int VIT_PRODUCERS = VIT_THREADS - 32;  // warps 1-3 the producers
constexpr int VIT_CH = 32;       // W2: frames a ring stage holds
constexpr int VIT_STAGES = 4;    // W2: ring stages
constexpr int VITW_THREADS = 256;  // W2 past VIT_NARROW: states over 8 warps
constexpr int VITW_CH = 16;        // W2 past VIT_NARROW: frames a staged chunk
constexpr int VIT_BACK_SMEM = 81920;  // ops/world_kernel.py VITERBI_BACK_SMEM
constexpr int SMOOTH_THREADS = 256;   // ops/world_kernel.py SMOOTH_THREADS
constexpr int SMOOTH_R = 4;           // SMOOTH_R: bins an item
constexpr int SMEM_MAX = 232448;      // shared memory a block may use

// Host state kept per device, so that a launch makes no driver query:
// whether each kernel's shared-memory limit is raised (slot 0 W4, 1 W1,
// 2 log2(P) + SPILL W2's instantiations, 12-14 W3's, 15 the empty launch,
// 16 W1's wide build, 17 + SPILL W2's, 19 W3's) and the SM count (W4's
// items).
// Two threads may both set an entry; the calls are idempotent.
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_SLOTS = 20;
std::atomic<bool> g_smem_raised[SMEM_SLOTS][MAX_DEVICES];
std::atomic<int> g_sms[MAX_DEVICES];

// raises fn's dynamic shared-memory limit to `bytes` (the most that kernel
// can ask for) on the current device, once per device
cudaError_t raise_smem_once(const void* fn, int slot, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < MAX_DEVICES;
  if (cached && g_smem_raised[slot][dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && cached)
    g_smem_raised[slot][dev].store(true, std::memory_order_release);
  return err;
}

// the current device's SM count, queried once per device
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) {
    *sms = g_sms[dev].load(std::memory_order_acquire);
    if (*sms > 0) return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES)
    g_sms[dev].store(*sms, std::memory_order_release);
  return err;
}

// torch.clamp_min(x, lo): NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// True when value v at a later index replaces the running best b of a
// first-index min/argmin (PyTorch's LessOrNan: NaN wins, ties keep the
// earlier index); branch-free.
__device__ __forceinline__ bool replaces(float v, float b) {
  return (isnan(v) & !isnan(b)) | (v < b);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 mb_state;\n"
               "mbarrier.arrive.shared::cta.b64 mb_state, [%0];\n}\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// waits until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
  }
}

// ---------------------------------------------------------------------------
// W1: candidate pooling, a warp a frame (see the note at the top)
// ---------------------------------------------------------------------------

// pool_reference's duplicate test of f against one slot p: |f - p| <
// 0.05 * clamp_min(p, 1e-9), each step rounded on its own
__device__ __forceinline__ bool pool_dup(float f, float p) {
  return fabsf(__fsub_rn(f, p)) < __fmul_rn(0.05f, clamp_min_nan(p, 1e-9f));
}

// the dynamic shared memory of W1's block: f and sp of n_ch ranks x
// POOL_TILE frames, each rank's row POOL_TILE + 1 floats (no bank conflict
// when lane r reads rank r0 + r), and past POOL_REGS each warp's K slots
__host__ __device__ constexpr size_t pool_smem(int n_ch, int K) {
  return (2 * (size_t)n_ch * (POOL_TILE + 1)
          + (K > POOL_REGS ? (size_t)POOL_TILE * K : 0)) * sizeof(float);
}

// WIDE (K > POOL_REGS): the same rounds with the K slots in shared memory
template <bool WIDE>
__global__ void __launch_bounds__(POOL_THREADS)
pool_kernel(const float* __restrict__ f_sorted,
            const float* __restrict__ sp_sorted, int n_ch, int F, int K,
            float thr, float* __restrict__ out) {
  extern __shared__ float psm[];
  float* s_f = psm;                                // [rank][POOL_TILE + 1]
  float* s_sp = psm + (size_t)n_ch * (POOL_TILE + 1);
  const int t0 = blockIdx.x * POOL_TILE;
  const int nt = min(POOL_TILE, F - t0);
  // the tile: POOL_TILE neighbouring frames of a rank are one 32-byte
  // sector, so a warp's loads cover 4 ranks' sectors whole
  for (int i = threadIdx.x; i < n_ch * POOL_TILE; i += POOL_THREADS) {
    const int r = i / POOL_TILE, u = i % POOL_TILE;
    if (u < nt) {
      s_f[r * (POOL_TILE + 1) + u] = f_sorted[(size_t)r * F + t0 + u];
      s_sp[r * (POOL_TILE + 1) + u] = sp_sorted[(size_t)r * F + t0 + u];
    }
  }
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (w >= nt) return;                 // warp-uniform: the tile's last frames
  if constexpr (WIDE) {
    // the warp's K slots past the tile, lane l writing slots l, l + 32, ..
    // and every lane reading each (a broadcast); the rounds as below
    float* p = s_sp + (size_t)n_ch * (POOL_TILE + 1) + (size_t)w * K;
    for (int k = lane; k < K; k += 32) p[k] = 0.0f;
    __syncwarp();
    int n = 0;
    for (int r0 = 0; r0 < n_ch && n < K; r0 += 32) {
      const int r = r0 + lane;
      const float f = r < n_ch ? s_f[r * (POOL_TILE + 1) + w] : 0.0f;
      const float sp = r < n_ch ? s_sp[r * (POOL_TILE + 1) + w] : 0.0f;
      const bool ok = r < n_ch && sp <= thr && f > 0.0f;
      bool dup = false;
      for (int k = 0; k < K; ++k) dup = dup | pool_dup(f, p[k]);
      unsigned m = __ballot_sync(FULL, ok && !dup);
      while (m != 0u && n < K) {
        const int src = __ffs(m) - 1;
        const float fn = __shfl_sync(FULL, f, src);
        const float z = __fmul_rn(0.0f, fn);
        __syncwarp();                  // every lane has read the slots
        for (int k = lane; k < K; k += 32)
          p[k] = __fadd_rn(p[k], k == n ? fn : z);
        __syncwarp();
        const float pn = p[n];
        ++n;
        dup = (isinf(fn) ? false : dup) | pool_dup(f, pn);
        m = __ballot_sync(FULL, ok && !dup && lane > src);
      }
    }
    for (int k = lane; k < K; k += 32) out[(size_t)(t0 + w) * K + k] = p[k];
    return;
  }
  // the K slots, the same in every lane; empty ones hold 0, as the plain
  // version's do
  float p[POOL_REGS];
#pragma unroll
  for (int k = 0; k < POOL_REGS; ++k) p[k] = 0.0f;
  int n = 0;
  for (int r0 = 0; r0 < n_ch && n < K; r0 += 32) {
    // lane r holds rank r0 + r: its ok, and its dup flag against every
    // slot, the empty ones included (|f - 0| < 0.05f * 1e-9f, rounded)
    const int r = r0 + lane;
    const float f = r < n_ch ? s_f[r * (POOL_TILE + 1) + w] : 0.0f;
    const float sp = r < n_ch ? s_sp[r * (POOL_TILE + 1) + w] : 0.0f;
    const bool ok = r < n_ch && sp <= thr && f > 0.0f;   // NaN fails
    bool dup = false;
#pragma unroll
    for (int k = 0; k < POOL_REGS; ++k)
      if (k < K) dup = dup | pool_dup(f, p[k]);
    // rounds: the lowest rank that agrees and is no duplicate is the next
    // one the serial walk keeps
    unsigned m = __ballot_sync(FULL, ok && !dup);
    while (m != 0u && n < K) {
      const int src = __ffs(m) - 1;
      const float fn = __shfl_sync(FULL, f, src);
      // pooled + where(take, one_hot(n) * f, 0): slot n gets 0 + f, the
      // others + 0 * f, which is +0, or NaN where f is +inf
      const float z = __fmul_rn(0.0f, fn);
      float pn = 0.0f;
#pragma unroll
      for (int k = 0; k < POOL_REGS; ++k) {
        if (k < K) p[k] = __fadd_rn(p[k], k == n ? fn : z);
        pn = k == n ? p[k] : pn;
      }
      ++n;
      // dup only grows as a slot fills (an empty slot is left while a
      // later rank can still be kept), so each lane tests the new slot
      // alone; but a +inf kept turns every other slot to NaN, whose tests
      // fail, so then only the new slot's test stands
      dup = (isinf(fn) ? false : dup) | pool_dup(f, pn);
      m = __ballot_sync(FULL, ok && !dup && lane > src);
    }
  }
  if (lane < K) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < POOL_REGS; ++k) v = k == lane ? p[k] : v;
    out[(size_t)(t0 + w) * K + lane] = v;
  }
}

// ---------------------------------------------------------------------------
// W2: the Viterbi, a producer-consumer block (see the note at the top)
// ---------------------------------------------------------------------------

// lanes a state: the largest power of two with S * P <= 32
__host__ __device__ constexpr int vit_lanes(int S) {
  return S <= 1 ? 32 : S == 2 ? 16 : S <= 4 ? 8 : S <= 8 ? 4 : 2;
}

// predecessor positions a lane holds for every S that P serves:
// ceil(min(16, 32 / P) / P), so q * NPOS .. q * NPOS + NPOS - 1
__host__ __device__ constexpr int vit_positions(int P) {
  return ((32 / P < VIT_NARROW ? 32 / P : VIT_NARROW) + P - 1) / P;
}

// byte offsets of W2's dynamic shared memory
struct VitLayout {
  size_t tr, em, lf, back, total;
};

constexpr size_t VIT_HEAD = 2 * VIT_STAGES * sizeof(uint64_t)   // barriers
                            + (2 * VIT_THREADS + 4) * sizeof(int);

__host__ __device__ constexpr VitLayout vit_layout(int F, int K, bool spill) {
  const int S = K + 1, NPOS = vit_positions(vit_lanes(S));
  VitLayout L{};
  size_t o = VIT_HEAD;
  L.tr = o;      // transitions: [stage][frame][position][lane]
  o += (size_t)VIT_STAGES * VIT_CH * NPOS * 32 * sizeof(float);
  L.em = o;      // emission rows: [stage][frame][state]
  o += (size_t)VIT_STAGES * VIT_CH * S * sizeof(float);
  L.lf = o;      // logf rows t0 - 1 .. t0 + VIT_CH - 1: [stage][row][k]
  o += (size_t)VIT_STAGES * (VIT_CH + 1) * K * sizeof(float);
  L.back = o;    // back-pointers [frame][state], unless they spill
  if (!spill) o += (size_t)(F - 1) * S;
  L.total = o;
  return L;
}

// W2's back-track by a block of THREADS threads, once the back-pointers bk
// ((F - 1) x S) and the last frame's state *s_last are visible to it: G =
// THREADS / S >= 1 segments of seg frames; segment g covers frames (a_g,
// e_g], a_g = min(g * seg, rows); back row u - 1 maps the state at frame u
// to the state at frame u - 1
template <int THREADS>
__device__ __forceinline__ void vit_backtrack(const uint8_t* bk,
                                              const float* refined, int F,
                                              int K, int* s_map, int* s_end,
                                              const int* s_last, float* f0) {
  const int S = K + 1, rows = F - 1, tid = threadIdx.x;
  const int G = THREADS / S;
  const int seg = (rows + G - 1) / G;
  // walk 1: thread (g1, s0) maps state s0 at e_g1 to its state at a_g1
  int x = tid % S;
  if (tid < G * S) {
    const int a = min(tid / S * seg, rows), e = min(a + seg, rows);
    for (int u = e; u > a; --u)
      x = bk[(size_t)(u - 1) * S + x];
    s_map[tid] = x;
  }
  __syncthreads();
  if (tid == 0) {
    int y = *s_last;
    for (int g = G - 1; g >= 0; --g) {
      s_end[g] = y;
      y = s_map[g * S + y];
    }
  }
  __syncthreads();
  // walk 2: thread g < G walks segment g from its end state, writing f0
  if (tid < G) {
    const int a = min(tid * seg, rows), e = min(a + seg, rows);
    x = s_end[tid];
    for (int u = e; u > a; --u) {
      f0[u] = x > 0 ? refined[(size_t)u * K + x - 1] : 0.0f;
      x = bk[(size_t)(u - 1) * S + x];
    }
    if (tid == 0) f0[0] = x > 0 ? refined[x - 1] : 0.0f;
  }
}

template <int P, bool SPILL>
__global__ void __launch_bounds__(VIT_THREADS)
viterbi_kernel(const float* __restrict__ emits,
               const float* __restrict__ logf,
               const float* __restrict__ refined, int F, int K, float tc,
               float uc, uint8_t* back, float* __restrict__ f0) {
  constexpr int NPOS = vit_positions(P);
  const int S = K + 1;
  const VitLayout L = vit_layout(F, K, SPILL);
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + VIT_STAGES;
  int* s_map = reinterpret_cast<int*>(empty + VIT_STAGES);  // [g][s]
  int* s_end = s_map + VIT_THREADS;                         // [g]
  int* s_last = s_end + VIT_THREADS;
  float* ring_tr = reinterpret_cast<float*>(smem + L.tr);
  float* ring_em = reinterpret_cast<float*>(smem + L.em);
  float* ring_lf = reinterpret_cast<float*>(smem + L.lf);
  uint8_t* bk = SPILL ? back : smem + L.back;

  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int st = 0; st < VIT_STAGES; ++st) {
      mbar_init(&full[st], VIT_PRODUCERS);
      mbar_init(&empty[st], 32);
    }
  }
  __syncthreads();
  const int rows = F - 1;                       // frames 1 .. F-1 step
  const int n_chunks = (rows + VIT_CH - 1) / VIT_CH;

  if (tid >= 32) {
    // producers: stage chunk c in ring stage c % VIT_STAGES
    const int pt = tid - 32;
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % VIT_STAGES, round = c / VIT_STAGES;
      if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
      const int t0 = 1 + c * VIT_CH, n = min(VIT_CH, F - t0);
      float* em = ring_em + st * VIT_CH * S;
      float* lf = ring_lf + st * (VIT_CH + 1) * K;
      float* tr = ring_tr + st * VIT_CH * NPOS * 32;
      for (int i = pt; i < n * S; i += VIT_PRODUCERS)
        cp_async4(em + i, emits + (size_t)t0 * S + i);
      for (int i = pt; i < (n + 1) * K; i += VIT_PRODUCERS)
        cp_async4(lf + i, logf + (size_t)(t0 - 1) * K + i);
      cp_async_wait_all();
      asm volatile("bar.sync 1, %0;\n" :: "r"(VIT_PRODUCERS) : "memory");
      // trans[s, p]: 0 for (0, 0), uc to or from the unvoiced state, else
      // tc * |logf_t[s-1] - logf_{t-1}[p-1]| (the plain version's order)
      for (int i = pt; i < n * NPOS * 32; i += VIT_PRODUCERS) {
        const int l = i & 31, k = (i >> 5) % NPOS, f = (i >> 5) / NPOS;
        const int s = l / P, p = l % P * NPOS + k;
        float v = 0.0f;
        if (s < S && p < S) {
          if (s == 0 || p == 0)
            v = (s == 0 && p == 0) ? 0.0f : uc;
          else
            v = __fmul_rn(tc, fabsf(__fsub_rn(lf[(f + 1) * K + s - 1],
                                              lf[f * K + p - 1])));
        }
        tr[i] = v;
      }
      mbar_arrive(&full[st]);
    }
  } else {
    // the chain: lane = s * P + q holds positions q * NPOS + k, the
    // predecessors among them (p < S), so a lower lane holds lower indices
    // and a tie goes to it
    const int s = lane / P, q = lane % P;
    const bool live = s < S;
    const float INF = __int_as_float(0x7f800000);
    int src[NPOS];                     // the lane holding cost[p]
#pragma unroll
    for (int k = 0; k < NPOS; ++k) src[k] = min(q * NPOS + k, S - 1) * P;
    float cost = live ? emits[s] : 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % VIT_STAGES, round = c / VIT_STAGES;
      mbar_wait(&full[st], round & 1);
      const int t0 = 1 + c * VIT_CH, n = min(VIT_CH, F - t0);
      const float* em = ring_em + st * VIT_CH * S + (live ? s : 0);
      const float* tr = ring_tr + st * VIT_CH * NPOS * 32 + lane;
      // frame f's operands are loaded during frame f - 1's step
      float trk[NPOS], e = em[0];
#pragma unroll
      for (int k = 0; k < NPOS; ++k) trk[k] = tr[k * 32];
#pragma unroll 4
      for (int f = 0; f < n; ++f) {
        const int fn = min(f + 1, n - 1);
        float trn[NPOS];
#pragma unroll
        for (int k = 0; k < NPOS; ++k) trn[k] = tr[(fn * NPOS + k) * 32];
        const float en = em[fn * S];
        float v[NPOS];
        int ix[NPOS];
#pragma unroll
        for (int k = 0; k < NPOS; ++k) {
          const float cp = __shfl_sync(FULL, cost, src[k]);
          ix[k] = q * NPOS + k;
          v[k] = ix[k] < S ? __fadd_rn(cp, trk[k]) : INF;  // INF never wins
        }
        // the lane's first-index min as a tree over its positions
#pragma unroll
        for (int w = 1; w < NPOS; w *= 2) {
#pragma unroll
          for (int k = 0; k + w < NPOS; k += 2 * w) {
            const bool take = replaces(v[k + w], v[k]);
            v[k] = take ? v[k + w] : v[k];
            ix[k] = take ? ix[k + w] : ix[k];
          }
        }
        // the state's min: a butterfly over its P lanes, aligned blocks of
        // lanes growing, so the partner's block lies wholly below or above
        // (a tie goes to the lower; the index rides along)
        float best = v[0];
        int bi = ix[0];
#pragma unroll
        for (int off = 1; off < P; off <<= 1) {
          const float bo = __shfl_xor_sync(FULL, best, off);
          const int io = __shfl_xor_sync(FULL, bi, off);
          const bool take = (q & off) ? !replaces(best, bo)
                                      : replaces(bo, best);
          best = take ? bo : best;
          bi = take ? io : bi;
        }
        cost = __fadd_rn(best, e);
        if (live && q == 0) bk[(size_t)(t0 + f - 1) * S + s] = (uint8_t)bi;
#pragma unroll
        for (int k = 0; k < NPOS; ++k) trk[k] = trn[k];
        e = en;
      }
      __syncwarp();
      mbar_arrive(&empty[st]);
    }
    // the last frame's state: first-index argmin of the S costs
    float b = __shfl_sync(FULL, cost, 0);
    int bs = 0;
    for (int s2 = 1; s2 < S; ++s2) {
      const float v = __shfl_sync(FULL, cost, s2 * P);
      if (replaces(v, b)) {
        b = v;
        bs = s2;
      }
    }
    if (lane == 0) *s_last = bs;
  }
  // the back-pointers, in shared or (spilled) device memory, are visible
  // to the whole block past this barrier
  __syncthreads();
  vit_backtrack<VIT_THREADS>(bk, refined, F, K, s_map, s_end, s_last, f0);
}

// the most shared memory viterbi_kernel<P, spill> asks for: the ring at
// the most states P serves, and the back-pointers' capacity unless they spill
constexpr size_t vit_smem_max(int P, bool spill) {
  return vit_layout(1, (32 / P < VIT_NARROW ? 32 / P : VIT_NARROW) - 1,
                    true).total
         + (spill ? 0 : VIT_BACK_SMEM);
}

constexpr int log2_lanes(int P) { return P <= 1 ? 0 : 1 + log2_lanes(P / 2); }

template <int P>
int launch_viterbi(const float* emits, const float* logf,
                   const float* refined, int F, int K, float tc, float uc,
                   uint8_t* back, float* f0, bool spill, cudaStream_t stream) {
  static_assert(vit_smem_max(P, false) <= SMEM_MAX, "W2's layout");
  const size_t smem = vit_layout(F, K, spill).total;
  if (smem > vit_smem_max(P, spill)) return (int)cudaErrorInvalidValue;
  const void* fn = spill ? (const void*)viterbi_kernel<P, true>
                         : (const void*)viterbi_kernel<P, false>;
  const cudaError_t err = raise_smem_once(
      fn, 2 * log2_lanes(P) + (spill ? 1 : 0), (int)vit_smem_max(P, spill));
  if (err != cudaSuccess) return (int)err;
  if (spill)
    viterbi_kernel<P, true><<<1, VIT_THREADS, smem, stream>>>(
        emits, logf, refined, F, K, tc, uc, back, f0);
  else
    viterbi_kernel<P, false><<<1, VIT_THREADS, smem, stream>>>(
        emits, logf, refined, F, K, tc, uc, back, f0);
  return (int)cudaGetLastError();
}

// W2 past VIT_NARROW states (see the note at the top): lanes a state, the
// largest power of two P <= 32 with S * P <= VITW_THREADS
__host__ __device__ constexpr int vitw_lanes(int S) {
  return S <= 8 ? 32 : S <= 16 ? 16 : S <= 32 ? 8 : S <= 64 ? 4
         : S <= 128 ? 2 : 1;
}

// byte offsets of the wide W2's dynamic shared memory
struct VitWideLayout {
  size_t cost, em, lf, back, total;
};

constexpr size_t VITW_HEAD = (2 * VITW_THREADS + 4) * sizeof(int);

__host__ __device__ constexpr VitWideLayout vitw_layout(int F, int K,
                                                        bool spill) {
  const int S = K + 1;
  VitWideLayout L{};
  size_t o = VITW_HEAD;
  L.cost = o;    // running costs, double-buffered: [frame & 1][state]
  o += 2 * (size_t)S * sizeof(float);
  L.em = o;      // emission rows: [chunk & 1][frame][state]
  o += 2 * (size_t)VITW_CH * S * sizeof(float);
  L.lf = o;      // logf rows t0 - 1 .. t0 + VITW_CH - 1: [chunk & 1][row][k]
  o += 2 * (size_t)(VITW_CH + 1) * K * sizeof(float);
  L.back = o;    // back-pointers [frame][state], unless they spill
  if (!spill) o += (size_t)(F - 1) * S;
  L.total = o;
  return L;
}

// chunk c's emission rows t0 .. t0 + n - 1 and logf rows t0 - 1 .. t0 + n
// - 1 into buffer c & 1, by every thread of the block with cp.async
__device__ __forceinline__ void vitw_stage(const float* emits,
                                           const float* logf, float* s_em,
                                           float* s_lf, int F, int K, int c) {
  const int S = K + 1, t0 = 1 + c * VITW_CH, n = min(VITW_CH, F - t0);
  float* em = s_em + (c & 1) * VITW_CH * S;
  float* lf = s_lf + (c & 1) * (VITW_CH + 1) * K;
  for (int i = threadIdx.x; i < n * S; i += VITW_THREADS)
    cp_async4(em + i, emits + (size_t)t0 * S + i);
  for (int i = threadIdx.x; i < (n + 1) * K; i += VITW_THREADS)
    cp_async4(lf + i, logf + (size_t)(t0 - 1) * K + i);
}

template <bool SPILL>
__global__ void __launch_bounds__(VITW_THREADS)
viterbi_wide_kernel(const float* __restrict__ emits,
                    const float* __restrict__ logf,
                    const float* __restrict__ refined, int F, int K,
                    float tc, float uc, uint8_t* back,
                    float* __restrict__ f0) {
  const int S = K + 1, P = vitw_lanes(S), NP = (S + P - 1) / P;
  const VitWideLayout L = vitw_layout(F, K, SPILL);
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_map = reinterpret_cast<int*>(smem);            // [g][s]
  int* s_end = s_map + VITW_THREADS;                    // [g]
  int* s_last = s_end + VITW_THREADS;
  float* s_cost = reinterpret_cast<float*>(smem + L.cost);
  float* s_em = reinterpret_cast<float*>(smem + L.em);
  float* s_lf = reinterpret_cast<float*>(smem + L.lf);
  uint8_t* bk = SPILL ? back : smem + L.back;
  const float INF = __int_as_float(0x7f800000);

  // thread (s, q): lane q of state s's P lanes (one warp), holding the
  // predecessors p0 .. p1 - 1, so a lower lane holds lower indices
  const int tid = threadIdx.x, s = tid / P, q = tid % P;
  const bool live = s < S;
  const int p0 = q * NP, p1 = min(p0 + NP, S);
  const int rows = F - 1, n_chunks = (rows + VITW_CH - 1) / VITW_CH;
  for (int i = tid; i < S; i += VITW_THREADS) s_cost[i] = emits[i];
  if (n_chunks > 0) vitw_stage(emits, logf, s_em, s_lf, F, K, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    // the next chunk into the other buffer, which every thread left at the
    // last frame's barrier; waited for at this chunk's last frame
    if (c + 1 < n_chunks) vitw_stage(emits, logf, s_em, s_lf, F, K, c + 1);
    const int t0 = 1 + c * VITW_CH, n = min(VITW_CH, F - t0);
    const float* em = s_em + (c & 1) * VITW_CH * S;
    const float* lf = s_lf + (c & 1) * (VITW_CH + 1) * K;
    for (int f = 0; f < n; ++f) {
      const int t = t0 + f;
      const float* prev = s_cost + ((t - 1) & 1) * S;
      const float* lfp = lf + f * K;                     // logf_{t-1}
      const float lfs = live && s > 0 ? lf[(f + 1) * K + s - 1] : 0.0f;
      const float e = live ? em[f * S + s] : 0.0f;
      // the lane's first-index min over its predecessors in order: 0 from
      // the unvoiced state to itself, uc to or from it, else tc *
      // |logf_t[s-1] - logf_{t-1}[p-1]| (the plain version's order)
      float best = INF;
      int bi = p0, p = p0;
      if (p == 0 && p < p1) {
        best = __fadd_rn(prev[0], s == 0 ? 0.0f : uc);  // INF's bits if +inf
        p = 1;
      }
      for (; p < p1; ++p) {
        const float tr =
            s == 0 ? uc : __fmul_rn(tc, fabsf(__fsub_rn(lfs, lfp[p - 1])));
        const float v = __fadd_rn(prev[p], tr);
        const bool take = replaces(v, best);
        best = take ? v : best;
        bi = take ? p : bi;
      }
      // the state's min: a butterfly over its P lanes, as the narrow chain's
      for (int off = 1; off < P; off <<= 1) {
        const float bo = __shfl_xor_sync(FULL, best, off);
        const int io = __shfl_xor_sync(FULL, bi, off);
        const bool take = (q & off) ? !replaces(best, bo)
                                    : replaces(bo, best);
        best = take ? bo : best;
        bi = take ? io : bi;
      }
      if (live && q == 0) {
        s_cost[(t & 1) * S + s] = __fadd_rn(best, e);
        bk[(size_t)(t - 1) * S + s] = (uint8_t)bi;
      }
      if (f == n - 1) cp_async_wait_all();
      __syncthreads();
    }
  }
  // the last frame's state: first-index argmin of the S costs
  if (tid == 0) {
    const float* cost = s_cost + (rows & 1) * S;
    float b = cost[0];
    int bs = 0;
    for (int s2 = 1; s2 < S; ++s2) {
      if (replaces(cost[s2], b)) {
        b = cost[s2];
        bs = s2;
      }
    }
    *s_last = bs;
  }
  __syncthreads();
  vit_backtrack<VITW_THREADS>(bk, refined, F, K, s_map, s_end, s_last, f0);
}

// the most shared memory viterbi_wide_kernel<spill> asks for
constexpr size_t vitw_smem_max(bool spill) {
  return vitw_layout(1, MAX_STATES - 1, true).total
         + (spill ? 0 : VIT_BACK_SMEM);
}

int launch_viterbi_wide(const float* emits, const float* logf,
                        const float* refined, int F, int K, float tc,
                        float uc, uint8_t* back, float* f0, bool spill,
                        cudaStream_t stream) {
  static_assert(vitw_smem_max(false) <= SMEM_MAX, "W2's wide layout");
  const size_t smem = vitw_layout(F, K, spill).total;
  if (smem > vitw_smem_max(spill)) return (int)cudaErrorInvalidValue;
  const void* fn = spill ? (const void*)viterbi_wide_kernel<true>
                         : (const void*)viterbi_wide_kernel<false>;
  const cudaError_t err = raise_smem_once(fn, 17 + (spill ? 1 : 0),
                                          (int)vitw_smem_max(spill));
  if (err != cudaSuccess) return (int)err;
  if (spill)
    viterbi_wide_kernel<true><<<1, VITW_THREADS, smem, stream>>>(
        emits, logf, refined, F, K, tc, uc, back, f0);
  else
    viterbi_wide_kernel<false><<<1, VITW_THREADS, smem, stream>>>(
        emits, logf, refined, F, K, tc, uc, back, f0);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// W3: DIO's contour walks, staged in shared memory, one chain thread (see
// the note at the top)
// ---------------------------------------------------------------------------

// the real slots of a lane: the first C of CW (narrow), or past FIX_NARROW
// (WIDE) the lane's block of m = ceil(C / 32) candidates from lane * m, so
// a lower lane holds wholly lower indices (none past the last block)
template <bool WIDE>
__device__ __forceinline__ int fix_first(int C) {
  return WIDE ? (int)(threadIdx.x & 31) * ((C + 31) / 32) : 0;
}

template <bool WIDE>
__device__ __forceinline__ int fix_real(int C) {
  return WIDE ? min((C + 31) / 32, C - fix_first<true>(C)) : C;
}

// dio._select_best_f0 on the frame's candidates cv (CW slots, the first
// fix_real real): the candidate nearest (3 prev1 - prev2) / 2, or 0 when
// even it is off by allowed or more (relative).  The arg-min is a tree of
// selects over the slots in registers: a block's lower half holds the
// lower indices, so the upper half's pair is taken only where it comes
// strictly first (replaces(): NaN first, ties to the lower index) and the
// candidate rides along.  Slots past the real ones hold +inf, which never
// comes first.  WIDE: then a butterfly of __shfl_xor_sync over the lanes'
// winners, aligned blocks of lanes growing, the lower block keeping a tie
// (W2's rule), so every lane ends with the warp's first-index arg-min.
template <int CW, bool WIDE>
__device__ __forceinline__ float fix_select(float prev1, float prev2,
                                            const float (&cv)[CW], int C,
                                            float allowed) {
  // the halving as a multiply by 0.5: the same exact value correctly
  // rounded, so the same bits as the plain version's division by 2
  const float ref =
      __fmul_rn(__fsub_rn(__fmul_rn(prev1, 3.0f), prev2), 0.5f);
  const int n = fix_real<WIDE>(C);
  float e[CW], c[CW];
#pragma unroll
  for (int k = 0; k < CW; ++k) {
    e[k] = k < n ? fabsf(__fsub_rn(ref, cv[k])) : __int_as_float(0x7f800000);
    c[k] = cv[k];
  }
#pragma unroll
  for (int w = 1; w < CW; w *= 2) {
#pragma unroll
    for (int k = 0; k + w < CW; k += 2 * w) {
      const bool take = replaces(e[k + w], e[k]);
      e[k] = take ? e[k + w] : e[k];
      c[k] = take ? c[k + w] : c[k];
    }
  }
  if constexpr (WIDE) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float eo = __shfl_xor_sync(FULL, e[0], off);
      const float co = __shfl_xor_sync(FULL, c[0], off);
      const bool take = (lane & off) ? !replaces(e[0], eo)
                                     : replaces(eo, e[0]);
      e[0] = take ? eo : e[0];
      c[0] = take ? co : c[0];
    }
  }
  const bool fail = __fdiv_rn(e[0], clamp_min_nan(ref, 1e-12f)) >= allowed;
  return fail ? 0.0f : c[0];
}

// a frame's candidates (row t of a (F, C) array) into the lane's CW slots
template <int CW, bool WIDE>
__device__ __forceinline__ void fix_row(float (&c)[CW], const float* cv,
                                        int t, int C) {
  const float* row = cv + (size_t)t * C + fix_first<WIDE>(C);
  const int n = fix_real<WIDE>(C);
#pragma unroll
  for (int k = 0; k < CW; ++k) c[k] = k < n ? row[k] : 0.0f;
}

// the first frame u in [t, end) whose inside flag (s2 > 0) is `want`, or
// end: the warp tests 32 frames a ballot
__device__ __forceinline__ int fix_next(const float* s2, int t, int end,
                                        bool want) {
  const int lane = threadIdx.x & 31;
  for (; t < end; t += 32) {
    const int u = t + lane;
    const unsigned m =
        __ballot_sync(FULL, u < end && ((s2[u] > 0.0f) == want));
    if (m != 0u) return t + __ffs(m) - 1;
  }
  return end;
}

// the last frame u in [lo, t] whose inside flag is `want`, or lo - 1
__device__ __forceinline__ int fix_prev(const float* s2, int t, int lo,
                                        bool want) {
  const int lane = threadIdx.x & 31;
  for (; t >= lo; t -= 32) {
    const int u = t - lane;
    const unsigned m =
        __ballot_sync(FULL, u >= lo && ((s2[u] > 0.0f) == want));
    if (m != 0u) return t - (__ffs(m) - 1);
  }
  return lo - 1;
}

// The forward walk (step 3) by one warp, every lane the same carry: s3
// holds each frame's value where the carry does not reach it (in ? step2 :
// 0).  A frame selects where it extends a gap (alive, prev1 > 0) or is a
// section's first frame reached by a chain that survived its gap; those
// frames run one at a time, the next row read while this one selects.
// Elsewhere the carry cannot reach a value: inside a section (was_gap
// false) every frame keeps step2, and once a gap's chain is dead every gap
// frame is 0 and the next section's first keeps step2.  The warp jumps
// such runs to their end with fix_next and reads the carry (prev1, prev2)
// back from s3, where every lane stored each value it selected.
template <int CW, bool WIDE>
__device__ void fix_forward(const float* cv, const float* s2, float* s3,
                            int F, int C, float allowed) {
  float prev2 = 0.0f, prev1 = 0.0f;
  bool alive = false, was_gap = false;
  int t = 0;
  float s2c = s2[0], cur[CW];
  fix_row<CW, WIDE>(cur, cv, 0, C);
  while (t < F) {
    const bool in = s2c > 0.0f;
    if ((in & was_gap & alive) | (!in & alive & (prev1 > 0.0f))) {
      const int tn = min(t + 1, F - 1);
      float nxt[CW];
      fix_row<CW, WIDE>(nxt, cv, tn, C);
      const float s2n = s2[tn];
      const float v = fix_select<CW, WIDE>(prev1, prev2, cur, C, allowed);
      s3[t] = v;
      alive = in | (v > 0.0f);
      was_gap = !in;
      prev2 = prev1;
      prev1 = v;
      ++t;
#pragma unroll
      for (int k = 0; k < CW; ++k) cur[k] = nxt[k];
      s2c = s2n;
      continue;
    }
    // a section's frames up to the next gap, or a dead gap's up to the
    // next section
    t = fix_next(s2, t + 1, F, !in);
    alive = in;
    was_gap = !in;
    if (t < F) {
      prev1 = s3[t - 1];
      prev2 = t >= 2 ? s3[t - 2] : 0.0f;
      s2c = s2[t];
      fix_row<CW, WIDE>(cur, cv, t, C);
    }
  }
}

// The backward walk (step 4) over frames F - 1 .. 1 (frame 0 is never
// written), s3 read and overwritten in place: a gap frame selects while
// the chain is alive; a section's frames and a dead gap's keep step 3,
// jumped with fix_prev.
template <int CW, bool WIDE>
__device__ void fix_backward(const float* cv, const float* s2, float* s3,
                             int F, int C, float allowed) {
  float prev2 = 0.0f, prev1 = 0.0f;
  bool alive = false;
  int t = F - 1;
  float s2c = s2[t], cur[CW];
  fix_row<CW, WIDE>(cur, cv, t, C);
  while (t >= 1) {
    const bool in = s2c > 0.0f;
    if (!in & alive & (prev1 > 0.0f)) {
      const int tn = t - 1;
      float nxt[CW];
      fix_row<CW, WIDE>(nxt, cv, tn, C);
      const float s2n = s2[tn];
      const float v = fix_select<CW, WIDE>(prev1, prev2, cur, C, allowed);
      s3[t] = v;
      alive = v > 0.0f;
      prev2 = prev1;
      prev1 = v;
      --t;
#pragma unroll
      for (int k = 0; k < CW; ++k) cur[k] = nxt[k];
      s2c = s2n;
      continue;
    }
    t = fix_prev(s2, t - 1, 1, !in);
    alive = in;
    if (t >= 1) {
      prev1 = s3[t + 1];
      prev2 = t + 2 < F ? s3[t + 2] : 0.0f;
      s2c = s2[t];
      fix_row<CW, WIDE>(cur, cv, t, C);
    }
  }
}

// true when W3's pass fits a block's shared memory: F (C + 2) floats
__host__ __device__ constexpr bool fix_staged(int F, int C) {
  return (long long)F * (C + 2) * 4 <= SMEM_MAX;
}

template <int CW, bool WIDE>
__global__ void __launch_bounds__(FIX_THREADS)
fix_contour_kernel(const float* __restrict__ step2,
                   const float* __restrict__ cands, int F, int C,
                   float allowed, float* out) {
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x;
  // staged: the candidates, step2 and step 3 in shared memory; else the
  // same walks on device memory, step 3 in out
  const bool staged = fix_staged(F, C);
  const float* cv = staged ? fsm : cands;
  const float* s2 = staged ? fsm + (size_t)F * C : step2;
  float* s3 = staged ? fsm + (size_t)F * (C + 1) : out;
  if (staged)
    for (int i = tid; i < F * C; i += FIX_THREADS)
      cp_async4(fsm + i, cands + i);
  for (int t = tid; t < F; t += FIX_THREADS) {
    const float x = step2[t];
    if (staged) fsm[(size_t)F * C + t] = x;
    s3[t] = x > 0.0f ? x : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();
  if (tid < 32) {
    fix_forward<CW, WIDE>(cv, s2, s3, F, C, allowed);
    fix_backward<CW, WIDE>(cv, s2, s3, F, C, allowed);
  }
  __syncthreads();
  if (staged)
    for (int t = tid; t < F; t += FIX_THREADS) out[t] = s3[t];
}

template <int CW, bool WIDE>
int launch_fix_contour(const float* step2, const float* cands, int F, int C,
                       float allowed, float* out, int slot,
                       cudaStream_t stream) {
  const size_t smem = fix_staged(F, C) ? (size_t)F * (C + 2) * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = raise_smem_once(
        (const void*)fix_contour_kernel<CW, WIDE>, slot, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  fix_contour_kernel<CW, WIDE><<<1, FIX_THREADS, smem, stream>>>(
      step2, cands, F, C, allowed, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// W4: fractional-box smoothing, SMOOTH_R bins a thread (see the note above)
// ---------------------------------------------------------------------------

// W4's shape for `items` items a thread: ng bin groups a frame; a block's
// SMOOTH_THREADS * items consecutive (frame, group) items span at most
// `rows` frames, each staged as rs floats (16-byte aligned, room for the
// last group's window) beside its os weights
struct SmoothLayout {
  int ng, rows, rs, os;
  size_t bytes;
};

__host__ __device__ inline SmoothLayout smooth_layout(int F, int W, int n_off,
                                                      int items) {
  SmoothLayout L;
  L.ng = (W + SMOOTH_R - 1) / SMOOTH_R;
  const int span = (SMOOTH_THREADS * items + L.ng - 1) / L.ng + 1;
  L.rows = F < span ? F : span;
  L.rs = (SMOOTH_R * L.ng + n_off + 3 + 3) / 4 * 4;
  L.os = (n_off + 3) / 4 * 4;
  L.bytes = (size_t)L.rows * (L.rs + L.os) * sizeof(float);
  return L;
}

// items a thread, from the grid's size in waves of resident threads
// (2048 an SM): one where a wave or less of short blocks fills the card,
// more where each block's staging and barrier would be paid many times
__host__ inline int smooth_items(int F, int W, int sms) {
  const double waves = (double)F * ((W + SMOOTH_R - 1) / SMOOTH_R)
                       / ((double)sms * 2048);
  return waves >= 1.5 ? 4 : waves >= 0.75 ? 2 : 1;
}

// m of the 4 offsets j0 .. j0+3 (weights w) on the window x = the extended
// row from the group's first bin + j0, in order: acc[r] += w[jj] * x[jj+r]
__device__ __forceinline__ void smooth_step(float (&acc)[SMOOTH_R],
                                            const float4 w, const float4 a,
                                            const float4 b, int m) {
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const float wj[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    if (jj < m) {
#pragma unroll
      for (int r = 0; r < SMOOTH_R; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(wj[jj], x[jj + r]));
    }
  }
}

__global__ void __launch_bounds__(SMOOTH_THREADS)
smooth_kernel(const float* __restrict__ ext, const float* __restrict__ ov,
              int F, int W, int n_off, int items, float* __restrict__ out) {
  const SmoothLayout L = smooth_layout(F, W, n_off, items);
  extern __shared__ __align__(16) float sm[];
  float* s_ov = sm;                           // [row][os]
  float* s_ext = sm + L.rows * L.os;          // [row][rs]
  const int EW = W + n_off, block = SMOOTH_THREADS * items;
  const int total = F * L.ng;                 // < 2^31 (the host checks)
  const int g0 = blockIdx.x * block;
  const int g_last = min(g0 + block, total) - 1;
  const int f_first = g0 / L.ng, f_last = g_last / L.ng;
  // stage only the columns the items read: the first row from its first
  // group's bin (a multiple of 4, so rows stay 16-byte aligned), the last
  // up to its last group's window
  const int c_first = SMOOTH_R * (g0 - f_first * L.ng);
  const int c_last = min(EW, SMOOTH_R * (g_last - f_last * L.ng) + n_off + 3);
  for (int r = 0; r <= f_last - f_first; ++r) {
    const int c0 = r == 0 ? c_first : 0;
    const int c1 = r == f_last - f_first ? c_last : EW;
    const float* row = ext + (size_t)(f_first + r) * EW;
    for (int c = c0 + threadIdx.x; c < c1; c += SMOOTH_THREADS)
      cp_async4(s_ext + r * L.rs + (c - c0), row + c);
    const float* wrow = ov + (size_t)(f_first + r) * n_off;
    for (int c = threadIdx.x; c < n_off; c += SMOOTH_THREADS)
      cp_async4(s_ov + r * L.os + c, wrow + c);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int g = g0 + threadIdx.x; g <= g_last; g += SMOOTH_THREADS) {
    const int f = g / L.ng, gi = g - f * L.ng;
    const float* x = s_ext + (f - f_first) * L.rs + SMOOTH_R * gi
                     - (f == f_first ? c_first : 0);
    const float* w = s_ov + (f - f_first) * L.os;
    float acc[SMOOTH_R] = {0.0f, 0.0f, 0.0f, 0.0f};
    float4 a = *reinterpret_cast<const float4*>(x);
    int j0 = 0;
    for (; j0 + 4 <= n_off; j0 += 4) {
      const float4 b = *reinterpret_cast<const float4*>(x + j0 + 4);
      smooth_step(acc, *reinterpret_cast<const float4*>(w + j0), a, b, 4);
      a = b;
    }
    if (j0 < n_off) {
      const float4 b = *reinterpret_cast<const float4*>(x + j0 + 4);
      smooth_step(acc, *reinterpret_cast<const float4*>(w + j0), a, b,
                  n_off - j0);
    }
    const int i0 = SMOOTH_R * gi;
    float* o = out + (size_t)f * W + i0;
    if (i0 + SMOOTH_R <= W && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                  acc[3]);
    } else {
#pragma unroll
      for (int r = 0; r < SMOOTH_R; ++r)
        if (i0 + r < W) o[r] = acc[r];
    }
  }
}

// ---------------------------------------------------------------------------
// probes timed by chip_smoke.py as measured floors: W2's and W3's
// frame-to-frame dependency with a minimal step (one warp), and W1's and
// W3's launch
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
chain_probe_kernel(const float* __restrict__ in, int which, int steps,
                   float* __restrict__ out) {
  const int lane = threadIdx.x;
  float c = in[lane];
  const float a = in[32 + lane], b = in[64 + lane];
  if (which == 0) {
    // W2: one shuffle-min and one add a frame
    for (int t = 0; t < steps; ++t)
      c = __fadd_rn(fminf(c, __shfl_xor_sync(FULL, c, 1)), a);
  } else {
    // W3: the carried compare and select a frame
    for (int t = 0; t < steps; ++t)
      c = c > 0.0f ? __fsub_rn(c, a) : __fadd_rn(c, b);
  }
  out[lane] = c;
}

// W1's and W3's floor: an empty launch with a kernel's grid, block and
// shared memory
__global__ void launch_floor_kernel() {}

}  // namespace

// ---------------------------------------------------------------------------
// plain C entry points: each launches on `stream` and returns the launch's
// cudaError_t (0 when it was accepted)
// ---------------------------------------------------------------------------

extern "C" int qp_world_pool(const float* f_sorted, const float* sp_sorted,
                             int n_ch, int F, int K, float thr, float* out,
                             void* stream) {
  if (K < 1 || K > MAX_POOL || n_ch < 1 || F < 1
      || pool_smem(n_ch, K) > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = pool_smem(n_ch, K);
  const bool wide = K > POOL_REGS;
  if (smem > 48 * 1024) {
    const void* fn = wide ? (const void*)pool_kernel<true>
                          : (const void*)pool_kernel<false>;
    const cudaError_t err = raise_smem_once(fn, wide ? 16 : 1, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (F + POOL_TILE - 1) / POOL_TILE;
  const cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    pool_kernel<true><<<blocks, POOL_THREADS, smem, s>>>(
        f_sorted, sp_sorted, n_ch, F, K, thr, out);
  else
    pool_kernel<false><<<blocks, POOL_THREADS, smem, s>>>(
        f_sorted, sp_sorted, n_ch, F, K, thr, out);
  return (int)cudaGetLastError();
}

// W2's back-pointer capacity in shared memory, bytes ((F - 1) * S beyond
// it spill to `back`, which must then hold them)
extern "C" int qp_world_viterbi_back_smem() { return VIT_BACK_SMEM; }

extern "C" int qp_world_viterbi(const float* emits, const float* logf,
                                const float* refined, int F, int K,
                                float tc, float uc, uint8_t* back,
                                float* f0, void* stream) {
  if (F < 1 || K < 0 || K + 1 > MAX_STATES) return (int)cudaErrorInvalidValue;
  const bool spill = (size_t)(F - 1) * (K + 1) > (size_t)VIT_BACK_SMEM;
  if (spill && back == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (K + 1 > VIT_NARROW)
    return launch_viterbi_wide(emits, logf, refined, F, K, tc, uc, back, f0,
                               spill, s);
  switch (vit_lanes(K + 1)) {
    case 32: return launch_viterbi<32>(emits, logf, refined, F, K, tc, uc,
                                       back, f0, spill, s);
    case 16: return launch_viterbi<16>(emits, logf, refined, F, K, tc, uc,
                                       back, f0, spill, s);
    case 8: return launch_viterbi<8>(emits, logf, refined, F, K, tc, uc,
                                     back, f0, spill, s);
    case 4: return launch_viterbi<4>(emits, logf, refined, F, K, tc, uc,
                                     back, f0, spill, s);
    default: return launch_viterbi<2>(emits, logf, refined, F, K, tc, uc,
                                      back, f0, spill, s);
  }
}

extern "C" int qp_world_fix_contour(const float* step2, const float* cands,
                                    int F, int C, float allowed, float* out,
                                    void* stream) {
  if (F < 1 || C < 1 || C > MAX_CANDS) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // the fewest slots that hold C: at DIO's C = 7 the 32-slot build alone
  // takes twice the 8-slot one's time (PERF.md section 6)
  if (C <= 8)
    return launch_fix_contour<8, false>(step2, cands, F, C, allowed, out, 12,
                                        s);
  if (C <= 16)
    return launch_fix_contour<16, false>(step2, cands, F, C, allowed, out, 13,
                                         s);
  if (C <= FIX_NARROW)
    return launch_fix_contour<32, false>(step2, cands, F, C, allowed, out, 14,
                                         s);
  return launch_fix_contour<FIX_LANE_SLOTS, true>(step2, cands, F, C, allowed,
                                                  out, 19, s);
}

// 1 when W3 stages a pass of F frames of C candidates in shared memory,
// 0 when it walks device memory
extern "C" int qp_world_fix_staged(int F, int C) { return fix_staged(F, C); }

extern "C" int qp_world_smooth(const float* ext, const float* ov, int F,
                               int W, int n_off, float* out, void* stream) {
  if (F < 1 || W < 1 || n_off < 1
      || (long long)F * ((W + SMOOTH_R - 1) / SMOOTH_R) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int items = smooth_items(F, W, sms);
  const SmoothLayout L = smooth_layout(F, W, n_off, items);
  if (L.bytes > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (L.bytes > 48 * 1024) {
    err = raise_smem_once((const void*)smooth_kernel, 0, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  const int block = SMOOTH_THREADS * items;
  const int blocks = (F * L.ng + block - 1) / block;
  smooth_kernel<<<blocks, SMOOTH_THREADS, L.bytes, (cudaStream_t)stream>>>(
      ext, ov, F, W, n_off, items, out);
  return (int)cudaGetLastError();
}

extern "C" int qp_world_chain_probe(const float* in, int which, int steps,
                                    float* out, void* stream) {
  if (which < 0 || which > 1 || steps < 0) return (int)cudaErrorInvalidValue;
  chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(in, which, steps,
                                                         out);
  return (int)cudaGetLastError();
}

// an empty launch with W1's (which 0: a = n_ch, b = F) or W3's (which 1:
// a = F, b = C) grid, block and shared memory
extern "C" int qp_world_launch_floor(int which, int a, int b, void* stream) {
  if (which < 0 || which > 1 || a < 1 || b < 1
      || (which == 0 && pool_smem(a, 1) > (size_t)SMEM_MAX))
    return (int)cudaErrorInvalidValue;
  const size_t smem = which == 0 ? pool_smem(a, 1)
                      : fix_staged(a, b) ? (size_t)a * (b + 2) * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = raise_smem_once((const void*)launch_floor_kernel,
                                            15, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = which == 0 ? (b + POOL_TILE - 1) / POOL_TILE : 1;
  launch_floor_kernel<<<blocks, which == 0 ? POOL_THREADS : FIX_THREADS, smem,
                        (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
