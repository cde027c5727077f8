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
// winning, as PyTorch's reductions do (LessOrNan).  Python scalars enter
// as float32, as PyTorch casts them for float32 tensors.
//
// Bounds on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
//   W1, W4: bytes.  Each reads its inputs once and writes its output once
//     (W1: 2 * n_ch * F + F * K floats, about 1.4 MB at 10 s; W4: F * (W +
//     4 kmax) + F * W floats, 17-21 MB at 10 s), with a few operations a
//     byte.  W1 runs a thread per frame, the K kept slots and the count in
//     registers; neighbouring threads read neighbouring frames of one rank,
//     so every load is coalesced.  W4 runs a thread per (frame, bin); a
//     block stages its frame's weights and its bins' extended row in
//     shared memory and each thread sums its 2*kmax products in order.
//   W2, W3: the chain of F dependent steps (F = 601 at 3 s, 2001 at 10 s).
//     Their bytes (a few floats a frame) and operations are a microsecond's
//     work; each step waits for the one before, a few shared-memory and
//     shuffle latencies long.  One warp per utterance: W2's lanes own the
//     S = K + 1 states, read the previous costs from shared memory and take
//     each min over p in order; the rows of the next 32 frames are loaded
//     into registers while the current 32 run, so no step waits for device
//     memory.  Back-pointers (F - 1, S) uint8 go to device memory and come
//     back 32 frames at a time for the back-track, which lane 0 walks in
//     shared memory.  W3's lanes hold the C band candidates of a frame; the
//     arg-min is a shuffle reduction, and the carried (prev2, prev1, alive,
//     was_gap) is the same in every lane, so the warp never diverges.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_POOL = 16;     // ops/world_kernel.py MAX_POOL
constexpr int MAX_STATES = 16;   // MAX_STATES
constexpr int MAX_CANDS = 32;    // MAX_CANDS
constexpr int CHUNK = 32;        // W2: frames staged at a time
constexpr int POOL_THREADS = 128;
constexpr int POOL_GROUP = 8;    // W1: ranks loaded at a time
constexpr int SMOOTH_THREADS = 256;

// torch.clamp_min(x, lo): NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// True when value v at a later index replaces the running best b of a
// first-index min/argmin (PyTorch's LessOrNan: NaN wins, ties keep the
// earlier index).
__device__ __forceinline__ bool replaces(float v, float b) {
  return isnan(v) ? !isnan(b) : v < b;
}

// ---------------------------------------------------------------------------
// W1: candidate pooling, a thread per frame
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(POOL_THREADS)
pool_kernel(const float* __restrict__ f_sorted,
            const float* __restrict__ sp_sorted, int n_ch, int F, int K,
            float thr, float* __restrict__ out) {
  const int t = blockIdx.x * POOL_THREADS + threadIdx.x;
  if (t >= F) return;
  float p[MAX_POOL];
#pragma unroll
  for (int k = 0; k < MAX_POOL; ++k) p[k] = 0.0f;
  int n = 0;
  // ranks in groups of POOL_GROUP, the next group's loads in flight while
  // this one runs (a rank's work is far shorter than a load's latency)
  float f_cur[POOL_GROUP], sp_cur[POOL_GROUP];
  auto fetch = [&](int r0, float (&f)[POOL_GROUP], float (&sp)[POOL_GROUP]) {
#pragma unroll
    for (int u = 0; u < POOL_GROUP; ++u) {
      const bool in = r0 + u < n_ch;
      f[u] = in ? f_sorted[(size_t)(r0 + u) * F + t] : 0.0f;
      sp[u] = in ? sp_sorted[(size_t)(r0 + u) * F + t] : 0.0f;
    }
  };
  fetch(0, f_cur, sp_cur);
  for (int r0 = 0; r0 < n_ch; r0 += POOL_GROUP) {
    float f_next[POOL_GROUP], sp_next[POOL_GROUP];
    fetch(r0 + POOL_GROUP, f_next, sp_next);
#pragma unroll
    for (int u = 0; u < POOL_GROUP; ++u) {
      if (r0 + u >= n_ch) break;
      const float f = f_cur[u], sp = sp_cur[u];
      const bool ok = (sp <= thr) && (f > 0.0f);
      bool dup = false;
#pragma unroll
      for (int k = 0; k < MAX_POOL; ++k) {
        if (k < K) {
          const float lim = __fmul_rn(0.05f, clamp_min_nan(p[k], 1e-9f));
          dup = dup || (fabsf(__fsub_rn(f, p[k])) < lim);
        }
      }
      if (ok && !dup && n < K) {
#pragma unroll
        for (int k = 0; k < MAX_POOL; ++k)
          if (k == n) p[k] = __fadd_rn(p[k], f);   // the empty slot: 0 + f
        ++n;
      }
    }
#pragma unroll
    for (int u = 0; u < POOL_GROUP; ++u) {
      f_cur[u] = f_next[u];
      sp_cur[u] = sp_next[u];
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_POOL; ++k)
    if (k < K) out[(size_t)t * K + k] = p[k];
}

// ---------------------------------------------------------------------------
// W2: the Viterbi, one warp
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
viterbi_kernel(const float* __restrict__ emits,
               const float* __restrict__ logf,
               const float* __restrict__ refined, int F, int K, float tc,
               float uc, uint8_t* back, float* __restrict__ f0) {
  const int S = K + 1;
  const int lane = threadIdx.x;
  // rows of two chunks of frames, slot t % (2 * CHUNK)
  __shared__ float s_emit[2 * CHUNK][MAX_STATES];
  __shared__ float s_logf[2 * CHUNK][MAX_STATES];
  __shared__ float s_cost[2][MAX_STATES];
  __shared__ uint8_t s_back[CHUNK][MAX_STATES];
  __shared__ float s_ref[CHUNK][MAX_STATES];
  __shared__ int s_state[CHUNK];

  float pe[MAX_STATES], pg[MAX_STATES];   // lane's prefetched frame
  auto fetch = [&](int t) {
#pragma unroll
    for (int k = 0; k < MAX_STATES; ++k) {
      pe[k] = (t < F && k < S) ? emits[(size_t)t * S + k] : 0.0f;
      pg[k] = (t < F && k < K) ? logf[(size_t)t * K + k] : 0.0f;
    }
  };
  auto stage = [&](int t) {
    const int slot = t & (2 * CHUNK - 1);
#pragma unroll
    for (int k = 0; k < MAX_STATES; ++k) {
      s_emit[slot][k] = pe[k];
      s_logf[slot][k] = pg[k];
    }
  };

  fetch(lane);
  stage(lane);
  __syncwarp();
  float cost = lane < S ? s_emit[0][lane] : 0.0f;
  const int n_chunks = (F + CHUNK - 1) / CHUNK;
  for (int c = 0; c < n_chunks; ++c) {
    const int tn = (c + 1) * CHUNK + lane;
    fetch(tn);                            // the next chunk, in flight
    const int t_end = min(F, (c + 1) * CHUNK);
    for (int t = max(1, c * CHUNK); t < t_end; ++t) {
      const int b = t & 1;
      if (lane < MAX_STATES) s_cost[b][lane] = cost;
      __syncwarp();
      const float* gp = s_logf[(t - 1) & (2 * CHUNK - 1)];
      const float* gt = s_logf[t & (2 * CHUNK - 1)];
      // tot[s, p] = cost[p] + trans[s, p]; trans[0, 0] = 0, trans[0, p] =
      // trans[s, 0] = uc, trans[s, p] = tc * |logf_t[s-1] - logf_{t-1}[p-1]|
      // (lane 0 selects its transitions, so the warp runs one path)
      const float lt = gt[(lane - 1) & (MAX_STATES - 1)];
      float best = __fadd_rn(s_cost[b][0], lane == 0 ? 0.0f : uc);
      int bp = 0;
#pragma unroll
      for (int p = 1; p < MAX_STATES; ++p) {
        if (p < S) {
          const float tr = lane == 0
              ? uc : __fmul_rn(tc, fabsf(__fsub_rn(lt, gp[p - 1])));
          const float v = __fadd_rn(s_cost[b][p], tr);
          if (replaces(v, best)) { best = v; bp = p; }
        }
      }
      if (lane < S) {
        cost = __fadd_rn(best, s_emit[t & (2 * CHUNK - 1)][lane]);
        back[(size_t)(t - 1) * S + lane] = (uint8_t)bp;
      }
    }
    stage(tn);            // chunk c - 1's slots: no step reads them again
    __syncwarp();
  }

  // the last frame's state: first-index argmin of the costs
  if (lane < MAX_STATES) s_cost[0][lane] = cost;
  __syncwarp();
  int s = 0;
  if (lane == 0) {
    float best = s_cost[0][0];
    for (int p = 1; p < S; ++p)
      if (replaces(s_cost[0][p], best)) { best = s_cost[0][p]; s = p; }
  }
  // back-track 32 frames at a time: lanes stage frame hi - lane's
  // back-pointer row (into frame t - 1) and refined row, lane 0 walks
  for (int hi = F - 1; hi >= 0; hi -= CHUNK) {
    const int t = hi - lane;
    if (t >= 0) {
#pragma unroll
      for (int k = 0; k < MAX_STATES; ++k) {
        if (k < S) s_back[lane][k] = t >= 1 ? back[(size_t)(t - 1) * S + k] : 0;
        if (k < K) s_ref[lane][k] = refined[(size_t)t * K + k];
      }
    }
    __syncwarp();
    if (lane == 0) {
      const int n = min(CHUNK, hi + 1);
      for (int l = 0; l < n; ++l) {
        s_state[l] = s;
        if (hi - l >= 1) s = s_back[l][s];
      }
    }
    __syncwarp();
    if (t >= 0) {
      const int st = s_state[lane];
      f0[t] = st > 0 ? s_ref[lane][st - 1] : 0.0f;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// W3: DIO's contour extension loops, one warp
// ---------------------------------------------------------------------------

// dio._select_best_f0: the candidate nearest (3 prev1 - prev2) / 2, or 0
// when even it is off by allowed or more (relative)
__device__ __forceinline__ float select_best(float prev1, float prev2,
                                             float cv, int lane, int C,
                                             float allowed) {
  const float ref =
      __fdiv_rn(__fsub_rn(__fmul_rn(prev1, 3.0f), prev2), 2.0f);
  float e = lane < C ? fabsf(__fsub_rn(ref, cv)) : __int_as_float(0x7f800000);
  int i = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float eo = __shfl_xor_sync(FULL, e, off);
    const int io = __shfl_xor_sync(FULL, i, off);
    // LessOrNan on (value, index): the pair that PyTorch's argmin keeps
    const bool take = isnan(eo) ? (!isnan(e) || io < i)
                                : (!isnan(e) && (eo == e ? io < i : eo < e));
    if (take) { e = eo; i = io; }
  }
  const float cb = __shfl_sync(FULL, cv, i);
  const bool fail = __fdiv_rn(e, clamp_min_nan(ref, 1e-12f)) >= allowed;
  return fail ? 0.0f : cb;
}

__global__ void __launch_bounds__(32)
fix_contour_kernel(const float* __restrict__ step2,
                   const float* __restrict__ cands, int F, int C,
                   float allowed, float* out) {
  // a frame is inside a voiced section where step 2 kept it: step2 > 0
  const int lane = threadIdx.x;
  // forward: step 3, written to out
  float prev2 = 0.0f, prev1 = 0.0f;
  bool alive = false, was_gap = false;
  float cv_n = lane < C ? cands[lane] : 0.0f;
  float s2_n = step2[0];
  bool in_n = step2[0] > 0.0f;
  for (int t = 0; t < F; ++t) {
    const float cv = cv_n, s2 = s2_n;
    const bool in = in_n;
    if (t + 1 < F) {
      cv_n = lane < C ? cands[(size_t)(t + 1) * C + lane] : 0.0f;
      s2_n = step2[t + 1];
      in_n = s2_n > 0.0f;
    }
    const bool overwrite = in && was_gap && alive;
    const bool can = !in && alive && (prev1 > 0.0f);
    // the carry is the same in every lane, so this branch is uniform
    const float v_ext = (overwrite || can)
        ? select_best(prev1, prev2, cv, lane, C, allowed) : 0.0f;
    const float v = in ? (overwrite ? v_ext : s2) : (can ? v_ext : 0.0f);
    alive = in || (can && v_ext > 0.0f);
    prev2 = prev1;
    prev1 = v;
    was_gap = !in;
    if (lane == 0) out[t] = v;
  }
  __syncwarp();
  // backward: step 4 over frames F-1 .. 1 (frame 0 is never written)
  prev2 = 0.0f;
  prev1 = 0.0f;
  alive = false;
  if (F < 2) return;
  cv_n = lane < C ? cands[(size_t)(F - 1) * C + lane] : 0.0f;
  float s3_n = out[F - 1];
  in_n = step2[F - 1] > 0.0f;
  for (int t = F - 1; t >= 1; --t) {
    const float cv = cv_n, s3 = s3_n;
    const bool in = in_n;
    if (t - 1 >= 1) {
      cv_n = lane < C ? cands[(size_t)(t - 1) * C + lane] : 0.0f;
      s3_n = out[t - 1];
      in_n = step2[t - 1] > 0.0f;
    }
    const bool can = !in && alive && (prev1 > 0.0f);
    const float v_ext =
        can ? select_best(prev1, prev2, cv, lane, C, allowed) : 0.0f;
    const float v = can ? v_ext : s3;
    alive = in || (can && v_ext > 0.0f);
    prev2 = prev1;
    prev1 = v;
    __syncwarp();                 // every lane has read out[t]
    if (lane == 0) out[t] = v;
  }
}

// ---------------------------------------------------------------------------
// W4: fractional-box smoothing, a thread per (frame, bin)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SMOOTH_THREADS)
smooth_kernel(const float* __restrict__ ext, const float* __restrict__ ov,
              int W, int n_off, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* s_ov = sm;                     // n_off weights of this frame
  float* s_ext = sm + n_off;            // SMOOTH_THREADS + n_off values
  const size_t f = blockIdx.x;
  const int i0 = blockIdx.y * SMOOTH_THREADS;
  const int EW = W + n_off;
  for (int j = threadIdx.x; j < n_off; j += SMOOTH_THREADS)
    s_ov[j] = ov[f * n_off + j];
  for (int j = threadIdx.x; j < SMOOTH_THREADS + n_off; j += SMOOTH_THREADS)
    s_ext[j] = i0 + j < EW ? ext[f * EW + i0 + j] : 0.0f;
  __syncthreads();
  const int i = i0 + threadIdx.x;
  if (i >= W) return;
  float acc = 0.0f;
  for (int j = 0; j < n_off; ++j)
    acc = __fadd_rn(acc, __fmul_rn(s_ov[j], s_ext[threadIdx.x + j]));
  out[f * W + i] = acc;
}

}  // namespace

// ---------------------------------------------------------------------------
// plain C entry points: each launches on `stream` and returns the launch's
// cudaError_t (0 when it was accepted)
// ---------------------------------------------------------------------------

extern "C" int qp_world_pool(const float* f_sorted, const float* sp_sorted,
                             int n_ch, int F, int K, float thr, float* out,
                             void* stream) {
  if (K < 1 || K > MAX_POOL) return (int)cudaErrorInvalidValue;
  pool_kernel<<<(F + POOL_THREADS - 1) / POOL_THREADS, POOL_THREADS, 0,
                (cudaStream_t)stream>>>(f_sorted, sp_sorted, n_ch, F, K,
                                        thr, out);
  return (int)cudaGetLastError();
}

extern "C" int qp_world_viterbi(const float* emits, const float* logf,
                                const float* refined, int F, int K,
                                float tc, float uc, uint8_t* back,
                                float* f0, void* stream) {
  if (F < 1 || K < 0 || K + 1 > MAX_STATES) return (int)cudaErrorInvalidValue;
  viterbi_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(emits, logf, refined,
                                                     F, K, tc, uc, back, f0);
  return (int)cudaGetLastError();
}

extern "C" int qp_world_fix_contour(const float* step2, const float* cands,
                                    int F, int C, float allowed, float* out,
                                    void* stream) {
  if (F < 1 || C < 1 || C > MAX_CANDS) return (int)cudaErrorInvalidValue;
  fix_contour_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(step2, cands, F, C,
                                                         allowed, out);
  return (int)cudaGetLastError();
}

extern "C" int qp_world_smooth(const float* ext, const float* ov, int F,
                               int W, int n_off, float* out, void* stream) {
  const size_t smem = (size_t)(SMOOTH_THREADS + 2 * n_off) * sizeof(float);
  if (F < 1 || W < 1 || n_off < 1 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(F, (W + SMOOTH_THREADS - 1) / SMOOTH_THREADS);
  smooth_kernel<<<grid, SMOOTH_THREADS, smem, (cudaStream_t)stream>>>(
      ext, ov, W, n_off, out);
  return (int)cudaGetLastError();
}
