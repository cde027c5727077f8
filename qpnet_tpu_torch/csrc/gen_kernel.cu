// Autoregressive QPNet generation on Hopper (sm_90a), bf16 or w8a8 weights.
//
// Replaces: qpnet_tpu/ops/gen_kernel.py::pallas_generate (kernel body
// _make_kernel), the TPU kernel that runs the whole sample loop in one
// pallas_call with every weight resident in VMEM; with quantize = 1 its
// w8a8 branch (`mmq`, the q8 packing of pack_weights).
//
// What bounds it on the H100: every emitted sample runs the full network,
// so each step reads the whole weight set (48.5 MB bf16 for the default
// net, 98.3 MB bf16 or 49.3 MB int8 for Rd10Rr3Ed4Er1).  That set does not
// fit in shared memory, so each step streams it from L2/HBM: 14.5 us per
// step at 3.35 TB/s for the default net.  A step does 2 * B FLOP per
// weight read, at most 64 FLOP per byte at B = 64, far below the ~295 at
// which the tensor cores would bind: the step is bound by bytes, and by
// how many of the weight bytes are in flight at once.
//
// Design.  A step is 2L + 4 kernels, all launched with programmatic
// dependent launch (PDL) and captured once per (network, B, maxd, mode,
// quantize) as a CUDA graph of one frame (`up` steps), replayed per frame:
//   embed_kernel     exact bf16 gather of [E_cur | E_prev], the carried
//                    E_prev half (loaded from x at a chunk's first step),
//                    skip-sum init, and at frame starts the L aux
//                    projections h_frame @ W_aux[l] (f32, in order);
//   prod_kernel<kGate>  per layer: [o; past] @ W_in[l], gate epilogue;
//   prod_kernel<kOut>   per layer: g @ W_out[l], skip, residual, ring;
//   prod_kernel<kPost1> relu(skip) @ W_post1, relu, bf16;
//   prod_kernel<kPost2> u1 @ W_post2 -> logits (both post-net products
//                    sum in f64 on the tensor cores, mma.sync m8n8k4, and
//                    round once to f32, which the twin repeats);
//   sample_kernel    a block per row: argmax, hash Gumbel-max or forced
//                    output, x update;
// and after the frame's last step, advance_kernel (frame += 1).
// Every product is one kernel over many blocks.  A block owns 16 output
// columns (for the gate: columns j0..j0+7 in mma rows 0-7 and their
// partners R+j0.. in rows 8-15, so z0 and z1 of one (j, b) meet) and a
// slice of the depth.  It requests its weight slice into shared memory
// with cp.async before it waits for the previous kernel (the weights do
// not depend on it), then copies its activation rows (tiles of at most 64;
// for the gate the ring gather happens here) with cp.async, and runs
// mma.sync m16n8k16 bf16 (f32 sums) or m16n8k32 s8 (int32 sums) with the
// weights as operand A and the batch rows as operand B.  The depth is split
// over the block's 8 warps and over the blocks of a thread-block cluster
// (2 for the gate, 4 for out and the post-net), so 64-192 blocks fill
// the SMs.  Partial sums are added over the warps in shared memory, each
// rank's sum is stored into rank 0's shared memory (distributed shared
// memory), and after one cluster barrier rank 0 adds them in rank order
// and runs the epilogue from operands it fetched with its rows (the aux
// projections, skip or o).  The order is fixed, so runs are deterministic
// and chunked runs equal one-shot runs.
//
// w8a8: every block of a cluster quantizes its own depth slice of each
// row into shared memory once per row tile; the row's amax is the max of
// the slices' maxima, exchanged through distributed shared memory (a max
// is exact in any order).  The arithmetic is the TPU kernel's: amax =
// max(max_k |a|, 1e-6), aq = clip(rint(a * (127 / amax)), -127, 127) with
// 127 / amax one IEEE division and rint half to even, int32 sums (|aq|,
// |wq| <= 127 and K <= 1024 keep them below 2^24, so float(sum) is exact),
// and z = float(sum) * (amax * (1/127)) * scale.  The int32 partials add
// exactly, so this branch equals its plain twin bit for bit.
//
// bf16: the tensor cores' f32 accumulation of the W_in and W_out products
// is not IEEE-ordered, so the twin cannot repeat it; the checks hold the
// kernel to the twin summed in float64 at the same bf16 storage points (o
// after the embedding and after each residual, g, u and u1 before the
// post-net products).
//
// Step scalars live on the device: a context (pointers, step offset,
// batch offset, seed and the frame within the chunk) is written by one
// small kernel per chunk and advanced by the last kernel of each frame;
// each kernel takes its step within the frame as an argument and derives
// t_abs, the ring slots and the per-step row pointers.  The context does
// not change while a frame runs, so a kernel reads it, computes its
// addresses and requests its weights before griddepcontrol.wait, and
// touches nothing an earlier kernel wrote until after it; it then releases
// its dependents, whose prologues overlap its products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (no fast-math: logf, expf and tanhf are
//        exact library calls, 127 / amax an IEEE division, and the
//        epilogues and the w8a8 rescale round each multiply and add as the
//        twin does).  C entry point qp_generate returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <vector>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;          // warps per product block
constexpr int kThreads = kWarps * kWarp;
constexpr int kM = 16;             // output columns per block (mma rows)
constexpr int kMaxBT = 64;         // batch rows per tile
constexpr int kChunk = 32;         // depth per warp work item
constexpr int kPadBytes = 16;      // row padding in shared memory
constexpr int kSampleThreads = 256;
constexpr int kEmbedThreads = 256;
constexpr int kMaxKQ = 1024;       // deepest quantized product (2R): exact sums
constexpr int kMaxSmem = 232448;
// 1/127 rounded once to f32, as JAX rounds its weak-typed 1.0 / 127.0
constexpr float kInv127 = (float)(1.0 / 127.0);

enum Mode { kArgmax = 0, kSampling = 1, kForced = 2 };
enum Quantize { kNone = 0, kW8A8 = 1 };
enum Prod { kGate = 0, kOut = 1, kPost1 = 2, kPost2 = 3 };

// What a call passes to its kernels.  Written by set_ctx_kernel at a
// chunk's start; within a chunk only advance_kernel, the last kernel of a
// frame, changes it (frame += 1).  So every field is constant while one
// frame's graph runs, and kernels read it before their grid-dependency
// wait.
struct Ctx {
  const void* W_in;      // (L, 2R, 2R) bf16 or int8, output-major
  const void* W_out;     // (L, S+R, R)
  const float* s_in;     // (L, 2R) w8a8 column scales
  const float* s_out;    // (L, S+R)
  const bf16* W_aux;     // (L, KA, 2R)
  const float* c_all;    // (L, 2R)
  const float* b_res;    // (L, R)
  const float* b_skip_sum;
  const float* up_w;
  const bf16* E_cat;     // (Q, 2R)
  const float* b_causal;
  const bf16* W1;        // (S, S) output-major
  const bf16* W2;        // (Q, S)
  const float* b1;
  const float* b2;
  bf16* bufF;
  bf16* bufA;
  int* x;                // (2, B)
  const bf16* h_frames;  // (F, B, KA)
  const float* d_frames; // (F, 1, B)
  const int* x_forced;   // (n_steps, 1, B)
  void* out;             // (n_steps, 1, B) i32 or (n_steps, B, Q) f32
  bf16* o;               // (2, B, R)
  bf16* g;               // (B, R)
  bf16* u1;              // (B, S)
  float* e_prev;         // (B, R)
  float* skip;           // (B, S)
  float* aux;            // (L, B, 2R)
  float* logits;         // (B, Q)
  int step_offset, b_offset, seed;
  int frame;             // frame within the chunk
};

__global__ void set_ctx_kernel(Ctx* ctx, Ctx v) { *ctx = v; }

__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void grid_release() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// The frame's last kernel: the next replay runs the next frame.
__global__ void advance_kernel(Ctx* ctx) {
  grid_wait();
  ctx->frame += 1;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d (16 x 8, s32) += a (16 x 32, s8, row) * b (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d (8 x 8, f64) += a (8 x 4, row) * b (4 x 8, col)
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ double bf16_at(const unsigned char* row, int k) {
  return (double)__bfloat162float(reinterpret_cast<const bf16*>(row)[k]);
}

// Shared-memory layout of a product block, in bytes.  Kb: the block's
// depth slice of C; BT: rows per tile; accb: bytes per partial sum.  Rows are
// padded by 16 bytes, which puts the 8 rows an mma fragment reads in 8
// different bank groups.
struct Layout {
  int wpitch, apitch, qpitch;  // bytes per row: weights, bf16 rows, int8 rows
  int w, a, q, part, gath, epi, pmax, inv, scale, cst, rows, total;
};

constexpr int kEpiBytes = 64;  // per row: the epilogue's operands

__host__ __device__ inline Layout layout(bool q8, int Kb, int BT, int accb,
                                         int C) {
  Layout s;
  s.wpitch = (q8 ? Kb : 2 * Kb) + kPadBytes;
  s.apitch = 2 * Kb + kPadBytes;
  s.qpitch = q8 ? Kb + kPadBytes : 0;
  s.w = 0;
  s.a = s.w + kM * s.wpitch;
  s.q = s.a + BT * s.apitch;
  s.part = s.q + BT * s.qpitch;
  s.gath = s.part + kWarps * kM * BT * accb;
  s.epi = s.gath + C * kM * BT * accb;
  s.pmax = s.epi + BT * kEpiBytes;
  s.inv = s.pmax + BT * 4;
  s.scale = s.inv + BT * 4;
  s.cst = s.scale + BT * 4;
  s.rows = s.cst + 2 * kM * 4;
  s.total = s.rows + BT * 2 * (int)sizeof(void*);
  return s;
}

// The sampling hash of the TPU kernel: a murmur-style finalizer over
// (seed, absolute step, global batch row, class) in uint32 arithmetic,
// then Gumbel noise from its top 24 bits.
__device__ __forceinline__ float gumbel_noise(int seed, int t_abs, int row,
                                              int q, int Q) {
  const uint32_t base = ((uint32_t)seed * 0x85EBCA6Bu)
                        ^ ((uint32_t)t_abs * 2654435761u);
  const uint32_t idx = (uint32_t)row * (uint32_t)Q + (uint32_t)q;
  uint32_t v = base + idx * 0x9E3779B9u;
  v ^= v >> 16; v *= 0x7FEB352Du;
  v ^= v >> 15; v *= 0x846CA68Bu;
  v ^= v >> 16;
  const float unif = (float)(int32_t)(v >> 8) * (1.0f / 16777216.0f) + 1e-12f;
  return -logf(-logf(unif));
}

// Row b of a gate's input [o; past]: xa = o's row, xb = the ring row it
// reads.  Fixed layers read slot t_abs % size (overwritten later by the
// out kernel).  Adaptive layers read slot (t_abs - r_b) mod size with
// r_b = clip(rint(d_b * dil), 0, size - 1); r_b = 0 is the slot this step
// writes, so the row reads o itself.
__device__ __forceinline__ void gate_row(const bf16* o, const bf16* ring,
                                         int size, int adaptive, int dil,
                                         const float* d_frame, int t_abs,
                                         int B, int R, int b, const bf16*& xa,
                                         const bf16*& xb) {
  const size_t BR = (size_t)B * R;
  xa = o + (size_t)b * R;
  if (adaptive) {
    int r = __float2int_rn(d_frame[b] * (float)dil);  // half to even
    r = min(max(r, 0), size - 1);
    xb = r == 0 ? xa : ring + ((t_abs - r + 2 * size) % size) * BR + (size_t)b * R;
  } else {
    xb = ring + (t_abs % size) * BR + (size_t)b * R;
  }
}

// Step prologue: causal embedding, skip init, aux refresh at frame starts.
__global__ void __launch_bounds__(kEmbedThreads)
embed_kernel(const Ctx* ctx, int step, int B, int R, int S, int L, int KA,
             int up) {
  const Ctx& cx = *ctx;
  const int t = cx.frame * up + step;
  grid_wait();
  grid_release();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  const int R2 = 2 * R;
  const int* x = cx.x;
  const bf16* E = cx.E_cat;
  float* e_prev = cx.e_prev;
  for (int i = tid; i < B * R; i += nth) {
    const int b = i / R, r = i % R;
    const int xc = x[B + b];
    // chunk start: E_prev[x_prev]; later carried from the previous step
    if (t == 0) e_prev[i] = __bfloat162float(E[(size_t)x[b] * R2 + R + r]);
    const float v = __bfloat162float(E[(size_t)xc * R2 + r]) + e_prev[i]
                    + cx.b_causal[r];
    cx.o[i] = __float2bfloat16_rn(v);
    e_prev[i] = __bfloat162float(E[(size_t)xc * R2 + R + r]);
  }
  for (int i = tid; i < B * S; i += nth) cx.skip[i] = cx.b_skip_sum[i % S];
  if (step == 0) {
    const bf16* h = cx.h_frames + (size_t)cx.frame * B * KA;
    for (int i = tid; i < L * R2; i += nth) {
      const int l = i / R2, n = i % R2;
      const bf16* w = cx.W_aux + (size_t)l * KA * R2 + n;
      for (int b = 0; b < B; ++b) {
        float acc = 0.f;
        for (int k = 0; k < KA; ++k)
          acc += __bfloat162float(h[b * KA + k])
                 * __bfloat162float(w[(size_t)k * R2]);
        cx.aux[((size_t)l * B + b) * R2 + n] = acc;
      }
    }
  }
}

// Partial sums: f32 (bf16 products), int32 (w8a8), f64 (post-net).
template <int P, bool Q8> struct AccT { typedef float T; };
template <int P> struct AccT<P, true> { typedef int T; };
template <> struct AccT<kPost1, false> { typedef double T; };
template <> struct AccT<kPost2, false> { typedef double T; };

// One product of a step over all B rows: a block owns 16 output columns
// (column tile blockIdx.x / C) and depth slice `rank` of C, C the cluster
// size.  K: the product's depth; BT: rows per tile (a multiple of 8, at
// most 64); step: the step within the frame.  Gate and out take layer l
// and its ring (ring_off slots into bufF or bufA, `size` slots, dilation
// dil).  The post-net products sum in f64 on the tensor cores and round
// once to f32, which the plain twin repeats exactly.
template <int P, bool Q8>
__global__ void __launch_bounds__(kThreads)
prod_kernel(const Ctx* ctx, int step, int l, int ring_off, int size,
            int adaptive, int dil, int B, int R, int S, int Q, int up, int K,
            int BT) {
  typedef typename AccT<P, Q8>::T Acc;
  constexpr bool kF64 = P == kPost1 || P == kPost2;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int tile = blockIdx.x / C;
  const int Kb = K / C, k0 = rank * Kb;
  const Layout Ls = layout(Q8, Kb, BT, (int)sizeof(Acc), C);
  unsigned char* sw = smem + Ls.w;
  unsigned char* sa = smem + Ls.a;
  unsigned char* sq = smem + Ls.q;
  Acc* part = reinterpret_cast<Acc*>(smem + Ls.part);
  Acc* gath = reinterpret_cast<Acc*>(smem + Ls.gath);
  unsigned char* epi = smem + Ls.epi;
  float* pmax = reinterpret_cast<float*>(smem + Ls.pmax);
  float* ainv = reinterpret_cast<float*>(smem + Ls.inv);
  float* scl = reinterpret_cast<float*>(smem + Ls.scale);
  float* cst = reinterpret_cast<float*>(smem + Ls.cst);
  const bf16** rp = reinterpret_cast<const bf16**>(smem + Ls.rows);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int R2 = 2 * R;
  const int esz = Q8 ? 1 : 2;

  // Before the wait: only what no kernel of this frame writes (the
  // weights, the column constants, the context, the d inputs).
  const Ctx& cx = *ctx;
  const int t = cx.frame * up + step;
  const int t_abs = t + cx.step_offset;
  const unsigned char* wbase;
  if (P == kGate) {
    wbase = static_cast<const unsigned char*>(cx.W_in) + (size_t)l * R2 * R2 * esz;
  } else if (P == kOut) {
    wbase = static_cast<const unsigned char*>(cx.W_out) + (size_t)l * (S + R) * R * esz;
  } else {
    wbase = reinterpret_cast<const unsigned char*>(P == kPost1 ? cx.W1 : cx.W2);
  }
  const int wch = Kb * esz / 16;
  for (int i = tid; i < kM * wch; i += kThreads) {
    const int m = i / wch, c = i % wch;
    const int col = P == kGate ? (m < 8 ? tile * 8 + m : R + tile * 8 + m - 8)
                               : tile * kM + m;
    cp_async16(sw + m * Ls.wpitch + c * 16,
               wbase + ((size_t)col * K + k0) * esz + c * 16);
  }
  cp_async_commit();
  if (tid < kM) {  // cst[m]: bias of column m; cst[kM + m]: its w8a8 scale
    const int m = tid;
    if (P == kGate) {
      const int col = m < 8 ? tile * 8 + m : R + tile * 8 + m - 8;
      cst[m] = cx.c_all[(size_t)l * R2 + col];
      cst[kM + m] = Q8 ? cx.s_in[(size_t)l * R2 + col] : 0.f;
    } else if (P == kOut) {
      const int n = tile * kM + m;
      cst[m] = n >= S ? cx.b_res[(size_t)l * R + n - S] : 0.f;
      cst[kM + m] = Q8 ? cx.s_out[(size_t)l * (S + R) + n] : 0.f;
    } else {
      cst[m] = (P == kPost1 ? cx.b1 : cx.b2)[tile * kM + m];
    }
  }
  const float w_t = P == kGate ? cx.up_w[t_abs % up] : 0.f;
  const size_t BR = (size_t)B * R;
  const bf16* o_in = cx.o + (size_t)(l & 1) * BR;
  bf16* ring = (adaptive ? cx.bufA : cx.bufF) + (size_t)ring_off * BR;
  const float* d_frame = cx.d_frames + (size_t)cx.frame * B;
  auto set_rows = [&](int b0, int rows, int rows8) {  // rows past `rows`
    if (tid < rows8) {                                // repeat the last one
      const int b = b0 + min(tid, rows - 1);
      const bf16* xa = nullptr;
      const bf16* xb = nullptr;
      if (P == kGate)
        gate_row(o_in, ring, size, adaptive, dil, d_frame, t_abs, B, R, b, xa, xb);
      else if (P == kOut)
        xa = cx.g + (size_t)b * R;
      else if (P == kPost2)
        xa = cx.u1 + (size_t)b * S;
      rp[2 * tid] = xa;
      rp[2 * tid + 1] = xb;
    }
  };
  set_rows(0, min(BT, B), (min(BT, B) + 7) / 8 * 8);

  grid_wait();
  grid_release();
  if (P == kGate && adaptive) {  // o -> this step's slot, over the grid
    const uint4* src = reinterpret_cast<const uint4*>(o_in);
    uint4* dst = reinterpret_cast<uint4*>(ring + (size_t)(t_abs % size) * BR);
    for (int i = blockIdx.x * kThreads + tid; i < (int)(BR / 8); i += gridDim.x * kThreads)
      dst[i] = src[i];
  }
  const int g = lane >> 2, qd = lane & 3;
  const int nch = Kb / kChunk;

  for (int b0 = 0; b0 < B; b0 += BT) {
    const int rows = min(BT, B - b0);
    const int nbt = (rows + 7) / 8, rows8 = nbt * 8;
    if (b0 > 0) set_rows(b0, rows, rows8);
    __syncthreads();
    const int ach = Kb / 8;  // 16-byte chunks of a bf16 row slice
    for (int i = tid; i < rows8 * ach; i += kThreads) {
      const int r = i / ach, c = i % ach, k = k0 + c * 8;
      unsigned char* dst = sa + r * Ls.apitch + c * 16;
      if (P == kPost1) {  // u = bf16(relu(skip))
        const float* src = cx.skip + (size_t)(b0 + min(r, rows - 1)) * S + k;
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(fmaxf(src[e], 0.f));
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      } else {
        const bf16* src = (P == kGate && k >= R) ? rp[2 * r + 1] + (k - R)
                                                 : rp[2 * r] + k;
        cp_async16(dst, src);
      }
    }
    // rank 0 also fetches the epilogue's operands of its rows: the gate's
    // aux projections of columns j0.. and R + j0..; out's skip columns or
    // its layer input o
    const int n0 = tile * kM;
    const int epc = P == kGate ? 4 : P == kOut ? (n0 < S ? 4 : 2) : 1;
    for (int i = tid; P <= kOut && rank == 0 && i < rows * epc; i += kThreads) {
      const int r = i / epc, c = i % epc, b = b0 + r;
      const void* src;
      if (P == kGate)
        src = cx.aux + ((size_t)l * B + b) * R2 + (c < 2 ? 0 : R) + tile * 8 + (c & 1) * 4;
      else if (n0 < S)
        src = cx.skip + (size_t)b * S + n0 + c * 4;
      else
        src = o_in + (size_t)b * R + (n0 - S) + c * 8;
      cp_async16(epi + r * kEpiBytes + c * 16, src);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    if constexpr (Q8) {
      // the row's amax over the whole depth: max of the slices' maxima
      for (int r = warp; r < rows8; r += kWarps) {
        const bf16* row = reinterpret_cast<const bf16*>(sa + r * Ls.apitch);
        float m = 0.f;
        for (int k = lane * 8; k < Kb; k += 8 * kWarp) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + k);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            m = fmaxf(m, fabsf(f.x));
            m = fmaxf(m, fabsf(f.y));
          }
        }
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) pmax[r] = m;
      }
      cl.sync();
      if (tid < rows8) {  // a thread per row: the ranks' maxima at once
        float m = 0.f;
        for (int q = 0; q < C; ++q) m = fmaxf(m, cl.map_shared_rank(pmax, q)[tid]);
        const float amax = fmaxf(m, 1e-6f);
        ainv[tid] = 127.f / amax;
        scl[tid] = amax * kInv127;
      }
      __syncthreads();
      for (int r = warp; r < rows8; r += kWarps) {
        const float inv = ainv[r];
        const bf16* row = reinterpret_cast<const bf16*>(sa + r * Ls.apitch);
        unsigned char* qrow = sq + r * Ls.qpitch;
        for (int k = lane * 8; k < Kb; k += 8 * kWarp) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + k);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
          uint32_t word[2] = {0u, 0u};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float2 f = __bfloat1622float2(h[e / 2]);
            const int q = min(max(__float2int_rn((e & 1 ? f.y : f.x) * inv), -127), 127);
            word[e / 4] |= (uint32_t)(q & 0xff) << (8 * (e % 4));
          }
          *reinterpret_cast<uint2*>(qrow + k) = make_uint2(word[0], word[1]);
        }
      }
      __syncthreads();
    }

    // products: warp w takes depth chunks w, w + 8, ... of the slice; the
    // fragment holds (row g, batch columns nt * 8 + 2 qd + {0, 1}) in
    // acc[nt][0..1] and row g + 8 in acc[nt][2..3]
    Acc acc[kMaxBT / 8][4];
#pragma unroll
    for (int nt = 0; nt < kMaxBT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
#pragma unroll 2
    for (int c = warp; c < nch; c += kWarps) {
      if constexpr (Q8) {
        const int kk = c * kChunk + qd * 4;
        const unsigned char* w0 = sw + g * Ls.wpitch + kk;
        const unsigned char* w1 = sw + (g + 8) * Ls.wpitch + kk;
        const uint32_t a0 = ld32(w0), a1 = ld32(w1), a2 = ld32(w0 + 16),
                       a3 = ld32(w1 + 16);
#pragma unroll
        for (int nt = 0; nt < kMaxBT / 8; ++nt) {
          if (nt < nbt) {
            const unsigned char* bp = sq + (nt * 8 + g) * Ls.qpitch + kk;
            mma_s8(acc[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 16));
          }
        }
      } else if constexpr (kF64) {
#pragma unroll
        for (int ks = 0; ks < kChunk; ks += 4) {
          const int kk = c * kChunk + ks + qd;
          const double a0 = bf16_at(sw + g * Ls.wpitch, kk);
          const double a1 = bf16_at(sw + (g + 8) * Ls.wpitch, kk);
#pragma unroll
          for (int nt = 0; nt < kMaxBT / 8; ++nt) {
            if (nt < nbt) {
              const double bv = bf16_at(sa + (nt * 8 + g) * Ls.apitch, kk);
              mma_f64(acc[nt][0], acc[nt][1], a0, bv);
              mma_f64(acc[nt][2], acc[nt][3], a1, bv);
            }
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < kChunk; ks += 16) {
          const int kb = (c * kChunk + ks + qd * 2) * 2;  // bytes
          const unsigned char* w0 = sw + g * Ls.wpitch + kb;
          const unsigned char* w1 = sw + (g + 8) * Ls.wpitch + kb;
          const uint32_t a0 = ld32(w0), a1 = ld32(w1), a2 = ld32(w0 + 16),
                         a3 = ld32(w1 + 16);
#pragma unroll
          for (int nt = 0; nt < kMaxBT / 8; ++nt) {
            if (nt < nbt) {
              const unsigned char* bp = sa + (nt * 8 + g) * Ls.apitch + kb;
              mma_bf16(acc[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 16));
            }
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kMaxBT / 8; ++nt) {
      if (nt < nbt) {
        const int n = nt * 8 + qd * 2;
        Acc* p0 = part + (warp * kM + g) * BT + n;
        Acc* p1 = part + (warp * kM + g + 8) * BT + n;
        p0[0] = acc[nt][0];
        p0[1] = acc[nt][1];
        p1[0] = acc[nt][2];
        p1[1] = acc[nt][3];
      }
    }
    __syncthreads();
    {  // warps in order; the sum goes to rank 0's slot for this rank
      Acc* dst = cl.map_shared_rank(gath, 0) + rank * kM * BT;
      for (int i = tid; i < kM * rows8; i += kThreads) {
        const int m = i / rows8, n = i % rows8;
        Acc s = part[m * BT + n];
        for (int w = 1; w < kWarps; ++w) s += part[(w * kM + m) * BT + n];
        dst[m * BT + n] = s;
      }
    }
    cl.sync();
    if (rank == 0) {  // ranks in order, then the epilogue
      const int npair = P == kGate ? 8 : kM;
      const float* ef = reinterpret_cast<const float*>(epi);
      const bf16* eh = reinterpret_cast<const bf16*>(epi);
      for (int i = tid; i < npair * rows; i += kThreads) {
        const int m = i / rows, r = i % rows, b = b0 + r;
        Acc s0 = gath[m * BT + r];
        for (int q = 1; q < C; ++q) s0 += gath[(q * kM + m) * BT + r];
        if (P == kGate) {
          Acc s1 = gath[(m + 8) * BT + r];
          for (int q = 1; q < C; ++q) s1 += gath[(q * kM + m + 8) * BT + r];
          const float a0 = ef[r * 16 + m], a1 = ef[r * 16 + 8 + m];
          float z0, z1;
          if constexpr (Q8) {
            const float as = scl[r];
            z0 = (float)s0 * as * cst[kM + m] + a0 * w_t + cst[m];
            z1 = (float)s1 * as * cst[kM + m + 8] + a1 * w_t + cst[m + 8];
          } else {
            z0 = (float)s0 + a0 * w_t + cst[m];
            z1 = (float)s1 + a1 * w_t + cst[m + 8];
          }
          const float sg = 1.f / (1.f + expf(-z0));
          cx.g[(size_t)b * R + tile * 8 + m] = __float2bfloat16_rn(sg * tanhf(z1));
        } else if (P == kOut) {
          const int n = n0 + m;
          float v = (float)s0;
          if constexpr (Q8) v = v * scl[r] * cst[kM + m];
          if (n < S) {
            cx.skip[(size_t)b * S + n] = ef[r * 16 + m] + v;
          } else {
            const int rr = n - S;
            const bf16 ov = eh[r * 32 + m];
            cx.o[(size_t)((l + 1) & 1) * BR + (size_t)b * R + rr] =
                __float2bfloat16_rn(__bfloat162float(ov) + v + cst[m]);
            if (!adaptive)  // the fixed ring's slot <- the layer's input
              ring[(size_t)(t_abs % size) * BR + (size_t)b * R + rr] = ov;
          }
        } else if (P == kPost1) {
          cx.u1[(size_t)b * S + n0 + m] =
              __float2bfloat16_rn(fmaxf((float)s0 + cst[m], 0.f));
        } else {
          cx.logits[(size_t)b * Q + n0 + m] = (float)s0 + cst[m];
        }
      }
    }
    if (b0 + BT < B) cl.sync();  // rank 0 is done with this tile's slots
  }
}

// The step's output, a block per row: argmax, hash Gumbel-max sampling or
// forced output, and the x state update.
__global__ void __launch_bounds__(kSampleThreads)
sample_kernel(const Ctx* ctx, int step, int B, int Q, int up, int mode) {
  __shared__ float wbest[kSampleThreads / kWarp];
  __shared__ int wbi[kSampleThreads / kWarp];
  const Ctx& cx = *ctx;
  const int t = cx.frame * up + step;
  const int t_abs = t + cx.step_offset;
  grid_wait();
  grid_release();
  const int b = blockIdx.x;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    float v = cx.logits[(size_t)b * Q + q];
    if (mode == kForced) static_cast<float*>(cx.out)[((size_t)t * B + b) * Q + q] = v;
    if (mode == kSampling) v += gumbel_noise(cx.seed, t_abs, b + cx.b_offset, q, Q);
    if (v > best || (v == best && q < bi)) { best = v; bi = q; }
  }
  // argmax over the block; a tie goes to the lowest class
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
  }
  if (lane == 0) {
    wbest[warp] = best;
    wbi[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)blockDim.x / kWarp; ++w)
      if (wbest[w] > best || (wbest[w] == best && wbi[w] < bi)) {
        best = wbest[w];
        bi = wbi[w];
      }
    const int xn = mode == kForced ? cx.x_forced[(size_t)t * B + b] : bi;
    cx.x[b] = cx.x[B + b];
    cx.x[B + b] = xn;
    if (mode != kForced) static_cast<int*>(cx.out)[(size_t)t * B + b] = xn;
  }
}


// The static shape of one captured frame.
struct Net {
  int nF, nA, B, R, S, Q, KA, up, maxd, mode, quantize;
  const int* dils;
};

struct Entry {
  cudaGraphExec_t exec = nullptr;
  Ctx* ctx = nullptr;          // device context the graph's kernels read
  cudaEvent_t done = nullptr;  // the last call through this graph
  std::mutex mu;
};

std::mutex g_cache_mu;
std::map<std::vector<int>, Entry*> g_cache;

// Largest cluster size up to `want` whose depth slices are whole chunks.
int cluster_for(int K, int want) {
  int c = want;
  while (c > 1 && K % (c * kChunk)) c /= 2;
  return c;
}

// Launch with programmatic dependent launch, in a cluster of `cluster`
// blocks (0: no cluster).
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*k)(KArgs...), int grid, int block, int smem,
                   int cluster, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  at[1].id = cudaLaunchAttributeClusterDimension;
  at[1].val.clusterDim.x = cluster;
  at[1].val.clusterDim.y = 1;
  at[1].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = cluster > 0 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, k, static_cast<KArgs>(args)...);
}

// One product's launch: `tiles` column tiles of depth K, cluster up to `want`.
template <int P, bool Q8>
cudaError_t launch_prod(const Net& n, const Ctx* ctx, cudaStream_t s,
                        int step, int tiles, int K, int want, int l,
                        int ring_off, int size, int adaptive, int dil) {
  const int BT = std::min(kMaxBT, (n.B + 7) / 8 * 8);
  const int C = cluster_for(K, want);
  const int smem = layout(Q8, K / C, BT, (int)sizeof(typename AccT<P, Q8>::T), C).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return launch(prod_kernel<P, Q8>, tiles * C, kThreads, smem, C, s, ctx,
                step, l, ring_off, size, adaptive, dil, n.B, n.R, n.S, n.Q,
                n.up, K, BT);
}

// Enqueue one frame (`up` steps) of kernels on s.  Every kernel reads the
// frame from ctx and takes its step within the frame as an argument, so
// one captured frame serves every frame of every chunk.
cudaError_t enqueue_frame(const Net& n, Ctx* ctx, cudaStream_t s) {
  const int L = n.nF + n.nA, R = n.R, S = n.S, B = n.B;
  const bool q8 = n.quantize == kW8A8;
  int off[64], size[64];
  int offF = 0, offA = 0;
  for (int l = 0; l < L; ++l) {
    if (l < n.nF) {
      size[l] = n.dils[l];
      off[l] = offF;
      offF += size[l];
    } else {
      size[l] = n.maxd * n.dils[l] + 1;  // +1: this step's write never
      off[l] = offA;                     // meets the deepest look-back
      offA += size[l];
    }
  }
  const int embed_blocks = std::min(
      1024, std::max((B * R + kEmbedThreads - 1) / kEmbedThreads,
                     (L * 2 * R + kEmbedThreads - 1) / kEmbedThreads));
  const Ctx* c = ctx;
  cudaError_t e = cudaSuccess;
  for (int step = 0; step < n.up && e == cudaSuccess; ++step) {
    e = launch(embed_kernel, embed_blocks, kEmbedThreads, 0, 0, s, c, step,
               B, R, S, L, n.KA, n.up);
    for (int l = 0; l < L && e == cudaSuccess; ++l) {
      const int a = l >= n.nF;
      e = q8 ? launch_prod<kGate, true>(n, c, s, step, R / 8, 2 * R, 2, l, off[l], size[l], a, n.dils[l])
             : launch_prod<kGate, false>(n, c, s, step, R / 8, 2 * R, 2, l, off[l], size[l], a, n.dils[l]);
      if (e != cudaSuccess) break;
      e = q8 ? launch_prod<kOut, true>(n, c, s, step, (S + R) / kM, R, 4, l, off[l], size[l], a, n.dils[l])
             : launch_prod<kOut, false>(n, c, s, step, (S + R) / kM, R, 4, l, off[l], size[l], a, n.dils[l]);
    }
    if (e == cudaSuccess)
      e = launch_prod<kPost1, false>(n, c, s, step, S / kM, S, 4, 0, 0, 1, 0, 1);
    if (e == cudaSuccess)
      e = launch_prod<kPost2, false>(n, c, s, step, n.Q / kM, S, 4, 0, 0, 1, 0, 1);
    if (e == cudaSuccess)
      e = launch(sample_kernel, B, kSampleThreads, 0, 0, s, c, step, B, n.Q,
                 n.up, n.mode);
  }
  if (e == cudaSuccess) e = launch(advance_kernel, 1, 1, 0, 0, s, ctx);
  return e;
}

cudaError_t allow_smem() {
  const void* fns[] = {
      (const void*)prod_kernel<kGate, false>, (const void*)prod_kernel<kGate, true>,
      (const void*)prod_kernel<kOut, false>, (const void*)prod_kernel<kOut, true>,
      (const void*)prod_kernel<kPost1, false>, (const void*)prod_kernel<kPost2, false>};
  for (const void* f : fns) {
    const cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Capture one frame of `n` as a graph on a private stream (the caller's
// stream may be the legacy stream, which cannot be captured).
cudaError_t make_entry(const Net& n, Entry* e) {
  cudaError_t err = allow_smem();
  if (err == cudaSuccess) err = cudaMalloc(&e->ctx, sizeof(Ctx));
  if (err == cudaSuccess) err = cudaEventCreateWithFlags(&e->done, cudaEventDisableTiming);
  if (err != cudaSuccess) return err;
  cudaStream_t cs;
  err = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  cudaGraph_t graph = nullptr;
  err = cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    const cudaError_t le = enqueue_frame(n, e->ctx, cs);
    err = cudaStreamEndCapture(cs, &graph);
    if (le != cudaSuccess) err = le;
  }
  if (err == cudaSuccess) err = cudaGraphInstantiate(&e->exec, graph, 0);
  if (graph != nullptr) cudaGraphDestroy(graph);
  cudaStreamDestroy(cs);
  return err;
}

}  // namespace

// Runs n_steps generation steps (whole frames) on `stream`, updating the
// ring buffers bufF / bufA and the x state (2, B) in place.
//   dils: host array of L = nF + nA dilations (fixed first).
//   bufF: (sum dilsF, B, R) bf16, layer l at rows cumsum(dilsF)[l].
//   bufA: (sum(maxd * dilsA + 1), B, R) bf16, flat-packed the same way.
//   h_frames (n_steps / up, B, KA) bf16; d_frames (n_steps / up, 1, B) f32;
//   x_forced (n_steps, 1, B) i32 (forced mode only).
//   out: (n_steps, 1, B) i32 samples, or (n_steps, B, Q) f32 logits.
//   Scratch: o_buf (2, B, R), g (B, R), u1 (B, S) bf16; e_prev (B, R),
//   skip (B, S), aux_cache (L, B, 2R), logits (B, Q) f32.
//   quantize 0: W_in_t (L, 2R, 2R) and W_out_t (L, S+R, R) bf16, s_in and
//   s_out unused; 1 (w8a8): both int8 with f32 column scales s_in (L, 2R)
//   and s_out (L, S+R).  R and S multiples of 32, Q of 16, 2R <= kMaxKQ.
// The first call for a (device, network, B, maxd, mode, quantize) captures
// one frame as a CUDA graph; every call then writes the device context and
// replays the graph once per frame.  Calls through one graph are ordered
// by an event, so threads may share it.
extern "C" int qp_generate(
    const void* W_in_t, const void* W_out_t, const void* s_in,
    const void* s_out, const void* W_aux,
    const void* c_all, const void* b_res, const void* b_skip_sum,
    const void* up_w, const void* E_cat, const void* b_causal,
    const void* W_post1_t, const void* W_post2_t, const void* b_post1,
    const void* b_post2, void* bufF, void* bufA, void* x_state,
    const void* h_frames, const void* d_frames, const void* x_forced,
    void* out, void* o_buf, void* g_buf, void* u1_buf,
    void* e_prev, void* skip, void* aux_cache, void* logits,
    const int* dils, int nF, int nA, int B, int R, int S, int Q, int KA,
    int up, int maxd, int n_steps, int step_offset, int b_offset, int seed,
    int mode, int quantize, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int L = nF + nA;
  if (L < 1 || L > 64 || B < 1 || up < 1 || n_steps % up || R % 32 || S % 32
      || Q % kM || 2 * R > kMaxKQ || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::vector<int> key = {dev, nF, nA, B, R, S, Q, KA, up, maxd, mode, quantize};
  key.insert(key.end(), dils, dils + L);
  Entry* e;
  {
    std::lock_guard<std::mutex> lock(g_cache_mu);
    auto it = g_cache.find(key);
    if (it == g_cache.end()) {
      e = new Entry();
      const Net n = {nF, nA, B, R, S, Q, KA, up, maxd, mode, quantize, dils};
      err = make_entry(n, e);
      if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;  // the half-built entry is left unused
      }
      g_cache[key] = e;
    } else {
      e = it->second;
    }
  }
  std::lock_guard<std::mutex> lock(e->mu);
  Ctx h;
  h.W_in = W_in_t;
  h.W_out = W_out_t;
  h.s_in = static_cast<const float*>(s_in);
  h.s_out = static_cast<const float*>(s_out);
  h.W_aux = static_cast<const bf16*>(W_aux);
  h.c_all = static_cast<const float*>(c_all);
  h.b_res = static_cast<const float*>(b_res);
  h.b_skip_sum = static_cast<const float*>(b_skip_sum);
  h.up_w = static_cast<const float*>(up_w);
  h.E_cat = static_cast<const bf16*>(E_cat);
  h.b_causal = static_cast<const float*>(b_causal);
  h.W1 = static_cast<const bf16*>(W_post1_t);
  h.W2 = static_cast<const bf16*>(W_post2_t);
  h.b1 = static_cast<const float*>(b_post1);
  h.b2 = static_cast<const float*>(b_post2);
  h.bufF = static_cast<bf16*>(bufF);
  h.bufA = static_cast<bf16*>(bufA);
  h.x = static_cast<int*>(x_state);
  h.h_frames = static_cast<const bf16*>(h_frames);
  h.d_frames = static_cast<const float*>(d_frames);
  h.x_forced = static_cast<const int*>(x_forced);
  h.out = out;
  h.o = static_cast<bf16*>(o_buf);
  h.g = static_cast<bf16*>(g_buf);
  h.u1 = static_cast<bf16*>(u1_buf);
  h.e_prev = static_cast<float*>(e_prev);
  h.skip = static_cast<float*>(skip);
  h.aux = static_cast<float*>(aux_cache);
  h.logits = static_cast<float*>(logits);
  h.step_offset = step_offset;
  h.b_offset = b_offset;
  h.seed = seed;
  h.frame = 0;
  err = cudaStreamWaitEvent(stream, e->done, 0);
  if (err != cudaSuccess) return (int)err;
  set_ctx_kernel<<<1, 1, 0, stream>>>(e->ctx, h);
  err = cudaGetLastError();
  for (int f = 0; f < n_steps / up && err == cudaSuccess; ++f)
    err = cudaGraphLaunch(e->exec, stream);
  if (err == cudaSuccess) err = cudaEventRecord(e->done, stream);
  return (int)err;
}

