// Autoregressive QPNet generation on Hopper (sm_90a), bf16 or w8a8 weights.
//
// Replaces: qpnet_tpu/ops/gen_kernel.py::pallas_generate (kernel body
// _make_kernel), the TPU kernel that runs the whole sample loop in one
// pallas_call with every weight resident in VMEM.
//
// What bounds it on the H100: every emitted sample runs the full network,
// so each step touches the whole bf16 weight set (46.3 MiB for the default
// net: 16 x [W_in 2R x 2R, W_out R x (S+R), W_aux 48 x 2R], the embedding
// and the post-net).  That set does not fit in shared memory (227 KB per
// block, about 30 MB over all 132 SMs), so the TPU's "weights stay on
// chip" design does not carry over.  Read from HBM every step it costs
// 48.5 MB / 3.35 TB/s = 14.5 us per step; the 50 MB L2 can hold much of it
// across steps.  The products are tiny (2 * B * 22.5 M FLOP per step), far
// below the tensor cores' rate at any decode batch: the step is bound by
// bytes, and in this first version by launches.
//
// Design (first version, simple and exact to the TPU kernel's semantics):
// one host call per chunk loops over the chunk's steps and launches, on the
// caller's stream, 2L + 2 kernels per step:
//   embed_kernel  exact bf16 row gather of [E_cur | E_prev], carried E_prev
//                 half, skip-sum init, and at frame boundaries the L aux
//                 projections h_frame @ W_aux[l] (f32);
//   gate_kernel   per layer: ring read (adaptive layers write o first and
//                 gather each row's look-back slot), [o; past] @ W_in[l] in
//                 f32, aux * up_w[t % up] + c_all, sigmoid * tanh -> bf16 g;
//                 a warp owns the column pair (j, R + j) so the gate is its
//                 epilogue;
//   out_kernel    per layer: g @ W_out[l], skip += first S columns, fixed
//                 ring slot <- the layer's input o, o <- bf16(o + res + b);
//   post_kernel   one block: ReLU, the two post-net products, then argmax,
//                 hash Gumbel-max sampling, or forced output; x state update.
// Every product is a warp per output column: the packed weights are stored
// output-major (column n's depth contiguous), each lane streams 16-byte
// vectors of it and of the activation rows, accumulates in f32, and the
// warp reduces by butterfly shuffles in a fixed order, so a run is
// deterministic and chunked runs are bit-identical to one-shot runs.
// The file is built with -fmad=false: every multiply and add rounds on its
// own, so the plain twin (ops/gen_kernel.py::generate_reference), which
// sums in the same lane order, repeats the kernel's arithmetic bit for bit
// and the two can be compared with no bf16 rounding flips between them.
// The bf16 storage points are the TPU kernel's: o after the embedding and
// after each residual, g, and u before each post-net product.  Later
// versions: keep weights in L2 or shared memory across a persistent
// kernel, tensor cores, CUDA graphs.
//
// w8a8 (quantize = 1; replaces the `mmq` branch of _make_kernel and the q8
// packing of pack_weights): W_in and W_out are int8, output-major, with an
// f32 scale per layer and output column.  gate_q_kernel and out_q_kernel
// take the place of gate_kernel and out_kernel, so a step still makes 2L+2
// launches.  Each block first quantizes its activation rows into shared
// memory, 8 rows at a time, with the TPU kernel's arithmetic: amax =
// max(max_k |a|, 1e-6), aq = clip(rint(a * (127 / amax)), -127, 127) (one
// f32 division, one multiply, round half to even), then a warp per output
// column streams 16 int8 weights per lane per 16-byte load and sums with
// __dp4a in int32.  |aq|, |wq| <= 127 and K <= 1024 (R <= 512) keep every
// sum below 2^24, so float(sum) is exact and z = float(sum) *
// (amax * (1/127)) * scale, in that order, is the TPU kernel's value.
// The per-row scale depends on the ring row each row reads, so it cannot
// be computed once by the previous layer: every block re-quantizes its
// tile (B x 2R values from L2), in one pass of 16-byte loads held in
// registers, which keeps the step at 2L+2 launches.
// Bound: the int8 weights are half the bf16 bytes (49.0 MB for
// Rd10Rr3Ed4Er1), 14.7 us per step from HBM; the products stay far below
// the int8 peak at any decode batch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (no fast-math: logf, expf and tanhf are exact
//        library calls, and 127 / amax an IEEE division).  C entry point
//        qp_generate returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarp = 32;
constexpr int kBT = 8;          // batch rows per register tile
constexpr int kGateWarps = 4;   // column pairs per gate block
constexpr int kOutWarps = 4;    // columns per out block
constexpr int kPostThreads = 1024;
constexpr int kEmbedThreads = 256;
constexpr int kMaxKQ = 1024;    // deepest quantized product (2R): exact sums
// 1/127 rounded once to f32, as JAX rounds its weak-typed 1.0 / 127.0
constexpr float kInv127 = (float)(1.0 / 127.0);

enum Mode { kArgmax = 0, kSampling = 1, kForced = 2 };
enum Quantize { kNone = 0, kW8A8 = 1 };

__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// acc[c][b] = sum_k x_b[k] * w_c[k] for NC output columns and the first nb
// of kBT rows.  w_c: K contiguous bf16.  Row b is xa[b][0:Ka] followed by
// xb[b][0:K-Ka].  K and Ka are multiples of 8 and every pointer is 16-byte
// aligned.  On return every lane of the warp holds every sum.
template <int NC>
__device__ __forceinline__ void warp_dot(const bf16* const (&w)[NC],
                                         const bf16* const (&xa)[kBT],
                                         const bf16* const (&xb)[kBT],
                                         int nb, int Ka, int K,
                                         float (&acc)[NC][kBT]) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int b = 0; b < kBT; ++b) acc[c][b] = 0.f;
  const int nv = K / 8, nva = Ka / 8;
  for (int v = lane; v < nv; v += kWarp) {
    float wf[NC][8];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(w[c]) + v), wf[c]);
#pragma unroll
    for (int b = 0; b < kBT; ++b) {
      if (b < nb) {
        const uint4* xp = v < nva
            ? reinterpret_cast<const uint4*>(xa[b]) + v
            : reinterpret_cast<const uint4*>(xb[b]) + (v - nva);
        float xf[8];
        bf16x8_to_float(*xp, xf);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[c][b] += xf[i] * wf[c][i];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int b = 0; b < kBT; ++b)
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        acc[c][b] += __shfl_xor_sync(0xffffffffu, acc[c][b], off);
}

// w8a8: quantize the first nb of kBT rows into aq[b * K + k] int8 and
// scale[b] = amax * (1/127), the TPU kernel's dynamic per-row scheme.  Row b
// is rowa[b][0:Ka] followed by rowb[b][0:K-Ka] (bf16; Ka and K multiples of
// 8, rows 16-byte aligned).  A warp per row: lane l loads the 8-value
// vectors l, l + 32, ... once, keeps them in registers for the row's max and
// then rounds them.  The caller synchronizes the block before reading aq.
__device__ __forceinline__ void quantize_rows(const bf16* const* rowa,
                                              const bf16* const* rowb,
                                              int nb, int Ka, int K,
                                              int8_t* aq, float* scale) {
  constexpr int kVL = kMaxKQ / 8 / kWarp;  // 8-value vectors per lane
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int nv = K / 8;
  for (int b = warp; b < nb; b += nwarps) {
    float f[kVL][8];
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < kVL; ++i) {
      const int k = (lane + i * kWarp) * 8;
      if (k < K) {
        const bf16* src = k < Ka ? rowa[b] + k : rowb[b] + (k - Ka);
        bf16x8_to_float(*reinterpret_cast<const uint4*>(src), f[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(f[i][e]));
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float amax = fmaxf(m, 1e-6f);
    const float inv = 127.f / amax;
#pragma unroll
    for (int i = 0; i < kVL; ++i) {
      const int v = lane + i * kWarp;
      if (v < nv) {
        unsigned int word[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int q = min(max(__float2int_rn(f[i][e] * inv), -127), 127);
          word[e / 4] |= (unsigned int)(q & 0xff) << (8 * (e % 4));
        }
        *reinterpret_cast<uint2*>(aq + (size_t)b * K + v * 8) =
            make_uint2(word[0], word[1]);
      }
    }
    if (lane == 0) scale[b] = amax * kInv127;
  }
}

// acc[c][b] = sum_k aq[b * K + k] * w_c[k] in int32 for NC output columns
// and the first nb of kBT rows.  w_c: K contiguous int8; K a multiple of 16
// and every pointer 16-byte aligned.  On return every lane holds every sum.
template <int NC>
__device__ __forceinline__ void warp_dot_q(const int8_t* const (&w)[NC],
                                           const int8_t* aq, int nb, int K,
                                           int (&acc)[NC][kBT]) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int b = 0; b < kBT; ++b) acc[c][b] = 0;
  const int nv = K / 16;
  for (int v = lane; v < nv; v += kWarp) {
    int4 wv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wv[c] = __ldg(reinterpret_cast<const int4*>(w[c]) + v);
#pragma unroll
    for (int b = 0; b < kBT; ++b) {
      if (b < nb) {
        const int4 av = reinterpret_cast<const int4*>(aq + b * K)[v];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[c][b] = __dp4a(av.x, wv[c].x, acc[c][b]);
          acc[c][b] = __dp4a(av.y, wv[c].y, acc[c][b]);
          acc[c][b] = __dp4a(av.z, wv[c].z, acc[c][b]);
          acc[c][b] = __dp4a(av.w, wv[c].w, acc[c][b]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int b = 0; b < kBT; ++b)
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        acc[c][b] += __shfl_xor_sync(0xffffffffu, acc[c][b], off);
}

// Row b of a gate's input [o; past]: xa = o's row, xb = the ring row it
// reads (see gate_kernel).
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
__global__ void embed_kernel(const int* __restrict__ x_state,
                             const bf16* __restrict__ E_cat,
                             const float* __restrict__ b_causal,
                             const float* __restrict__ b_skip_sum,
                             float* __restrict__ e_prev, bf16* __restrict__ o,
                             float* __restrict__ skip, int B, int R, int S,
                             int init_prev, int refresh,
                             const bf16* __restrict__ h_frame,
                             const bf16* __restrict__ W_aux,
                             float* __restrict__ aux_cache, int L, int KA) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  const int R2 = 2 * R;
  for (int i = tid; i < B * R; i += nth) {
    const int b = i / R, r = i % R;
    const int xc = x_state[B + b];
    if (init_prev) {
      // chunk start: E_prev[x_prev], later carried from the previous step
      e_prev[i] = __bfloat162float(E_cat[(size_t)x_state[b] * R2 + R + r]);
    }
    const float v = __bfloat162float(E_cat[(size_t)xc * R2 + r]) + e_prev[i]
                    + b_causal[r];
    o[i] = __float2bfloat16_rn(v);
    e_prev[i] = __bfloat162float(E_cat[(size_t)xc * R2 + R + r]);
  }
  for (int i = tid; i < B * S; i += nth) skip[i] = b_skip_sum[i % S];
  if (refresh) {
    for (int i = tid; i < L * R2; i += nth) {
      const int l = i / R2, n = i % R2;
      const bf16* w = W_aux + (size_t)l * KA * R2 + n;
      for (int b = 0; b < B; ++b) {
        float acc = 0.f;
        for (int k = 0; k < KA; ++k)
          acc += __bfloat162float(h_frame[b * KA + k])
                 * __bfloat162float(w[(size_t)k * R2]);
        aux_cache[((size_t)l * B + b) * R2 + n] = acc;
      }
    }
  }
}

// One layer's gate: g = bf16(sigmoid(z[:, :R]) * tanh(z[:, R:])).
// ring: this layer's ring, `size` slots of (B, R).  Fixed layers read slot
// t_abs % size (overwritten later by out_kernel).  Adaptive layers write o
// into slot t_abs % size first (block 0), then read each row's slot
// (t_abs - r_b) mod size with r_b = clip(rint(d_b * dil), 0, size - 1);
// r_b = 0 is the slot just written, so it reads o itself and no block
// depends on block 0's write.
__global__ void gate_kernel(const bf16* __restrict__ o, bf16* ring, int size,
                            int adaptive, int dil,
                            const float* __restrict__ d_frame, int t_abs,
                            const bf16* __restrict__ W_t,
                            const float* __restrict__ aux,
                            const float* __restrict__ c,
                            const float* __restrict__ up_w, int up,
                            bf16* __restrict__ g, int B, int R) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const size_t BR = (size_t)B * R;
  const int wslot = t_abs % size;
  if (adaptive && blockIdx.x == 0)
    for (int i = threadIdx.x; i < B * R; i += blockDim.x)
      ring[wslot * BR + i] = o[i];
  const int j = blockIdx.x * kGateWarps + warp;
  if (j >= R) return;
  const int R2 = 2 * R;
  const float w_t = up_w[t_abs % up];
  const bf16* const w[2] = {W_t + (size_t)j * R2, W_t + (size_t)(R + j) * R2};
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int nb = min(kBT, B - b0);
    const bf16* xa[kBT];
    const bf16* xb[kBT];
#pragma unroll
    for (int bt = 0; bt < kBT; ++bt)  // rows past nb repeat the last one
      gate_row(o, ring, size, adaptive, dil, d_frame, t_abs, B, R,
               b0 + min(bt, nb - 1), xa[bt], xb[bt]);
    float acc[2][kBT];
    warp_dot<2>(w, xa, xb, nb, R, R2, acc);
#pragma unroll
    for (int bt = 0; bt < kBT; ++bt) {
      if (bt < nb && lane == bt) {
        const int b = b0 + bt;
        const float* ab = aux + (size_t)b * R2;
        const float z0 = acc[0][bt] + ab[j] * w_t + c[j];
        const float z1 = acc[1][bt] + ab[R + j] * w_t + c[R + j];
        const float s = 1.f / (1.f + expf(-z0));
        g[(size_t)b * R + j] = __float2bfloat16_rn(s * tanhf(z1));
      }
    }
  }
}

// One layer's output: [skip | res] = g @ W_out[l].  skip += skip part;
// fixed layers store the layer input o in their ring slot; o_out =
// bf16(o_in + res + b_res).
__global__ void out_kernel(const bf16* __restrict__ g,
                           const bf16* __restrict__ o_in,
                           bf16* __restrict__ o_out, float* __restrict__ skip,
                           bf16* __restrict__ ring_slot,
                           const bf16* __restrict__ W_t,
                           const float* __restrict__ b_res, int B, int R,
                           int S) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kOutWarps + warp;
  if (n >= S + R) return;
  const bf16* const w[1] = {W_t + (size_t)n * R};
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int nb = min(kBT, B - b0);
    const bf16* xa[kBT];
#pragma unroll
    for (int bt = 0; bt < kBT; ++bt) xa[bt] = g + (size_t)(b0 + min(bt, nb - 1)) * R;
    float acc[1][kBT];
    warp_dot<1>(w, xa, xa, nb, R, R, acc);
#pragma unroll
    for (int bt = 0; bt < kBT; ++bt) {
      if (bt < nb && lane == bt) {
        const int b = b0 + bt;
        if (n < S) {
          skip[(size_t)b * S + n] += acc[0][bt];
        } else {
          const int r = n - S;
          const bf16 ov = o_in[(size_t)b * R + r];
          o_out[(size_t)b * R + r] =
              __float2bfloat16_rn(__bfloat162float(ov) + acc[0][bt] + b_res[r]);
          if (ring_slot != nullptr) ring_slot[(size_t)b * R + r] = ov;
        }
      }
    }
  }
}

// gate_kernel with int8 W_in (L's slice W_t: 2R columns of 2R int8) and
// column scales s: z = float(aq . wq) * (amax / 127) * s + aux * w_t + c.
__global__ void gate_q_kernel(const bf16* __restrict__ o, bf16* ring, int size,
                              int adaptive, int dil,
                              const float* __restrict__ d_frame, int t_abs,
                              const int8_t* __restrict__ W_t,
                              const float* __restrict__ s,
                              const float* __restrict__ aux,
                              const float* __restrict__ c,
                              const float* __restrict__ up_w, int up,
                              bf16* __restrict__ g, int B, int R) {
  __shared__ __align__(16) int8_t aq[kBT * kMaxKQ];
  __shared__ float ascale[kBT];
  __shared__ const bf16* rowa[kBT];
  __shared__ const bf16* rowb[kBT];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const size_t BR = (size_t)B * R;
  if (adaptive && blockIdx.x == 0)
    for (int i = threadIdx.x; i < B * R; i += blockDim.x)
      ring[(t_abs % size) * BR + i] = o[i];
  const int j = blockIdx.x * kGateWarps + warp;
  const int R2 = 2 * R;
  const float w_t = up_w[t_abs % up];
  const int8_t* const w[2] = {W_t + (size_t)min(j, R - 1) * R2,
                              W_t + (size_t)(R + min(j, R - 1)) * R2};
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int nb = min(kBT, B - b0);
    if (threadIdx.x < nb)
      gate_row(o, ring, size, adaptive, dil, d_frame, t_abs, B, R,
               b0 + threadIdx.x, rowa[threadIdx.x], rowb[threadIdx.x]);
    __syncthreads();
    quantize_rows(rowa, rowb, nb, R, R2, aq, ascale);
    __syncthreads();
    if (j < R) {
      int acc[2][kBT];
      warp_dot_q<2>(w, aq, nb, R2, acc);
#pragma unroll
      for (int bt = 0; bt < kBT; ++bt) {
        if (bt < nb && lane == bt) {
          const int b = b0 + bt;
          const float* ab = aux + (size_t)b * R2;
          const float as = ascale[bt];
          const float z0 = (float)acc[0][bt] * as * s[j] + ab[j] * w_t + c[j];
          const float z1 = (float)acc[1][bt] * as * s[R + j] + ab[R + j] * w_t
                           + c[R + j];
          const float sg = 1.f / (1.f + expf(-z0));
          g[(size_t)b * R + j] = __float2bfloat16_rn(sg * tanhf(z1));
        }
      }
    }
    __syncthreads();  // aq is rewritten by the next tile
  }
}

// out_kernel with int8 W_out (S + R columns of R int8) and column scales s.
__global__ void out_q_kernel(const bf16* __restrict__ g,
                             const bf16* __restrict__ o_in,
                             bf16* __restrict__ o_out, float* __restrict__ skip,
                             bf16* __restrict__ ring_slot,
                             const int8_t* __restrict__ W_t,
                             const float* __restrict__ s,
                             const float* __restrict__ b_res, int B, int R,
                             int S) {
  __shared__ __align__(16) int8_t aq[kBT * kMaxKQ];
  __shared__ float ascale[kBT];
  __shared__ const bf16* rows[kBT];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * kOutWarps + warp;
  const int8_t* const w[1] = {W_t + (size_t)min(n, S + R - 1) * R};
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int nb = min(kBT, B - b0);
    if (threadIdx.x < nb) rows[threadIdx.x] = g + (size_t)(b0 + threadIdx.x) * R;
    __syncthreads();
    quantize_rows(rows, rows, nb, R, R, aq, ascale);
    __syncthreads();
    if (n < S + R) {
      int acc[1][kBT];
      warp_dot_q<1>(w, aq, nb, R, acc);
#pragma unroll
      for (int bt = 0; bt < kBT; ++bt) {
        if (bt < nb && lane == bt) {
          const int b = b0 + bt;
          const float v = (float)acc[0][bt] * ascale[bt] * s[n];
          if (n < S) {
            skip[(size_t)b * S + n] += v;
          } else {
            const int r = n - S;
            const bf16 ov = o_in[(size_t)b * R + r];
            o_out[(size_t)b * R + r] =
                __float2bfloat16_rn(__bfloat162float(ov) + v + b_res[r]);
            if (ring_slot != nullptr) ring_slot[(size_t)b * R + r] = ov;
          }
        }
      }
    }
    __syncthreads();
  }
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

// Post-net and output for one step, in one block.  u, u1 (B, S) bf16 and
// logits (B, Q) f32 are scratch in global memory, visible across the
// block's threads after __syncthreads.
__global__ void post_kernel(const float* __restrict__ skip, bf16* u, bf16* u1,
                            float* logits, const bf16* __restrict__ W1_t,
                            const float* __restrict__ b1,
                            const bf16* __restrict__ W2_t,
                            const float* __restrict__ b2, int B, int S, int Q,
                            int mode, int seed, int t_abs, int b_offset,
                            const int* __restrict__ x_forced_t, int* x_state,
                            int* __restrict__ samples_t,
                            float* __restrict__ logits_t) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  for (int i = threadIdx.x; i < B * S; i += blockDim.x)
    u[i] = __float2bfloat16_rn(fmaxf(skip[i], 0.f));
  __syncthreads();
  for (int n = warp; n < S; n += nwarps) {
    const bf16* const w[1] = {W1_t + (size_t)n * S};
    for (int b0 = 0; b0 < B; b0 += kBT) {
      const int nb = min(kBT, B - b0);
      const bf16* xa[kBT];
#pragma unroll
      for (int bt = 0; bt < kBT; ++bt) xa[bt] = u + (size_t)(b0 + min(bt, nb - 1)) * S;
      float acc[1][kBT];
      warp_dot<1>(w, xa, xa, nb, S, S, acc);
#pragma unroll
      for (int bt = 0; bt < kBT; ++bt)
        if (bt < nb && lane == bt)
          u1[(size_t)(b0 + bt) * S + n] = __float2bfloat16_rn(fmaxf(acc[0][bt] + b1[n], 0.f));
    }
  }
  __syncthreads();
  for (int n = warp; n < Q; n += nwarps) {
    const bf16* const w[1] = {W2_t + (size_t)n * S};
    for (int b0 = 0; b0 < B; b0 += kBT) {
      const int nb = min(kBT, B - b0);
      const bf16* xa[kBT];
#pragma unroll
      for (int bt = 0; bt < kBT; ++bt) xa[bt] = u1 + (size_t)(b0 + min(bt, nb - 1)) * S;
      float acc[1][kBT];
      warp_dot<1>(w, xa, xa, nb, S, S, acc);
#pragma unroll
      for (int bt = 0; bt < kBT; ++bt)
        if (bt < nb && lane == bt) logits[(size_t)(b0 + bt) * Q + n] = acc[0][bt] + b2[n];
    }
  }
  __syncthreads();
  for (int b = warp; b < B; b += nwarps) {
    float best = -INFINITY;
    int bi = 0x7fffffff;
    for (int q = lane; q < Q; q += kWarp) {
      float v = logits[(size_t)b * Q + q];
      if (mode == kForced) logits_t[(size_t)b * Q + q] = v;
      if (mode == kSampling) v += gumbel_noise(seed, t_abs, b + b_offset, q, Q);
      if (v > best || (v == best && q < bi)) { best = v; bi = q; }
    }
    // argmax over the warp; a tie goes to the lowest class
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
    }
    if (lane == 0) {
      const int xn = mode == kForced ? x_forced_t[b] : bi;
      x_state[b] = x_state[B + b];
      x_state[B + b] = xn;
      if (mode != kForced) samples_t[b] = xn;
    }
  }
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
//   Scratch: o_buf (2, B, R), g (B, R), u, u1 (B, S) bf16; e_prev (B, R),
//   skip (B, S), aux_cache (L, B, 2R), logits (B, Q) f32.
//   quantize 0: W_in_t (L, 2R, 2R) and W_out_t (L, S+R, R) bf16, s_in and
//   s_out unused; 1 (w8a8): both int8 with f32 column scales s_in (L, 2R)
//   and s_out (L, S+R), R a multiple of 16 and 2R <= kMaxKQ.
extern "C" int qp_generate(
    const void* W_in_t, const void* W_out_t, const void* s_in,
    const void* s_out, const void* W_aux,
    const void* c_all, const void* b_res, const void* b_skip_sum,
    const void* up_w, const void* E_cat, const void* b_causal,
    const void* W_post1_t, const void* W_post2_t, const void* b_post1,
    const void* b_post2, void* bufF, void* bufA, void* x_state,
    const void* h_frames, const void* d_frames, const void* x_forced,
    void* out, void* o_buf, void* g_buf, void* u_buf, void* u1_buf,
    void* e_prev, void* skip, void* aux_cache, void* logits,
    const int* dils, int nF, int nA, int B, int R, int S, int Q, int KA,
    int up, int maxd, int n_steps, int step_offset, int b_offset, int seed,
    int mode, int quantize, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int L = nF + nA;
  const size_t BR = (size_t)B * R;
  bf16* ringF = static_cast<bf16*>(bufF);
  bf16* ringA = static_cast<bf16*>(bufA);
  bf16* ring[64];
  int size[64];
  if (L > 64) return (int)cudaErrorInvalidValue;
  if (quantize == kW8A8 && (R % 16 || 2 * R > kMaxKQ))
    return (int)cudaErrorInvalidValue;
  size_t offF = 0, offA = 0;
  for (int l = 0; l < L; ++l) {
    if (l < nF) {
      size[l] = dils[l];
      ring[l] = ringF + offF * BR;
      offF += size[l];
    } else {
      size[l] = maxd * dils[l] + 1;  // +1: this step's write never meets
      ring[l] = ringA + offA * BR;   // the deepest look-back
      offA += size[l];
    }
  }
  const bf16* Win = static_cast<const bf16*>(W_in_t);
  const bf16* Wout = static_cast<const bf16*>(W_out_t);
  const int8_t* Win_q = static_cast<const int8_t*>(W_in_t);
  const int8_t* Wout_q = static_cast<const int8_t*>(W_out_t);
  const float* sin_ = static_cast<const float*>(s_in);
  const float* sout = static_cast<const float*>(s_out);
  const float* c = static_cast<const float*>(c_all);
  const float* bres = static_cast<const float*>(b_res);
  const float* aux = static_cast<const float*>(aux_cache);
  bf16* o[2] = {static_cast<bf16*>(o_buf), static_cast<bf16*>(o_buf) + BR};
  bf16* g = static_cast<bf16*>(g_buf);
  const int R2 = 2 * R;
  const int embed_blocks = (int)fminf(
      1024.f, fmaxf((float)((B * R + kEmbedThreads - 1) / kEmbedThreads),
                    (float)((L * R2 + kEmbedThreads - 1) / kEmbedThreads)));
  const int gate_blocks = (R + kGateWarps - 1) / kGateWarps;
  const int out_blocks = (S + R + kOutWarps - 1) / kOutWarps;
  for (int t = 0; t < n_steps; ++t) {
    const int t_abs = t + step_offset;
    const int frame = t / up;
    embed_kernel<<<embed_blocks, kEmbedThreads, 0, stream>>>(
        static_cast<const int*>(x_state), static_cast<const bf16*>(E_cat),
        static_cast<const float*>(b_causal),
        static_cast<const float*>(b_skip_sum), static_cast<float*>(e_prev),
        o[0], static_cast<float*>(skip), B, R, S, t == 0, t % up == 0,
        static_cast<const bf16*>(h_frames) + (size_t)frame * B * KA,
        static_cast<const bf16*>(W_aux), static_cast<float*>(aux_cache), L,
        KA);
    const float* d_fr = static_cast<const float*>(d_frames) + (size_t)frame * B;
    for (int l = 0; l < L; ++l) {
      const int adaptive = l >= nF;
      bf16* oi = o[l & 1];
      bf16* oo = o[(l + 1) & 1];
      bf16* slot = adaptive ? nullptr
                            : ring[l] + (size_t)(t_abs % size[l]) * BR;
      if (quantize == kW8A8) {
        gate_q_kernel<<<gate_blocks, kGateWarps * kWarp, 0, stream>>>(
            oi, ring[l], size[l], adaptive, dils[l], d_fr, t_abs,
            Win_q + (size_t)l * R2 * R2, sin_ + (size_t)l * R2,
            aux + (size_t)l * B * R2, c + (size_t)l * R2,
            static_cast<const float*>(up_w), up, g, B, R);
        out_q_kernel<<<out_blocks, kOutWarps * kWarp, 0, stream>>>(
            g, oi, oo, static_cast<float*>(skip), slot,
            Wout_q + (size_t)l * (S + R) * R, sout + (size_t)l * (S + R),
            bres + (size_t)l * R, B, R, S);
      } else {
        gate_kernel<<<gate_blocks, kGateWarps * kWarp, 0, stream>>>(
            oi, ring[l], size[l], adaptive, dils[l], d_fr, t_abs,
            Win + (size_t)l * R2 * R2, aux + (size_t)l * B * R2,
            c + (size_t)l * R2, static_cast<const float*>(up_w), up, g, B, R);
        out_kernel<<<out_blocks, kOutWarps * kWarp, 0, stream>>>(
            g, oi, oo, static_cast<float*>(skip), slot,
            Wout + (size_t)l * (S + R) * R, bres + (size_t)l * R, B, R, S);
      }
    }
    post_kernel<<<1, kPostThreads, 0, stream>>>(
        static_cast<const float*>(skip), static_cast<bf16*>(u_buf),
        static_cast<bf16*>(u1_buf), static_cast<float*>(logits),
        static_cast<const bf16*>(W_post1_t), static_cast<const float*>(b_post1),
        static_cast<const bf16*>(W_post2_t), static_cast<const float*>(b_post2),
        B, S, Q, mode, seed, t_abs, b_offset,
        mode == kForced ? static_cast<const int*>(x_forced) + (size_t)t * B : nullptr,
        static_cast<int*>(x_state),
        mode == kForced ? nullptr : static_cast<int*>(out) + (size_t)t * B,
        mode == kForced ? static_cast<float*>(out) + (size_t)t * B * Q : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
