// Teacher-forced residual stack of QPNet on Hopper (sm_90a): the forward
// and the backward of the training step's fused stack, f32 or bf16.
//
// Replaces: qpnet_tpu/ops/train_kernel.py::_fwd_call (kernel body
// _make_fwd_kernel) and ::_bwd_call (kernel body _make_bwd_kernel), the two
// TPU kernels behind the custom VJP fixed_stack_fused.  Both variants: the
// fixed layers only (nA = 0), and the fixed layers followed by the
// pitch-adaptive ones (nA > 0, frame-constant look-backs bucketed by maxd).
//
// What it computes, per layer l with input o (rows m = b*T + t):
//   forward   z = [o | past(o) | h] @ [W_in; W_aux] + b_gate  (f32)
//             st = [sigmoid(z_s) | tanh(z_t)] stored in the act type,
//             g = (s * t) rounded to the compute type,
//             out = g @ W_out, skip += out[:, :S],
//             o' = act(o + out[:, S:] + b_res)
//   backward  dW_out = g^T @ [dskip | do], dg = [dskip | do] @ W_out^T,
//             the gate derivative at the compute type's precision -> dz,
//             db_gate = sum dz, db_res = sum do,
//             [dW_in; dW_aux] = [o | past | h]^T @ dz,
//             dx = dz @ [W_in; W_aux]^T, do += dx[:, :R] + back(dx[:, R:2R]),
//             dh += dx[:, 2R:]
// where past(o)[t] = o[t - dil] with zeros before t = 0 on a fixed layer,
// and o[max(t - r_f, 0)] with r_f = clip(round(d_f * dil), 0, maxd * dil)
// of frame f = t / up on an adaptive layer; back() is the transpose of that
// shift or gather (every row below 0 folds into row 0).
//
// What bounds it on the H100: the products.  At the default net (R = 512,
// S = 256, B = 1, T = 30030) a layer's forward is 2 * T * (1072 * 1024 +
// 512 * 768) = 89.5 GFLOP and its backward twice that, 3.22 TFLOP for a
// 12-layer step (4.30 for 16).  The activations saved for the backward
// (oall, st: 4R values per row and layer) are 2.2 GB at f32 for 12 layers,
// 0.66 ms of HBM time, so the bound is set by operations: f32 at the card's
// 67 TFLOP/s outside the tensor cores, bf16 at 989 TFLOP/s dense.
//
// Design (first version: simple, exact to the TPU kernel's semantics, no
// TPU tiling).  The TPU kernel tiles time so that weights fit in VMEM and
// carries dilated history and scatter windows between tiles; on the card
// the whole sequence's activations sit in HBM, so each product is one
// launch over all rows.  One templated SIMT GEMM (128 x 128 block tile,
// 16-deep k steps through shared memory, an 8 x 8 register tile per thread,
// f32 fused multiply-adds) serves every product; its operands are loaded
// through small functors that apply the shift or gather by index (a per-layer
// row table), concatenate [o | past | h], round [dskip | do] to the compute
// type, or rebuild g from the stored s and t, so none of those matrices is
// ever written out.  The epilogues do the gate, the residual and skip
// updates, and the gate derivative.  bf16 operands are widened to f32 in
// shared memory: the products run at the f32 rate (tensor cores, wgmma and
// TMA are for a later version).
//
// Determinism: every output element is summed by one thread in a fixed
// order.  Weight gradients (sums over all B*T rows) are split over a fixed
// number of row ranges whose partial sums are added in order by a second
// kernel, and the bias gradients likewise; the adaptive layers' scatter is
// written as a gather over the frames that can reach each row.  No float
// atomics: two calls on the same inputs give the same bits.
//
// bf16 storage points are the TPU kernel's: st, g and o' rounded from f32
// (__float2bfloat16_rn); in the backward g = bf16(s * t) from the stored
// s, t, [dskip | do] rounded before each product, and the gate derivative
// chain rounded after every multiply and subtract.  The file is built with
// -fmad=false (shared with gen_kernel.cu); the products use explicit fmaf.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC.  C entry points qp_train_fwd and qp_train_bwd
//        return cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBM = 128;      // block tile rows
constexpr int kBN = 128;      // block tile columns
constexpr int kBK = 16;       // depth per shared-memory step
constexpr int kThreads = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int kColsumChunks = 128;
constexpr int kEltThreads = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, as f32
template <class T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// operand functors: element (i, k) of an I x K operand; kKFast says whether
// consecutive k are adjacent in memory (sets the loading threads' layout)
// ---------------------------------------------------------------------------

// [o | past(o) | h] (rows x 2R + AP) of one layer; past row index from a
// table (-1: zero fill)
template <class T>
struct GatherX {
  static constexpr bool kKFast = true;
  const T* o;
  const T* h;
  const int* past;
  int R, AP;
  __device__ __forceinline__ float operator()(int m, int k) const {
    if (k < R) return ld(o + (size_t)m * R + k);
    if (k < 2 * R) {
      const int p = past[m];
      return p < 0 ? 0.f : ld(o + (size_t)p * R + (k - R));
    }
    return ld(h + (size_t)m * AP + (k - 2 * R));
  }
};

// a row-major matrix, element (i, k) at p[i * ld + k]
template <class T>
struct RowMajor {
  static constexpr bool kKFast = true;
  const T* p;
  int ldm;
  __device__ __forceinline__ float operator()(int i, int k) const {
    return ld(p + (size_t)i * ldm + k);
  }
};

// [dskip | do] (rows x S + R, f32) rounded to T
template <class T>
struct DOut {
  static constexpr bool kKFast = true;
  const float* dskip;
  const float* dout;
  int S, R;
  __device__ __forceinline__ float operator()(int m, int k) const {
    const float v = k < S ? dskip[(size_t)m * S + k] : dout[(size_t)m * R + (k - S)];
    return rnd<T>(v);
  }
};

// g = T(s * t) rebuilt from the stored gate activations (rows x R)
template <class T>
struct GateG {
  static constexpr bool kKFast = true;
  const T* st;
  int R;
  __device__ __forceinline__ float operator()(int m, int k) const {
    const T* row = st + (size_t)m * 2 * R;
    return rnd<T>(ld(row + k) * ld(row + R + k));
  }
};

// element (i, k) of F's transpose
template <class F>
struct Trans {
  static constexpr bool kKFast = !F::kKFast;
  F f;
  __device__ __forceinline__ float operator()(int i, int k) const { return f(k, i); }
};

// ---------------------------------------------------------------------------
// the GEMM: C (M x N) = A (M x K) @ B (K x N), over the depth range of split
// blockIdx.z.  A(i, k) and B(k, n) are functors; B is given as its
// transpose functor Bt(n, k).  PAIRED: block x owns columns j0 + [0, 64) and
// pair_off + j0 + [0, 64) with j0 = 64 * blockIdx.x, and each thread holds
// both columns of a pair, so an epilogue can combine column j with pair_off
// + j.  Epilogue ep(m, nA, validA, accA, nB, validB, accB, split).
// ---------------------------------------------------------------------------

template <class AF, class BtF, class EP, bool PAIRED>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(AF a, BtF bt, EP ep, int M, int N, int K, int k_split, int pair_off) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  auto col_of = [&](int c) -> int {
    if (PAIRED) {
      const int j = blockIdx.x * (kBN / 2) + (c % (kBN / 2));
      return c < kBN / 2 ? j : pair_off + j;
    }
    return blockIdx.x * kBN + c;
  };
  auto col_ok = [&](int c) -> bool {
    if (PAIRED) return blockIdx.x * (kBN / 2) + (c % (kBN / 2)) < pair_off;
    return blockIdx.x * kBN + c < N;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int s = 0; s < kBM * kBK / kThreads; ++s) {
      const int e = tid + s * kThreads;
      int ii, kk;
      if (AF::kKFast) { kk = e % kBK; ii = e / kBK; }
      else { ii = e % kBM; kk = e / kBM; }
      const int m = m0 + ii, k = k0 + kk;
      As[kk][ii] = (m < M && k < k_end) ? a(m, k) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kBN * kBK / kThreads; ++s) {
      const int e = tid + s * kThreads;
      int cc, kk;
      if (BtF::kKFast) { kk = e % kBK; cc = e / kBK; }
      else { cc = e % kBN; kk = e / kBN; }
      const int k = k0 + kk;
      Bs[kk][cc] = (col_ok(cc) && k < k_end) ? bt(col_of(cc), k) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ra[8], rb[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][kBM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][kBN / 2 + tx * 4]);
      ra[0] = a0.x; ra[1] = a0.y; ra[2] = a0.z; ra[3] = a0.w;
      ra[4] = a1.x; ra[5] = a1.y; ra[6] = a1.z; ra[7] = a1.w;
      rb[0] = b0.x; rb[1] = b0.y; rb[2] = b0.z; rb[3] = b0.w;
      rb[4] = b1.x; rb[5] = b1.y; rb[6] = b1.z; rb[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : kBM / 2 + ty * 4 + (i - 4));
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ca = tx * 4 + j, cb = kBN / 2 + tx * 4 + j;
      ep(m, col_of(ca), col_ok(ca), acc[i][j], col_of(cb), col_ok(cb),
         acc[i][4 + j], (int)blockIdx.z);
    }
  }
}

// ---------------------------------------------------------------------------
// epilogues
// ---------------------------------------------------------------------------

// forward gate: z = acc + b_gate; st <- [sigmoid | tanh]; g <- s * t
template <class T>
struct EpGate {
  const float* b_gate;
  T* st;
  T* g;
  int R;
  __device__ __forceinline__ void operator()(int m, int j, bool ok, float zs, int jt,
                                             bool, float zt, int) const {
    if (!ok) return;
    zs = zs + b_gate[j];
    zt = zt + b_gate[jt];
    const float s = 1.f / (1.f + expf(-zs));
    const float t = tanhf(zt);
    T* row = st + (size_t)m * 2 * R;
    row[j] = from_f<T>(s);
    row[jt] = from_f<T>(t);
    g[(size_t)m * R + j] = from_f<T>(s * t);
  }
};

// forward output: skip += out[:, :S]; o' = T(o + out[:, S:] + b_res)
template <class T>
struct EpOut {
  const T* o;
  const float* b_res;
  T* o_next;
  float* skip;
  int R, S;
  __device__ __forceinline__ void one(int m, int n, float v) const {
    if (n < S) {
      float* p = skip + (size_t)m * S + n;
      *p = *p + v;
    } else {
      const int c = n - S;
      o_next[(size_t)m * R + c] = from_f<T>((ld(o + (size_t)m * R + c) + v) + b_res[c]);
    }
  }
  __device__ __forceinline__ void operator()(int m, int na, bool oka, float va, int nb,
                                             bool okb, float vb, int) const {
    if (oka) one(m, na, va);
    if (okb) one(m, nb, vb);
  }
};

// plain store: out[z][m * ldo + n] = acc
struct EpStore {
  float* out;
  int ldo;
  size_t split_stride;
  __device__ __forceinline__ void operator()(int m, int na, bool oka, float va, int nb,
                                             bool okb, float vb, int z) const {
    float* base = out + (size_t)z * split_stride + (size_t)m * ldo;
    if (oka) base[na] = va;
    if (okb) base[nb] = vb;
  }
};

// backward gate derivative: dg (rows x R) -> dz (rows x 2R), rounded to T
// after every operation, as the TPU kernel's compute-precision chain
template <class T>
struct EpGateGrad {
  const T* st;
  T* dz;
  int R;
  __device__ __forceinline__ void one(int m, int j, float dg) const {
    const T* row = st + (size_t)m * 2 * R;
    const float s = ld(row + j), t = ld(row + R + j);
    const float dgc = rnd<T>(dg);
    const float u = rnd<T>(dgc * s);
    float a = rnd<T>(dgc * t);
    a = rnd<T>(a * s);
    const float dzs = rnd<T>(a * rnd<T>(1.f - s));
    float b = rnd<T>(u * t);
    b = rnd<T>(b * t);
    const float dzt = rnd<T>(u - b);
    T* out = dz + (size_t)m * 2 * R;
    out[j] = from_f<T>(dzs);
    out[R + j] = from_f<T>(dzt);
  }
  __device__ __forceinline__ void operator()(int m, int na, bool oka, float va, int nb,
                                             bool okb, float vb, int) const {
    if (oka) one(m, na, va);
    if (okb) one(m, nb, vb);
  }
};

// ---------------------------------------------------------------------------
// small kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ int look_back(const float* d_frames, int b, int t, int F,
                                         int up, int dil, int maxd) {
  const int r = __float2int_rn(d_frames[(size_t)b * F + t / up] * (float)dil);
  return min(max(r, 0), maxd * dil);
}

// row each position's past input comes from, or -1 for zero fill
__global__ void past_rows_kernel(int* past, const float* d_frames, int B, int T, int F,
                                 int up, int dil, int maxd, int adaptive) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= B * T) return;
  const int b = m / T, t = m % T;
  if (adaptive) {
    past[m] = b * T + max(t - look_back(d_frames, b, t, F, up, dil, maxd), 0);
  } else {
    past[m] = t >= dil ? m - dil : -1;
  }
}

// part[c][n] = sum of x[m][n] over rows m of chunk c, in order
template <class T>
__global__ void colsum_kernel(const T* x, int M, int N, int rows_per_chunk, float* part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);
  float s = 0.f;
  for (int m = r0; m < r1; ++m) s = s + ld(x + (size_t)m * N + n);
  part[(size_t)blockIdx.y * N + n] = s;
}

// out[e] = sum over z of part[z][e], in order of z
__global__ void reduce_parts_kernel(const float* part, int nz, size_t count, float* out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int z = 0; z < nz; ++z) s = s + part[(size_t)z * count + e];
  out[e] = s;
}

// do += dx[:, :R] + back(dx[:, R:2R]); dh += dx[:, 2R:]
__global__ void combine_kernel(float* dout, float* dh, const float* dx, const float* d_frames,
                               int B, int T, int F, int R, int AP, int up, int dil, int maxd,
                               int adaptive) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)B * T * R) return;
  const int K1 = 2 * R + AP;
  const int m = (int)(e / R), c = (int)(e % R);
  const int b = m / T, p = m % T;
  const float* dprev = dx + R + c;   // column c of the past half
  float back = 0.f;
  if (!adaptive) {
    if (p + dil < T) back = dprev[(size_t)(m + dil) * K1];
  } else {
    // every t whose look-back lands on p: t - r_f(t) == p, or t - r_f(t) < 0
    // when p == 0 (rows below 0 read row 0)
    const int H = maxd * dil;
    const size_t row0 = (size_t)b * T;
    if (p == 0) {
      for (int t = 0; t < T && t <= H; ++t)
        if (t <= look_back(d_frames, b, t, F, up, dil, maxd))
          back = back + dprev[(row0 + t) * K1];
    } else {
      const int f1 = min((p + H) / up, F - 1);
      for (int f = p / up; f <= f1; ++f) {
        const int t = p + look_back(d_frames, b, f * up, F, up, dil, maxd);
        if (t >= f * up && t < (f + 1) * up && t < T) back = back + dprev[(row0 + t) * K1];
      }
    }
  }
  const float* row = dx + (size_t)m * K1;
  dout[e] = (dout[e] + row[c]) + back;
  if (c < AP) dh[(size_t)m * AP + c] = dh[(size_t)m * AP + c] + row[2 * R + c];
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

template <class AF, class BtF, class EP, bool PAIRED>
void gemm(cudaStream_t st, AF a, BtF bt, EP ep, int M, int N, int K, int splits,
          int pair_off = 0) {
  const int k_split = cdiv(cdiv(K, splits), kBK) * kBK;
  const int nz = cdiv(K, k_split);
  dim3 grid(PAIRED ? cdiv(pair_off, kBN / 2) : cdiv(N, kBN), cdiv(M, kBM), nz);
  gemm_kernel<AF, BtF, EP, PAIRED><<<grid, kThreads, 0, st>>>(a, bt, ep, M, N, K, k_split,
                                                              pair_off);
}

// the number of depth splits gemm() makes of K for `splits` requested
inline int n_splits(int K, int splits) {
  const int k_split = cdiv(cdiv(K, splits), kBK) * kBK;
  return cdiv(K, k_split);
}

struct Geometry {
  const int* dils;
  int nF, nA, maxd, up, B, T, F, R, S, AP;
  int L() const { return nF + nA; }
  int M() const { return B * T; }
  int K1() const { return 2 * R + AP; }
};

void past_rows(cudaStream_t st, const Geometry& g, int l, int* past, const float* d_frames) {
  past_rows_kernel<<<cdiv(g.M(), kEltThreads), kEltThreads, 0, st>>>(
      past, d_frames, g.B, g.T, g.F, g.up, g.dils[l], g.maxd, l >= g.nF);
}

template <class T>
void forward(cudaStream_t st, const Geometry& G, const T* o0, const T* h,
             const float* d_frames, const T* W_cat, const float* b_gate, const T* W_out,
             const float* b_res, T* oall, T* stv, T* o_out, float* skip, T* g, int* past) {
  const int M = G.M(), R = G.R, S = G.S, K1 = G.K1();
  const size_t act = (size_t)M * R;
  cudaMemcpyAsync(oall, o0, act * sizeof(T), cudaMemcpyDeviceToDevice, st);
  cudaMemsetAsync(skip, 0, (size_t)M * S * sizeof(float), st);
  for (int l = 0; l < G.L(); ++l) {
    const T* o = oall + l * act;
    T* o_next = l + 1 < G.L() ? oall + (l + 1) * act : o_out;
    T* st_l = stv + (size_t)l * M * 2 * R;
    past_rows(st, G, l, past, d_frames);
    GatherX<T> x{o, h, past, R, G.AP};
    Trans<RowMajor<T>> w{RowMajor<T>{W_cat + (size_t)l * K1 * 2 * R, 2 * R}};
    gemm<GatherX<T>, Trans<RowMajor<T>>, EpGate<T>, true>(
        st, x, w, EpGate<T>{b_gate + l * 2 * R, st_l, g, R}, M, 2 * R, K1, 1, R);
    Trans<RowMajor<T>> wo{RowMajor<T>{W_out + (size_t)l * R * (S + R), S + R}};
    gemm<RowMajor<T>, Trans<RowMajor<T>>, EpOut<T>, false>(
        st, RowMajor<T>{g, R}, wo, EpOut<T>{o, b_res + l * R, o_next, skip, R, S}, M, S + R,
        R, 1);
  }
}

template <class T>
void colsum(cudaStream_t st, const T* x, int M, int N, float* part, float* out) {
  const int rpc = cdiv(M, kColsumChunks);
  const int chunks = cdiv(M, rpc);
  colsum_kernel<T><<<dim3(cdiv(N, kEltThreads), chunks), kEltThreads, 0, st>>>(x, M, N, rpc,
                                                                               part);
  reduce_parts_kernel<<<cdiv(N, kEltThreads), kEltThreads, 0, st>>>(part, chunks, N, out);
}

template <class T>
void backward(cudaStream_t st, const Geometry& G, const float* do_in, const float* dskip,
              const T* oall, const T* stv, const T* h, const float* d_frames, const T* W_cat,
              const T* W_out, float* dwork, float* dh, float* dW_cat, float* db_gate,
              float* dW_out, float* db_res, T* dz, float* dx, float* part, int* past,
              int splits) {
  const int M = G.M(), R = G.R, S = G.S, K1 = G.K1(), AP = G.AP;
  const size_t act = (size_t)M * R;
  cudaMemcpyAsync(dwork, do_in, act * sizeof(float), cudaMemcpyDeviceToDevice, st);
  cudaMemsetAsync(dh, 0, (size_t)M * AP * sizeof(float), st);
  for (int i = G.L() - 1; i >= 0; --i) {
    const T* o = oall + i * act;
    const T* st_i = stv + (size_t)i * M * 2 * R;
    const T* Wc = W_cat + (size_t)i * K1 * 2 * R;
    const T* Wo = W_out + (size_t)i * R * (S + R);
    colsum<float>(st, dwork, M, R, part, db_res + i * R);
    // dW_out = g^T @ [dskip | do], split over rows, partial sums added in order
    {
      const size_t count = (size_t)R * (S + R);
      gemm<Trans<GateG<T>>, Trans<DOut<T>>, EpStore, false>(
          st, Trans<GateG<T>>{GateG<T>{st_i, R}}, Trans<DOut<T>>{DOut<T>{dskip, dwork, S, R}},
          EpStore{part, S + R, count}, R, S + R, M, splits);
      const int nz = n_splits(M, splits);
      reduce_parts_kernel<<<cdiv((long)count, kEltThreads), kEltThreads, 0, st>>>(
          part, nz, count, dW_out + (size_t)i * count);
    }
    // dg = [dskip | do] @ W_out^T -> dz
    gemm<DOut<T>, RowMajor<T>, EpGateGrad<T>, false>(
        st, DOut<T>{dskip, dwork, S, R}, RowMajor<T>{Wo, S + R}, EpGateGrad<T>{st_i, dz, R}, M,
        R, S + R, 1);
    colsum<T>(st, dz, M, 2 * R, part, db_gate + i * 2 * R);
    // dx = dz @ [W_in; W_aux]^T
    gemm<RowMajor<T>, RowMajor<T>, EpStore, false>(
        st, RowMajor<T>{dz, 2 * R}, RowMajor<T>{Wc, 2 * R}, EpStore{dx, K1, 0}, M, K1, 2 * R, 1);
    // [dW_in; dW_aux] = [o | past | h]^T @ dz
    past_rows(st, G, i, past, d_frames);
    {
      const size_t count = (size_t)K1 * 2 * R;
      gemm<Trans<GatherX<T>>, Trans<RowMajor<T>>, EpStore, false>(
          st, Trans<GatherX<T>>{GatherX<T>{o, h, past, R, AP}},
          Trans<RowMajor<T>>{RowMajor<T>{dz, 2 * R}}, EpStore{part, 2 * R, count}, K1, 2 * R, M,
          splits);
      const int nz = n_splits(M, splits);
      reduce_parts_kernel<<<cdiv((long)count, kEltThreads), kEltThreads, 0, st>>>(
          part, nz, count, dW_cat + (size_t)i * count);
    }
    combine_kernel<<<cdiv((long)act, kEltThreads), kEltThreads, 0, st>>>(
        dwork, dh, dx, d_frames, G.B, G.T, G.F, R, AP, G.up, G.dils[i], G.maxd, i >= G.nF);
  }
}

}  // namespace

extern "C" {

// Floats of the `part` scratch the backward needs.
long long qp_train_part_floats(int B, int T, int R, int S, int AP, int splits) {
  const int M = B * T;
  const long long K1 = 2 * R + AP;
  const long long nz = n_splits(M, splits);
  long long n = nz * K1 * 2 * R;
  const long long a = nz * (long long)R * (S + R);
  const long long c = (long long)kColsumChunks * 2 * R;
  if (a > n) n = a;
  if (c > n) n = c;
  return n;
}

int qp_train_fwd(const void* o0, const void* h, const float* d_frames, const void* W_cat,
                 const float* b_gate, const void* W_out, const float* b_res, void* oall,
                 void* st, void* o_out, float* skip, void* g, int* past, const int* dils,
                 int nF, int nA, int maxd, int up, int B, int T, int F, int R, int S, int AP,
                 int is_bf16, void* stream) {
  cudaGetLastError();
  const Geometry G{dils, nF, nA, maxd, up, B, T, F, R, S, AP};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    forward<bf16>(s, G, (const bf16*)o0, (const bf16*)h, d_frames, (const bf16*)W_cat, b_gate,
                  (const bf16*)W_out, b_res, (bf16*)oall, (bf16*)st, (bf16*)o_out, skip,
                  (bf16*)g, past);
  else
    forward<float>(s, G, (const float*)o0, (const float*)h, d_frames, (const float*)W_cat,
                   b_gate, (const float*)W_out, b_res, (float*)oall, (float*)st,
                   (float*)o_out, skip, (float*)g, past);
  return (int)cudaGetLastError();
}

int qp_train_bwd(const float* do_in, const float* dskip, const void* oall, const void* st,
                 const void* h, const float* d_frames, const void* W_cat, const void* W_out,
                 float* dwork, float* dh, float* dW_cat, float* db_gate, float* dW_out,
                 float* db_res, void* dz, float* dx, float* part, int* past, const int* dils,
                 int nF, int nA, int maxd, int up, int B, int T, int F, int R, int S, int AP,
                 int is_bf16, int splits, void* stream) {
  cudaGetLastError();
  const Geometry G{dils, nF, nA, maxd, up, B, T, F, R, S, AP};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    backward<bf16>(s, G, do_in, dskip, (const bf16*)oall, (const bf16*)st, (const bf16*)h,
                   d_frames, (const bf16*)W_cat, (const bf16*)W_out, dwork, dh, dW_cat, db_gate,
                   dW_out, db_res, (bf16*)dz, dx, part, past, splits);
  else
    backward<float>(s, G, do_in, dskip, (const float*)oall, (const float*)st, (const float*)h,
                    d_frames, (const float*)W_cat, (const float*)W_out, dwork, dh, dW_cat,
                    db_gate, dW_out, db_res, (float*)dz, dx, part, past, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
