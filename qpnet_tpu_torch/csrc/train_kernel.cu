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
// 12-layer step.  The activations saved for the backward (oall, st: 3R
// values per row and layer) are 2.2 GB at f32, 0.66 ms of HBM time, so the
// bound is set by operations: bf16 at the tensor cores' 989 TFLOP/s, f32 as
// three TF32 products per product at 495 / 3 TFLOP/s.
//
// Design.  The TPU kernel tiles time so that weights fit in VMEM and
// carries dilated history and scatter windows between tiles; on the card
// the whole sequence's activations sit in HBM, so each product is one
// launch over all rows, a block per 128 x 128 output tile.  Operands come
// into shared memory as 128 x 32 tiles through a ring of cp.async stages
// (16-byte copies, zero fill past the edges), one or two __syncthreads per
// 32-deep stage.  An operand is a row-major matrix of up to three column
// segments (`Mat`): that serves the concatenation [o | past | h], whose
// past segment reads each row's look-back row (computed in the loader: no
// row table), and [dskip | do].  The forward reads transposed weights from
// the wrapper, so every product but the weight gradients has the depth
// contiguous in both operands.  The tensor cores multiply from shared
// memory:
//   bf16: wgmma.mma_async m64n128k16 (two warpgroups of 64 rows) from
//   tiles in wgmma's 64-byte-swizzled layouts, in either major order, so
//   the weight-gradient products g^T @ .. and X^T @ dz need no transposed
//   copy; 6 stages, the products of two in flight;
//   f32: split TF32, each operand x = hi + lo with hi = tf32(x) and lo =
//   tf32(x - hi), each product a * b as lo_a hi_b + hi_a lo_b + hi_a hi_b
//   summed in f32, which keeps the error near f32's own (the dropped
//   lo_a lo_b is below 2^-22 of |a b|): on wgmma m64n128k8 from 128-byte-
//   swizzled tiles split in shared memory where the depth is contiguous,
//   and on mma.sync m16n8k8 (16 warps of 32 x 32, split in registers) for
//   the weight gradients, since wgmma takes TF32 operands only with the
//   depth contiguous.
// The epilogues work on the accumulator fragments: the gate's weight
// columns are interleaved by the wrapper (tile p holds columns [64p, 64p +
// 64) of the s half next to the same columns of the t half), so a thread
// holds z_s and z_t of the same (m, j); out adds the skip and residual; the
// backward's dg epilogue runs the gate derivative.  The backward rebuilds g
// and rounds do to bf16 in one elementwise pass a layer (dskip once per
// call), so every product reads plain tiles.
//
// Determinism: every output element is summed by one thread's products in
// a fixed order.  Weight gradients (sums over all B*T rows) are split over a fixed
// number of row ranges whose partial sums are added in order by a second
// kernel, and the bias gradients likewise; the adaptive layers' scatter is
// written as a gather over the frames that can reach each row.  No float
// atomics: two calls on the same inputs give the same bits.
//
// bf16 storage points are the TPU kernel's: st, g and o' rounded from f32
// (__float2bfloat16_rn); in the backward g = bf16(s * t) from the stored
// s, t, [dskip | do] rounded before each product, and the gate derivative
// chain rounded after every multiply and subtract.  The file is built with
// -fmad=false (shared with gen_kernel.cu): the epilogues round every
// multiply and add as the twin does; the mma products are not affected.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC.  C entry points qp_train_fwd and qp_train_bwd
//        return a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBM = 128;       // block tile rows
constexpr int kBN = 128;       // block tile columns
constexpr int kBK = 32;        // depth per pipeline stage
constexpr int kColsumChunks = 128;
constexpr int kEltThreads = 256;

// Shared-memory tiles of 128 x 32 (rows along M or N: the depth is
// contiguous) or 32 x 128 (rows along the depth: M or N contiguous),
// copied in 16-byte chunks.  Where wgmma reads a tile, it is in one of
// wgmma's canonical swizzled layouts, whose 16-byte chunk c of row r (in
// an atom of 8 rows) sits at chunk c ^ (r-bits):
//   bf16, 64-byte swizzle: atoms of 8 rows of 64 bytes, chunk c ^ ((r >> 1)
//   & 3).  Depth contiguous: atom i holds rows [8i, 8i + 8).  M or N
//   contiguous: a row is 32 M or N indices of one depth index, and the atom
//   of depth rows [8d, 8d + 8) and indices [32c, 32c + 32) sits at 2048 c +
//   512 d bytes.
//   f32 with the depth contiguous, 128-byte swizzle: atoms of 8 rows of 128
//   bytes, chunk c ^ (r & 7).
// f32 with M or N contiguous (mma.sync reads it): row-major, rows padded
// to kLdMN = 136 floats, so the rows a fragment load reads lie in distinct
// banks.
constexpr int kLdMN = kBM + 8;
template <class T, bool kK>
__host__ __device__ constexpr int tile_elems() {
  return sizeof(T) == 2 || kK ? kBM * kBK : kBK * kLdMN;
}
// offset of the chunk at row rr, column cc of a tile
template <class T, bool kK>
__device__ __forceinline__ int tile_at(int rr, int cc) {
  if constexpr (sizeof(T) == 2) {
    const int chunk = ((cc >> 3) & 3) ^ ((rr >> 1) & 3);
    const int atom = kK ? (rr >> 3) * 256 : (cc >> 5) * 1024 + (rr >> 3) * 256;
    return atom + (rr & 7) * 32 + chunk * 8;
  } else if constexpr (kK) {
    return (rr >> 3) * 256 + (rr & 7) * 32 + (((cc >> 2) ^ (rr & 7)) << 2);
  } else {
    return rr * kLdMN + cc;
  }
}
// rings are aligned to 1024 bytes: the swizzles work on address bits
constexpr int kSmemAlign = 1024;

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

// two adjacent elements
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; valid = false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo with hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

// wgmma descriptor of a tile in shared memory: start address (16-byte
// units), leading offset, stride offset, swizzle mode.  bf16 (64-byte
// swizzle): depth contiguous (kK), stride 512 bytes between 8-row atoms
// (the leading offset is unused); else leading offset 2048 bytes between
// atoms along M or N and stride 512 bytes between atoms along the depth.
// f32 (depth contiguous, 128-byte swizzle): stride 1024 bytes.
template <class T, bool kK>
__device__ __forceinline__ uint64_t gmma_desc(const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  const uint64_t lead = sizeof(T) == 2 && !kK ? 2048 >> 4 : 1;
  const uint64_t stride = sizeof(T) == 2 ? 512 >> 4 : 1024 >> 4;
  const uint64_t swizzle = sizeof(T) == 2 ? 2 : 1;
  return (uint64_t)((a >> 4) & 0x3FFF) | (lead << 16) | (stride << 32) | (swizzle << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// cp.async's writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// keeps the compiler from moving reads or writes of v across the
// asynchronous products
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// d (64 x 128, f32, one warpgroup) += a (64 x 16, bf16) * b (16 x 128,
// bf16) from shared memory; kTA / kTB: a / b stored with M / N contiguous
// (1) or the depth contiguous (0)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, %67, %68, %69, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1), "n"(1), "n"(1), "n"(kTA), "n"(kTB));
}

// d (64 x 128, f32, one warpgroup) = a (64 x 8, tf32) * b (8 x 128, tf32)
// + (accumulate ? d : 0), both stored with the depth contiguous
__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// operands
// ---------------------------------------------------------------------------

__device__ __forceinline__ int look_back(const float* d_frames, int b, int t, int F,
                                         int up, int dil, int maxd) {
  const int r = __float2int_rn(d_frames[(size_t)b * F + t / up] * (float)dil);
  return min(max(r, 0), maxd * dil);
}

// the row a layer's past input comes from
struct Past {
  const float* d_frames;
  int T, F, up, dil, maxd, adaptive;
  // row m's look-back row, or -1 for zero fill
  __device__ __forceinline__ int row(int m) const {
    const int b = m / T, t = m - b * T;
    if (!adaptive) return t >= dil ? m - dil : -1;
    return b * T + max(t - look_back(d_frames, b, t, F, up, dil, maxd), 0);
  }
};

// A row-major matrix whose columns [0, c1) come from p0, [c1, c2) from p1
// and [c2, ..) from p2, each with its own row pitch; with `shifted`,
// segment 1 reads each row's look-back row.  Segment starts are multiples
// of 8, so no 16-byte chunk straddles two.
template <class T>
struct Mat {
  const T* p0;
  const T* p1;
  const T* p2;
  int ld0, ld1, ld2;
  int c1, c2;
  int shifted;
  Past past;
  // row r's look-back row (r itself on an unshifted matrix), -1 for zeros
  __device__ __forceinline__ int past_of(int r) const { return shifted ? past.row(r) : r; }
  // address of element (r, c) given pr = past_of(r), or nullptr for a zero
  __device__ __forceinline__ const T* at(int r, int c, int pr) const {
    if (c < c1) return p0 + (size_t)r * ld0 + c;
    if (c < c2) return pr < 0 ? nullptr : p1 + (size_t)pr * ld1 + (c - c1);
    return p2 + (size_t)r * ld2 + (c - c2);
  }
};

template <class T>
Mat<T> plain(const T* p, int ldm) {
  return Mat<T>{p, p, p, ldm, ldm, ldm, INT_MAX, INT_MAX, 0, Past{}};
}
template <class T>
Mat<T> two(const T* p0, int ld0, const T* p1, int ld1, int c1) {
  return Mat<T>{p0, p1, p1, ld0, ld1, ld1, c1, INT_MAX, 0, Past{}};
}
// [o | past(o) | h] of one layer
template <class T>
Mat<T> gathered(const T* o, const T* h, int R, int AP, Past past) {
  return Mat<T>{o, o, h, R, R, AP, R, 2 * R, 1, past};
}

// A tile's box of `op` at (r0, c0), rows along M or N (kK) or along the
// depth, zero outside [0, r_end) x [0, c_end), copied by kThreads threads,
// kPer chunks each; with kCached, prow[i] holds past_of() of chunk i's row
// (a box whose rows stay the same from one depth step to the next).
template <class T, bool kK, int kThreads> struct Box {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kRows = kK ? kBM : kBK, kCols = kK ? kBK : kBM;
  static constexpr int kCpr = kCols / kVec;
  static constexpr int kPer = kRows * kCpr / kThreads;
  static_assert(kRows * kCpr % kThreads == 0, "chunks per thread");
  // (row, column) of chunk i
  __device__ __forceinline__ static int2 rc(int i) {
    const int id = (int)threadIdx.x + i * kThreads;
    if constexpr (sizeof(T) == 2 && !kK) {
      // a warp copies 8 rows x 4 chunks: 64 bytes of each of 8 rows, into
      // one 512-byte atom
      static_assert(kRows == 32 && kCpr == 16, "bf16 depth-row box");
      const int lane = id & 31, w = id >> 5;
      return make_int2(((w & 3) << 3) | (lane & 7), (((w >> 2) << 2) | (lane >> 3)) * 8);
    }
    return make_int2(id / kCpr, id % kCpr * kVec);
  }
};

template <class T, bool kK, int kThreads, bool kCached, int kN>
__device__ __forceinline__ void load_box(const Mat<T>& op, T* sm, int r0, int c0, int r_end,
                                         int c_end, const int (&prow)[kN]) {
  using Bx = Box<T, kK, kThreads>;
#pragma unroll
  for (int i = 0; i < Bx::kPer; ++i) {
    const int2 p = Bx::rc(i);
    const int r = r0 + p.x, c = c0 + p.y;
    const T* src = nullptr;
    if (r < r_end && c < c_end) {
      int pr = r;
      if constexpr (kCached) pr = prow[i];
      else if (c >= op.c1 && c < op.c2) pr = op.past_of(r);
      src = op.at(r, c, pr);
    }
    cp_async16(sm + tile_at<T, kK>(p.x, p.y), src ? src : op.p0, src != nullptr);
  }
}

// ---------------------------------------------------------------------------
// the product: C (M x N) = A (M x K) @ B (K x N) over the depth range of
// split blockIdx.z.  kAK: A's tile rows run along M (A is an M x K
// row-major Mat), else along the depth (a K x M Mat, A = its transpose).
// kBKc: B's tile rows run along N (an N x K Mat, B = its transpose), else
// along the depth (a K x N Mat).  Each thread holds kFrags accumulator
// fragments of 2 rows x 2 columns: rows row(f) and row(f) + 8, columns
// col(f) and col(f) + 1.  kPaired: the B tile's columns [0, 64) and
// [64, 128) are the s and t halves of the same 64 gate columns, and
// fragment f of the s half (is_s(f)) meets its t partner f + kPartner in
// the same thread.  Epilogue: ep(m, n, v(m, n), v(m, n+1), split) per even
// n < N, or with kPaired ep(m, j, zs, zs', zt, zt') with j = 64 *
// blockIdx.x + col(f).
// ---------------------------------------------------------------------------

template <class T, bool kAK, bool kBKc, bool kPaired> struct Mma;

// Accumulator fragments of the wgmma bodies: warpgroup wg owns rows [64 wg,
// 64 wg + 64) of the block and all 128 columns, 16 fragments of 8 columns;
// fragment f of the s half meets f + 8 of the t half.
struct WgFrags {
  static constexpr int kFrags = 16, kPartner = 8, kThreads = 256;
  __device__ __forceinline__ static int row(int) {
    const int w = (int)threadIdx.x >> 5;
    return (w >> 2) * 64 + (w & 3) * 16 + (((int)threadIdx.x & 31) >> 2);
  }
  __device__ __forceinline__ static int col(int f) { return f * 8 + 2 * ((int)threadIdx.x & 3); }
  __device__ __forceinline__ static bool is_s(int f) { return f < 8; }
  __device__ __forceinline__ static void pin_all(float (&acc)[16][4]) {
#pragma unroll
    for (int f = 0; f < 16; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(acc[f][e]);
  }
};

// bf16: wgmma from a ring of kS stages, copies kS - 2 stages ahead, the
// products of up to two stages in flight (a stage is overwritten once the
// products that read it are done).
template <bool kAK, bool kBKc, bool kPaired>
struct Mma<bf16, kAK, kBKc, kPaired> : WgFrags {
  static constexpr int kS = 6, kAE = tile_elems<bf16, kAK>(), kBE = tile_elems<bf16, kBKc>();
  static constexpr int kSmem = kS * (kAE + kBE) * 2 + kSmemAlign;
  template <class Load>
  __device__ __forceinline__ static void mainloop(float (&acc)[16][4], const Load& load, int nk,
                                                  bf16* sm) {
    constexpr int kAhead = kS - 2;
    bf16* sA = sm;
    bf16* sB = sm + kS * kAE;
    const int wg = (int)threadIdx.x >> 7;
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      if (s < nk) load(sA + s * kAE, sB + s * kBE, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kAhead - 1>();
      fence_async_smem();
      wgmma_wait<1>();
      __syncthreads();
      const int s = kt % kS;
      pin_all(acc);
      wgmma_fence();
      // a 16-deep step starts 32 bytes into a row (depth contiguous) or two
      // atoms on along the depth (1024 bytes); warpgroup wg's 64 rows start
      // 8 atoms (4096 bytes) on either way
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        wgmma_bf16<kAK ? 0 : 1, kBKc ? 0 : 1>(
            acc, gmma_desc<bf16, kAK>(sA + s * kAE + wg * 2048 + ks * (kAK ? 16 : 512)),
            gmma_desc<bf16, kBKc>(sB + s * kBE + ks * (kBKc ? 16 : 512)));
      wgmma_commit();
      pin_all(acc);
      const int nt = kt + kAhead;
      if (nt < nk) load(sA + nt % kS * kAE, sB + nt % kS * kBE, nt);
      cp_async_commit();
    }
    wgmma_wait<0>();
    pin_all(acc);
  }
};

// f32, depth contiguous in both operands: split TF32 on wgmma.  Each stage,
// once copied, is split in place, x -> hi = tf32(x), and into a second
// buffer, lo = tf32(x - hi), while the products of the stage before run;
// then lo_a hi_b + hi_a lo_b + hi_a hi_b, 12 m64n128k8 products, sum into
// one of two `part` accumulators (the first product overwrites it), which
// is added to acc once they are done, two stages on.  The tensor cores add
// with truncation, so summing a whole 1072-deep product in place would
// drift by hundreds of ulps; each stage's part joins acc in one
// IEEE-rounded add, in order.
template <bool kPaired>
struct Mma<float, true, true, kPaired> : WgFrags {
  static constexpr int kS = 4, kE = tile_elems<float, true>();
  static constexpr int kSmem = (kS + 2) * 2 * kE * 4 + kSmemAlign;
  __device__ __forceinline__ static void split(float* raw, float* lo) {
#pragma unroll
    for (int i = 0; i < 2 * kE / 4 / kThreads; ++i) {
      const int e = 4 * ((int)threadIdx.x + i * kThreads);
      float4 x = *reinterpret_cast<float4*>(raw + e), l;
      uint32_t h, q;
#define K2_SPLIT(c)                          \
  split_tf32(x.c, h, q);                     \
  x.c = __uint_as_float(h);                  \
  l.c = __uint_as_float(q);
      K2_SPLIT(x) K2_SPLIT(y) K2_SPLIT(z) K2_SPLIT(w)
#undef K2_SPLIT
      *reinterpret_cast<float4*>(raw + e) = x;
      *reinterpret_cast<float4*>(lo + e) = l;
    }
  }
  // the products of one stage: stage A at a, B at a + kE, their lo parts
  // at l, l + kE
  __device__ __forceinline__ static void products(float (&part)[16][4], const float* a,
                                                  const float* l) {
    const int wg = (int)threadIdx.x >> 7;
    pin_all(part);
    wgmma_fence();
    // an 8-deep step starts 32 bytes into a row; warpgroup wg's 64 rows
    // start 8 atoms (8192 bytes) on
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const uint64_t ah = gmma_desc<float, true>(a + wg * 2048 + ks * 8);
      const uint64_t al = gmma_desc<float, true>(l + wg * 2048 + ks * 8);
      const uint64_t bh = gmma_desc<float, true>(a + kE + ks * 8);
      const uint64_t bl = gmma_desc<float, true>(l + kE + ks * 8);
      wgmma_tf32(part, al, bh, ks > 0);
      wgmma_tf32(part, ah, bl, 1);
      wgmma_tf32(part, ah, bh, 1);
    }
    wgmma_commit();
    pin_all(part);
  }
  __device__ __forceinline__ static void add(float (&acc)[16][4], float (&part)[16][4]) {
#pragma unroll
    for (int f = 0; f < 16; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] = acc[f][e] + part[f][e];
  }
  // stage kt, whose part is p (holding stage kt - 2's until it is added)
  template <class Load>
  __device__ __forceinline__ static void stage(float (&acc)[16][4], float (&p)[16][4],
                                               const Load& load, int kt, int nk, float* sm) {
    constexpr int kAhead = kS - 2;
    float* lo = sm + kS * 2 * kE + (kt & 1) * 2 * kE;
    cp_async_wait<kAhead - 1>();
    wgmma_wait<1>();
    pin_all(p);
    if (kt >= 2) add(acc, p);
    __syncthreads();
    const int nt = kt + kAhead;
    if (nt < nk) load(sm + nt % kS * 2 * kE, sm + nt % kS * 2 * kE + kE, nt);
    cp_async_commit();
    split(sm + kt % kS * 2 * kE, lo);
    fence_async_smem();
    __syncthreads();
    products(p, sm + kt % kS * 2 * kE, lo);
  }
  template <class Load>
  __device__ __forceinline__ static void mainloop(float (&acc)[16][4], const Load& load, int nk,
                                                  float* sm) {
    float p0[16][4], p1[16][4];
#pragma unroll
    for (int s = 0; s < kS - 2; ++s) {
      if (s < nk) load(sm + s * 2 * kE, sm + s * 2 * kE + kE, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; kt += 2) {
      stage(acc, p0, load, kt, nk, sm);
      if (kt + 1 < nk) stage(acc, p1, load, kt + 1, nk, sm);
    }
    wgmma_wait<0>();
    pin_all(p0);
    pin_all(p1);
    // the last two stages' parts, in order
    if (nk & 1) {
      if (nk >= 2) add(acc, p1);
      add(acc, p0);
    } else {
      add(acc, p0);
      add(acc, p1);
    }
  }
};

// f32, M and N contiguous (the weight-gradient products): split TF32 on
// mma.sync m16n8k8 (wgmma takes TF32 operands only with the depth
// contiguous).  16 warps of 32 x 32: warp (wm, wn) owns rows [32 wm, 32 wm
// + 32) and columns [32 wn, 32 wn + 32); fragment f = 4 mf + nf.
template <>
struct Mma<float, false, false, false> {
  static constexpr int kMF = 2, kFrags = 4 * kMF, kThreads = 512;
  static constexpr int kS = 3, kE = tile_elems<float, false>();
  static constexpr int kSmem = kS * 2 * kE * 4 + kSmemAlign;
  __device__ __forceinline__ static int col_base(int q) {
    return (((int)threadIdx.x >> 5) & 3) * 32 + q * 16;
  }
  __device__ __forceinline__ static int row(int f) {
    const int wm = (int)threadIdx.x >> 7;
    return (wm * kMF + (f >> 2)) * 16 + (((int)threadIdx.x & 31) >> 2);
  }
  __device__ __forceinline__ static int col(int f) {
    return col_base((f & 3) >> 1) + (f & 1) * 8 + 2 * ((int)threadIdx.x & 3);
  }
  // The 12 mma of one stage sum into `part`, which joins acc in one
  // IEEE-rounded add (see the wgmma body).
  __device__ __forceinline__ static void step(float (&acc)[kFrags][4], const float* sa,
                                              const float* sb) {
    const int lane = (int)threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float part[kFrags][4];
#pragma unroll
    for (int f = 0; f < kFrags; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[f][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int n = col_base(nf >> 1) + (nf & 1) * 8 + g;
        split_tf32(sb[(ks + t) * kLdMN + n], bh[nf][0], bl[nf][0]);
        split_tf32(sb[(ks + t + 4) * kLdMN + n], bh[nf][1], bl[nf][1]);
      }
#pragma unroll
      for (int mf = 0; mf < kMF; ++mf) {
        const int m = row(4 * mf);
        uint32_t ah[4], al[4];
        split_tf32(sa[(ks + t) * kLdMN + m], ah[0], al[0]);
        split_tf32(sa[(ks + t) * kLdMN + m + 8], ah[1], al[1]);
        split_tf32(sa[(ks + t + 4) * kLdMN + m], ah[2], al[2]);
        split_tf32(sa[(ks + t + 4) * kLdMN + m + 8], ah[3], al[3]);
        // the three terms in turn: four independent sums between two
        // products into one accumulator
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) mma_tf32(part[4 * mf + nf], al, bh[nf]);
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) mma_tf32(part[4 * mf + nf], ah, bl[nf]);
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) mma_tf32(part[4 * mf + nf], ah, bh[nf]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFrags; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] = acc[f][e] + part[f][e];
  }
  template <class Load>
  __device__ __forceinline__ static void mainloop(float (&acc)[kFrags][4], const Load& load,
                                                  int nk, float* sm) {
    constexpr int kAhead = kS - 1;
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      if (s < nk) load(sm + s * 2 * kE, sm + s * 2 * kE + kE, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kAhead - 1>();
      __syncthreads();
      const int nt = kt + kAhead;
      if (nt < nk) load(sm + nt % kS * 2 * kE, sm + nt % kS * 2 * kE + kE, nt);
      cp_async_commit();
      const float* sa = sm + kt % kS * 2 * kE;
      step(acc, sa, sa + kE);
    }
  }
};

template <class T, bool kAK, bool kBKc, bool kPaired, class Ep>
__device__ __forceinline__ void gemm_body(const Mat<T>& a, const Mat<T>& b, const Ep& ep, int M,
                                          int N, int K, int k_split) {
  using Mm = Mma<T, kAK, kBKc, kPaired>;
  constexpr int kT = Mm::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t misalign = (uint32_t)__cvta_generic_to_shared(smem) & (kSmemAlign - 1);
  T* sm = reinterpret_cast<T*>(smem + ((kSmemAlign - misalign) & (kSmemAlign - 1)));
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);
  const int nk = (ke - kb + kBK - 1) / kBK;

  // an A box whose rows run along M keeps its rows: their look-back rows
  // are found once
  using BxA = Box<T, true, kT>;
  int prow[BxA::kPer];
#pragma unroll
  for (int i = 0; i < BxA::kPer; ++i) {
    const int r = m0 + BxA::rc(i).x;
    prow[i] = kAK && r < M ? a.past_of(r) : 0;
  }
  // copies stage kt of A into sa and of B into sb
  auto load = [&](T* sa, T* sb, int kt) {
    const int k0 = kb + kt * kBK;
    if constexpr (kAK)
      load_box<T, true, kT, true>(a, sa, m0, k0, M, ke, prow);
    else
      load_box<T, false, kT, false>(a, sa, k0, m0, ke, M, prow);
    if constexpr (kBKc)
      load_box<T, true, kT, false>(b, sb, n0, k0, N, ke, prow);
    else
      load_box<T, false, kT, false>(b, sb, k0, n0, ke, N, prow);
  };

  float acc[Mm::kFrags][4];
#pragma unroll
  for (int f = 0; f < Mm::kFrags; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  Mm::mainloop(acc, load, nk, sm);
  cp_async_wait<0>();

#pragma unroll
  for (int f = 0; f < Mm::kFrags; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + Mm::row(f) + h * 8;
      if (m >= M) continue;
      if constexpr (kPaired) {
        if (Mm::is_s(f)) {
          const float(&z)[4] = acc[(f + Mm::kPartner) % Mm::kFrags];
          ep(m, blockIdx.x * 64 + Mm::col(f), acc[f][2 * h], acc[f][2 * h + 1], z[2 * h],
             z[2 * h + 1]);
        }
      } else {
        const int n = n0 + Mm::col(f);
        if (n < N) ep(m, n, acc[f][2 * h], acc[f][2 * h + 1], (int)blockIdx.z);
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
  __device__ __forceinline__ void operator()(int m, int j, float zs0, float zs1, float zt0,
                                             float zt1) const {
    zs0 = zs0 + b_gate[j];
    zs1 = zs1 + b_gate[j + 1];
    zt0 = zt0 + b_gate[R + j];
    zt1 = zt1 + b_gate[R + j + 1];
    const float s0 = 1.f / (1.f + expf(-zs0)), s1 = 1.f / (1.f + expf(-zs1));
    const float t0 = tanhf(zt0), t1 = tanhf(zt1);
    T* row = st + (size_t)m * 2 * R;
    st2(row + j, s0, s1);
    st2(row + R + j, t0, t1);
    st2(g + (size_t)m * R + j, s0 * t0, s1 * t1);
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
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1, int) const {
    if (n < S) {
      float* p = skip + (size_t)m * S + n;
      const float2 s = ld2(p);
      st2(p, s.x + v0, s.y + v1);
    } else {
      const int c = n - S;
      const float2 x = ld2(o + (size_t)m * R + c);
      st2(o_next + (size_t)m * R + c, (x.x + v0) + b_res[c], (x.y + v1) + b_res[c + 1]);
    }
  }
};

// plain store: out[z][m * ldo + n] = acc
template <class T>
struct EpStore {
  float* out;
  int ldo;
  size_t split_stride;
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1, int z) const {
    st2(out + (size_t)z * split_stride + (size_t)m * ldo + n, v0, v1);
  }
};

// backward gate derivative: dg (rows x R) -> dz (rows x 2R), rounded to T
// after every operation, as the TPU kernel's compute-precision chain
template <class T>
struct EpGateGrad {
  const T* st;
  T* dz;
  int R;
  // (dz_s, dz_t) of one element
  __device__ __forceinline__ static float2 grad(float dg, float s, float t) {
    const float dgc = rnd<T>(dg);
    const float u = rnd<T>(dgc * s);
    float a = rnd<T>(dgc * t);
    a = rnd<T>(a * s);
    const float dzs = rnd<T>(a * rnd<T>(1.f - s));
    float b = rnd<T>(u * t);
    b = rnd<T>(b * t);
    return make_float2(dzs, rnd<T>(u - b));
  }
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1, int) const {
    const T* row = st + (size_t)m * 2 * R;
    const float2 s = ld2(row + n), t = ld2(row + R + n);
    const float2 d0 = grad(v0, s.x, t.x), d1 = grad(v1, s.y, t.y);
    T* out = dz + (size_t)m * 2 * R;
    st2(out + n, d0.x, d1.x);
    st2(out + R + n, d0.y, d1.y);
  }
};

// ---------------------------------------------------------------------------
// the products, one kernel each (names the profiler reports)
// ---------------------------------------------------------------------------

// Every product reads B as an N x K Mat (B's transpose) but the
// weight-gradient products, whose operands both have M or N contiguous.
// z = [o | past | h] @ W_gate (W_gate^T given, columns interleaved), gate
// epilogue
template <class T>
__global__ void __launch_bounds__((Mma<T, true, true, true>::kThreads))
k2_gate(Mat<T> a, Mat<T> b, EpGate<T> ep, int M, int N, int K, int k_split) {
  gemm_body<T, true, true, true>(a, b, ep, M, N, K, k_split);
}
// g @ W_out (W_out^T given), skip and residual
template <class T>
__global__ void __launch_bounds__((Mma<T, true, true, false>::kThreads))
k2_out(Mat<T> a, Mat<T> b, EpOut<T> ep, int M, int N, int K, int k_split) {
  gemm_body<T, true, true, false>(a, b, ep, M, N, K, k_split);
}
// row-contracting weight gradients: g^T @ [dskip | do], [o | past | h]^T @ dz
template <class T>
__global__ void __launch_bounds__((Mma<T, false, false, false>::kThreads))
k2_wgrad(Mat<T> a, Mat<T> b, EpStore<T> ep, int M, int N, int K, int k_split) {
  gemm_body<T, false, false, false>(a, b, ep, M, N, K, k_split);
}
// dg = [dskip | do] @ W_out^T, gate derivative
template <class T>
__global__ void __launch_bounds__((Mma<T, true, true, false>::kThreads))
k2_dgate(Mat<T> a, Mat<T> b, EpGateGrad<T> ep, int M, int N, int K, int k_split) {
  gemm_body<T, true, true, false>(a, b, ep, M, N, K, k_split);
}
// dx = dz @ [W_in; W_aux]^T
template <class T>
__global__ void __launch_bounds__((Mma<T, true, true, false>::kThreads))
k2_dx(Mat<T> a, Mat<T> b, EpStore<T> ep, int M, int N, int K, int k_split) {
  gemm_body<T, true, true, false>(a, b, ep, M, N, K, k_split);
}

// ---------------------------------------------------------------------------
// small kernels
// ---------------------------------------------------------------------------

// per backward layer, two elements a thread: g = T(s * t) from the stored
// gate activations (rows x R), and with do_c, do_c = T(do)
template <class T>
__global__ void bwd_prep_kernel(const T* st, const float* dout, T* g, T* do_c, int M, int R) {
  const size_t e = 2 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= (size_t)M * R) return;
  const size_t m = e / R, j = e % R;
  const T* row = st + m * 2 * R;
  const float2 s = ld2(row + j), t = ld2(row + R + j);
  st2(g + e, s.x * t.x, s.y * t.y);
  if (do_c) {
    const float2 d = ld2(dout + e);
    st2(do_c + e, d.x, d.y);
  }
}

// y = T(x)
template <class T>
__global__ void round_kernel(const float* x, T* y, size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) y[e] = from_f<T>(x[e]);
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

// the depth per split that gemm() uses for `splits` requested, and the
// number of splits it makes of K
inline int k_split_of(int K, int splits) { return cdiv(cdiv(K, splits), kBK) * kBK; }
inline int n_splits(int K, int splits) { return cdiv(K, k_split_of(K, splits)); }

template <class T, bool kAK, bool kBKc, bool kPaired, class Ep>
cudaError_t gemm(void (*kern)(Mat<T>, Mat<T>, Ep, int, int, int, int), cudaStream_t st,
                 const Mat<T>& a, const Mat<T>& b, const Ep& ep, int M, int N, int K,
                 int splits = 1) {
  using Mm = Mma<T, kAK, kBKc, kPaired>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Mm::kSmem);
  if (err != cudaSuccess) return err;
  const int k_split = k_split_of(K, splits);
  dim3 grid(cdiv(N, kBN), cdiv(M, kBM), cdiv(K, k_split));
  kern<<<grid, Mm::kThreads, Mm::kSmem, st>>>(a, b, ep, M, N, K, k_split);
  return cudaGetLastError();
}

struct Geometry {
  const int* dils;
  const float* d_frames;
  int nF, nA, maxd, up, B, T, F, R, S, AP;
  int L() const { return nF + nA; }
  int M() const { return B * T; }
  int K1() const { return 2 * R + AP; }
  Past past(int l) const { return Past{d_frames, T, F, up, dils[l], maxd, l >= nF}; }
};

#define K2_TRY(x)                         \
  do {                                    \
    const cudaError_t e_ = (x);           \
    if (e_ != cudaSuccess) return e_;     \
  } while (0)

// W_gate_t: per layer the transpose (2R x K1) of [W_in; W_aux] with its
// columns interleaved; W_out_t: per layer W_out's transpose ((S+R) x R)
template <class T>
cudaError_t forward(cudaStream_t st, const Geometry& G, const T* o0, const T* h,
                    const T* W_gate_t, const float* b_gate, const T* W_out_t,
                    const float* b_res, T* oall, T* stv, T* o_out, float* skip, T* g) {
  const int M = G.M(), R = G.R, S = G.S, K1 = G.K1();
  const size_t act = (size_t)M * R;
  K2_TRY(cudaMemcpyAsync(oall, o0, act * sizeof(T), cudaMemcpyDeviceToDevice, st));
  K2_TRY(cudaMemsetAsync(skip, 0, (size_t)M * S * sizeof(float), st));
  for (int l = 0; l < G.L(); ++l) {
    const T* o = oall + l * act;
    T* o_next = l + 1 < G.L() ? oall + (l + 1) * act : o_out;
    T* st_l = stv + (size_t)l * M * 2 * R;
    K2_TRY((gemm<T, true, true, true>(k2_gate<T>, st, gathered(o, h, R, G.AP, G.past(l)),
                                      plain(W_gate_t + (size_t)l * 2 * R * K1, K1),
                                      EpGate<T>{b_gate + l * 2 * R, st_l, g, R}, M, 2 * R,
                                      K1)));
    K2_TRY((gemm<T, true, true, false>(k2_out<T>, st, plain<T>(g, R),
                                       plain(W_out_t + (size_t)l * (S + R) * R, R),
                                       EpOut<T>{o, b_res + l * R, o_next, skip, R, S}, M,
                                       S + R, R)));
  }
  return cudaSuccess;
}

template <class T>
void colsum(cudaStream_t st, const T* x, int M, int N, float* part, float* out) {
  const int rpc = cdiv(M, kColsumChunks);
  const int chunks = cdiv(M, rpc);
  colsum_kernel<T><<<dim3(cdiv(N, kEltThreads), chunks), kEltThreads, 0, st>>>(x, M, N, rpc,
                                                                               part);
  reduce_parts_kernel<<<cdiv(N, kEltThreads), kEltThreads, 0, st>>>(part, chunks, N, out);
}

// do_c, dskip_c: bf16 copies of do and dskip (unused in f32, where the
// products read the f32 inputs)
template <class T>
cudaError_t backward(cudaStream_t st, const Geometry& G, const float* do_in, const float* dskip,
                     const T* oall, const T* stv, const T* h, const T* W_cat, const T* W_out,
                     float* dwork, float* dh, float* dW_cat, float* db_gate, float* dW_out,
                     float* db_res, T* dz, float* dx, float* part, T* g, T* do_c, T* dskip_c,
                     int splits) {
  const int M = G.M(), R = G.R, S = G.S, K1 = G.K1(), AP = G.AP;
  const size_t act = (size_t)M * R;
  const bool f32 = sizeof(T) == 4;
  K2_TRY(cudaMemcpyAsync(dwork, do_in, act * sizeof(float), cudaMemcpyDeviceToDevice, st));
  K2_TRY(cudaMemsetAsync(dh, 0, (size_t)M * AP * sizeof(float), st));
  if (!f32)
    round_kernel<T><<<cdiv((long)M * S, kEltThreads), kEltThreads, 0, st>>>(dskip, dskip_c,
                                                                            (size_t)M * S);
  // [dskip | do] in the compute type
  const Mat<T> dout = f32 ? two(reinterpret_cast<const T*>(dskip), S,
                                reinterpret_cast<const T*>(dwork), R, S)
                          : two<T>(dskip_c, S, do_c, R, S);
  for (int i = G.L() - 1; i >= 0; --i) {
    const T* o = oall + i * act;
    const T* st_i = stv + (size_t)i * M * 2 * R;
    const T* Wc = W_cat + (size_t)i * K1 * 2 * R;
    const T* Wo = W_out + (size_t)i * R * (S + R);
    colsum<float>(st, dwork, M, R, part, db_res + i * R);
    bwd_prep_kernel<T><<<cdiv((long)act / 2, kEltThreads), kEltThreads, 0, st>>>(
        st_i, dwork, g, f32 ? nullptr : do_c, M, R);
    // dW_out = g^T @ [dskip | do], split over rows, partial sums added in order
    {
      const size_t count = (size_t)R * (S + R);
      K2_TRY((gemm<T, false, false, false>(k2_wgrad<T>, st, plain<T>(g, R), dout,
                                    EpStore<T>{part, S + R, count}, R, S + R, M, splits)));
      reduce_parts_kernel<<<cdiv((long)count, kEltThreads), kEltThreads, 0, st>>>(
          part, n_splits(M, splits), count, dW_out + (size_t)i * count);
    }
    // dg = [dskip | do] @ W_out^T -> dz
    K2_TRY((gemm<T, true, true, false>(k2_dgate<T>, st, dout, plain(Wo, S + R),
                                EpGateGrad<T>{st_i, dz, R}, M, R, S + R)));
    colsum<T>(st, dz, M, 2 * R, part, db_gate + i * 2 * R);
    // dx = dz @ [W_in; W_aux]^T
    K2_TRY((gemm<T, true, true, false>(k2_dx<T>, st, plain<T>(dz, 2 * R), plain(Wc, 2 * R),
                                EpStore<T>{dx, K1, 0}, M, K1, 2 * R)));
    // [dW_in; dW_aux] = [o | past | h]^T @ dz
    {
      const size_t count = (size_t)K1 * 2 * R;
      K2_TRY((gemm<T, false, false, false>(k2_wgrad<T>, st, gathered(o, h, R, AP, G.past(i)),
                                    plain<T>(dz, 2 * R), EpStore<T>{part, 2 * R, count}, K1,
                                    2 * R, M, splits)));
      reduce_parts_kernel<<<cdiv((long)count, kEltThreads), kEltThreads, 0, st>>>(
          part, n_splits(M, splits), count, dW_cat + (size_t)i * count);
    }
    combine_kernel<<<cdiv((long)act, kEltThreads), kEltThreads, 0, st>>>(
        dwork, dh, dx, G.d_frames, G.B, G.T, G.F, R, AP, G.up, G.dils[i], G.maxd, i >= G.nF);
  }
  return cudaGetLastError();
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

// W_gate_t: per layer the transpose of [W_in; W_aux] with its columns
// interleaved in tiles of 128 (columns [64p, 64p + 64) of the s half, then
// the same of the t half); W_out_t: per layer the transpose of W_out
int qp_train_fwd(const void* o0, const void* h, const float* d_frames, const void* W_gate_t,
                 const float* b_gate, const void* W_out_t, const float* b_res, void* oall,
                 void* st, void* o_out, float* skip, void* g, const int* dils, int nF, int nA,
                 int maxd, int up, int B, int T, int F, int R, int S, int AP, int is_bf16,
                 void* stream) {
  cudaGetLastError();
  const Geometry G{dils, d_frames, nF, nA, maxd, up, B, T, F, R, S, AP};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)forward<bf16>(s, G, (const bf16*)o0, (const bf16*)h, (const bf16*)W_gate_t,
                              b_gate, (const bf16*)W_out_t, b_res, (bf16*)oall, (bf16*)st,
                              (bf16*)o_out, skip, (bf16*)g);
  return (int)forward<float>(s, G, (const float*)o0, (const float*)h, (const float*)W_gate_t,
                             b_gate, (const float*)W_out_t, b_res, (float*)oall, (float*)st,
                             (float*)o_out, skip, (float*)g);
}

int qp_train_bwd(const float* do_in, const float* dskip, const void* oall, const void* st,
                 const void* h, const float* d_frames, const void* W_cat, const void* W_out,
                 float* dwork, float* dh, float* dW_cat, float* db_gate, float* dW_out,
                 float* db_res, void* dz, float* dx, float* part, void* g, void* do_c,
                 void* dskip_c, const int* dils, int nF, int nA, int maxd, int up, int B, int T,
                 int F, int R, int S, int AP, int is_bf16, int splits, void* stream) {
  cudaGetLastError();
  const Geometry G{dils, d_frames, nF, nA, maxd, up, B, T, F, R, S, AP};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)backward<bf16>(s, G, do_in, dskip, (const bf16*)oall, (const bf16*)st,
                               (const bf16*)h, (const bf16*)W_cat, (const bf16*)W_out, dwork, dh,
                               dW_cat, db_gate, dW_out, db_res, (bf16*)dz, dx, part, (bf16*)g,
                               (bf16*)do_c, (bf16*)dskip_c, splits);
  return (int)backward<float>(s, G, do_in, dskip, (const float*)oall, (const float*)st,
                              (const float*)h, (const float*)W_cat, (const float*)W_out, dwork,
                              dh, dW_cat, db_gate, dW_out, db_res, (float*)dz, dx, part,
                              (float*)g, nullptr, nullptr, splits);
}

}  // extern "C"
