// What CAMERA's two AGSA kernels share, and the tensor-core pieces of the
// backward in fp32.  Both kernels (csrc/agsa_attn.cu, the forward, and
// csrc/agsa_attn_bwd.cu) take the conversions and rounding points (to_f,
// from_f, rnd), the sigmoid, a head's rows staged by 16-byte cp.async
// (stage_rows, head_base, row_ld), the gate weights' pointers (Gates) and the
// launch-plan cache from here; the forward runs on fp32 FMAs and uses none
// of the products below.  The backward's fp32 pieces: the products of one
// warp's 16-row tile and the gate chain.
//
// A warp owns 16 rows of one head (rows r0 .. r0 + 15; a head of N rows has
// ceil(N / 16) such tiles, one warp each).  Its values live in registers in
// mma.sync's accumulator layout: x[n][0..3] holds rows g and g + 8 (g = lane
// / 4) at columns 8n + 2t and 8n + 2t + 1 (t = lane % 4), in the order
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  Every product runs on
// the tensor cores, mma.sync m16n8k8 in TF32, three passes: x = hi + lo with
// hi = x with its low 13 mantissa bits cleared and lo the same of x - hi,
// and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32 (the a_lo b_lo term is
// ~2^-22 of the product).  In a k8 step, a thread's A values are (g, 2t),
// (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) of the step's 8 columns, its B
// values rows 2t and 2t + 1: the product's depth is permuted (logical t <->
// 2t, t + 4 <-> 2t + 1) on both operands alike, so that an accumulator tile
// is the A operand of the next product as it stands (flash attention's
// reuse) and a row's two values come in one 8-byte load.
// Operands in shared memory: row-major arrays of R = 16 x tiles rows, rows
// padded to LD floats (the head's d_k columns padded with zeros to the
// kernel's width class DK, then 4 floats, so that the column reads of two
// rows 2t apart hit distinct banks).  The (d_k, d_k) weights' B fragments
// are split once a block into shared memory where they fit (d_k <= 32),
// else read from global memory (held in L1), so every d_k up to 128 takes
// the same code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <mutex>
#include <type_traits>

namespace agsa {

constexpr int kMaxN = 64;
constexpr int kMaxDk = 128;
constexpr int kMaxTiles = kMaxN / 16;  // 16-row tiles a head, warps a block
constexpr int kKeyTiles = kMaxN / 8;   // 8-key tiles of a score row
constexpr int kSmemMax = 232448;       // 227 KB, the most a block may use
constexpr unsigned kTf32Mask = 0xffffe000u;

// A loop over a tile's column groups (NT of them, 8 columns each, in scope):
// unrolled for d_k <= 32, where the tile lives in registers; past that a
// plain loop over a tile in local memory, which keeps the build of the
// widest class (d_k 128, a correctness path) to seconds
#define AGSA_PRAGMA(x) _Pragma(#x)
#define AGSA_UNROLL_COLS AGSA_PRAGMA(unroll(NT <= 4 ? 16 : 1))

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round to T and back: the TPU kernel's casts to the compute dtype
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float sigmoid_f(float z) { return 1.0f / (1.0f + expf(-z)); }

// elements of a staged row: DK columns and the padding
template <typename T, int DK>
__host__ __device__ constexpr int row_ld() { return std::is_same<T, float>::value ? DK + 4 : DK + 8; }
// elements of a row of the N x N score arrays (R keys and the padding)
template <typename T>
__host__ __device__ inline int score_ld(int rows) {
  return std::is_same<T, float>::value ? rows + 4 : rows + 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the offset of head `item` (batch row item / H, head item % H) in a (B, N,
// H dk) array
__device__ __forceinline__ size_t head_base(long long item, int n, int h, int dk) {
  return (size_t)(item / h) * n * h * dk + (size_t)(item % h) * dk;
}

// One head's rows of x (B, N, H dk) -> dst[r * LD + c], r < R, c < DK, as
// 16-byte cp.async copies; rows past N and columns past dk are zero-filled.
template <typename T, int DK>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ x, size_t base,
                                           size_t stride, int n, int rows, int dk) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DK / kVec;
  constexpr int LD = row_ld<T, DK>();
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = (idx % kChunks) * kVec;
    const bool ok = r < n && c < dk;
    cp_async16(dst + r * LD + c, ok ? x + base + (size_t)r * stride + c : x, ok ? 16 : 0);
  }
}

// ---- the products --------------------------------------------------------

// x = hi + lo + O(2^-21 x): hi = x with its low 13 mantissa bits cleared (so
// x - hi is exact), lo the same of x - hi
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32Mask;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <typename T>
struct Mma;

// fp32: three TF32 passes
template <>
struct Mma<float> {
  static constexpr int kK = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  static __device__ __forceinline__ A a(float a0, float a1, float a2, float a3) {
    A r;
    tf32_split(a0, r.hi[0], r.lo[0]);
    tf32_split(a1, r.hi[1], r.lo[1]);
    tf32_split(a2, r.hi[2], r.lo[2]);
    tf32_split(a3, r.hi[3], r.lo[3]);
    return r;
  }
  static __device__ __forceinline__ B b(float b0, float b1) {
    B r;
    tf32_split(b0, r.hi[0], r.lo[0]);
    tf32_split(b1, r.hi[1], r.lo[1]);
    return r;
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
  }
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// A operand of depth step s (columns 8s .. 8s + 7) from an
// accumulator-layout tile x (16 x 8NT)
template <typename T, int NT>
__device__ __forceinline__ typename Mma<T>::A a_tile(const float (&x)[NT][4], int s) {
  return Mma<T>::a(x[s][0], x[s][2], x[s][1], x[s][3]);
}

// A = X[m0 .. m0 + 15][k0 ..] of a row-major shared array (rows m, depth k)
template <typename T>
__device__ __forceinline__ typename Mma<T>::A a_rows(const T* x, int ld, int m0, int k0) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const float2 u = *reinterpret_cast<const float2*>(x + (m0 + g) * ld + k0 + 2 * t);
  const float2 w = *reinterpret_cast<const float2*>(x + (m0 + g + 8) * ld + k0 + 2 * t);
  return Mma<float>::a(u.x, w.x, u.y, w.y);
}

// A = X^T: A[m][k] = X[k][m] of a row-major shared array (rows k, columns m)
template <typename T>
__device__ __forceinline__ typename Mma<T>::A a_cols(const T* x, int ld, int m0, int k0) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const float* r0 = x + (k0 + 2 * t) * ld + m0 + g;
  return Mma<float>::a(r0[0], r0[8], r0[ld], r0[ld + 8]);
}

// B[k][n] = X[n][k]: an n-major shared array (rows n, depth k along the row)
template <typename T>
__device__ __forceinline__ typename Mma<T>::B b_nmajor(const T* x, int ld, int n0, int k0) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const float2 u = *reinterpret_cast<const float2*>(x + (n0 + g) * ld + k0 + 2 * t);
  return Mma<float>::b(u.x, u.y);
}

// B[k][n] = X[k][n]: a k-major shared array (rows k, columns n)
template <typename T>
__device__ __forceinline__ typename Mma<T>::B b_kmajor(const T* x, int ld, int n0, int k0) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const float* r0 = x + (k0 + 2 * t) * ld + n0 + g;
  return Mma<float>::b(r0[0], r0[ld]);
}

// B = W^T (B[k][n] = W[n][k]) of a (dk, dk) weight in global memory, torch's
// (out, in) layout; entries past dk read as zero
// the pair of W^T (B[k][n] = W[n][k]) a lane holds in a B fragment of a
// (dk, dk) weight in global memory, torch's (out, in) layout; entries past
// dk read as zero
template <typename T>
__device__ __forceinline__ float2 wt_pair(const T* __restrict__ w, int dk, int n0, int k0,
                                          int lane) {
  const int n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  return n < dk && k < dk ? __ldg(reinterpret_cast<const float2*>(w + n * dk + k))
                          : make_float2(0.0f, 0.0f);
}

template <typename T>
__device__ __forceinline__ typename Mma<T>::B b_wt(const T* __restrict__ w, int dk, int n0,
                                                   int k0) {
  const float2 u = wt_pair(w, dk, n0, k0, lane_id());
  return Mma<T>::b(u.x, u.y);
}

// B = W (B[k][n] = W[k][n]) of a (dk, dk) weight in global memory
template <typename T>
__device__ __forceinline__ typename Mma<T>::B b_w(const T* __restrict__ w, int dk, int n0,
                                                  int k0) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int n = n0 + g, k = k0 + 2 * t;
  float b0 = 0.0f, b1 = 0.0f;
  if (n < dk && k < dk) {
    b0 = __ldg(w + k * dk + n);
    b1 = __ldg(w + (k + 1) * dk + n);
  }
  return Mma<float>::b(b0, b1);
}

// A weight's B fragment as a warp reads it from shared memory, split once:
// {hi b0, hi b1, lo b0, lo b1}
template <typename T>
struct Packed {
  using type = uint4;
};

template <typename T>
__device__ __forceinline__ typename Packed<T>::type pack(float2 w) {
  const typename Mma<T>::B b = Mma<T>::b(w.x, w.y);
  return make_uint4(b.hi[0], b.hi[1], b.lo[0], b.lo[1]);
}

template <typename T>
__device__ __forceinline__ typename Mma<T>::B unpack(const typename Packed<T>::type& p) {
  typename Mma<T>::B b;
  b.hi[0] = p.x, b.hi[1] = p.y, b.lo[0] = p.z, b.lo[1] = p.w;
  return b;
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.0f;
}

// acc += x W^T (x a 16 x DK accumulator-layout tile, W (dk, dk)): the B
// fragments from `frag` in shared memory (kFrag, as stage_gate_frags lays
// them out) or read from W in global memory
template <typename T, bool kFrag, int NT>
__device__ __forceinline__ void prod_wt(float (&acc)[NT][4], const float (&x)[NT][4],
                                        const T* __restrict__ w, int dk,
                                        const typename Packed<T>::type* frag) {
  using M = Mma<T>;
  constexpr int KS = NT * 8 / M::kK;
AGSA_UNROLL_COLS
  for (int s = 0; s < KS; ++s) {
    if (s * M::kK >= dk) continue;
    const typename M::A a = a_tile<T>(x, s);
AGSA_UNROLL_COLS
    for (int n = 0; n < NT; ++n) {
      if (8 * n >= dk) continue;
      if constexpr (kFrag) {
        M::mma(acc[n], a, unpack<T>(frag[(n * KS + s) * 32 + lane_id()]));
      } else {
        M::mma(acc[n], a, b_wt<T>(w, dk, 8 * n, s * M::kK));
      }
    }
  }
}

// acc += x W
template <typename T, int NT>
__device__ __forceinline__ void prod_w(float (&acc)[NT][4], const float (&x)[NT][4],
                                       const T* __restrict__ w, int dk) {
  using M = Mma<T>;
AGSA_UNROLL_COLS
  for (int s = 0; s < NT * 8 / M::kK; ++s) {
    if (s * M::kK >= dk) continue;
    const typename M::A a = a_tile<T>(x, s);
AGSA_UNROLL_COLS
    for (int n = 0; n < NT; ++n) {
      if (8 * n < dk) M::mma(acc[n], a, b_w<T>(w, dk, 8 * n, s * M::kK));
    }
  }
}

// x[n][i] += bias[column], columns past dk add 0
template <int NT>
__device__ __forceinline__ void add_bias(float (&x)[NT][4], const float* __restrict__ bias,
                                         int dk) {
  const int t = lane_id() & 3;
AGSA_UNROLL_COLS
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
    const float2 b = c < dk ? __ldg(reinterpret_cast<const float2*>(bias + c))
                            : make_float2(0.0f, 0.0f);
    x[n][0] += b.x;
    x[n][1] += b.y;
    x[n][2] += b.x;
    x[n][3] += b.y;
  }
}

// the accumulator-layout tile of rows r0 .. r0 + 15 of a row-major shared array
template <typename T, int NT>
__device__ __forceinline__ void load_tile(float (&x)[NT][4], const T* s, int ld, int r0) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
AGSA_UNROLL_COLS
  for (int n = 0; n < NT; ++n) {
    const T* p0 = s + (r0 + g) * ld + 8 * n + 2 * t;
    const T* p1 = p0 + 8 * ld;
    const float2 u = *reinterpret_cast<const float2*>(p0);
    const float2 w = *reinterpret_cast<const float2*>(p1);
    x[n][0] = u.x, x[n][1] = u.y, x[n][2] = w.x, x[n][3] = w.y;
  }
}

// the same from one head's rows in global memory (row r at base + r stride;
// rows past n_rows and columns past dk read as zero)
template <typename T, int NT>
__device__ __forceinline__ void load_tile_global(float (&x)[NT][4], const T* __restrict__ src,
                                                 size_t base, size_t stride, int n_rows,
                                                 int dk, int r0) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
AGSA_UNROLL_COLS
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      float2 u = make_float2(0.0f, 0.0f);
      if (r < n_rows && c < dk) {
        const T* p = src + base + (size_t)r * stride + c;
        u = __ldg(reinterpret_cast<const float2*>(p));
      }
      x[n][2 * h] = u.x;
      x[n][2 * h + 1] = u.y;
    }
  }
}

// a pair of values at row r, column c of a row-major shared array, as T
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// rows r0 .. r0 + 15 of a row-major shared array from an accumulator-layout
// tile (rounded to T)
template <typename T, int NT>
__device__ __forceinline__ void store_tile(T* s, int ld, int r0, const float (&x)[NT][4]) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
AGSA_UNROLL_COLS
  for (int n = 0; n < NT; ++n) {
    store_pair<T>(s + (r0 + g) * ld + 8 * n + 2 * t, x[n][0], x[n][1]);
    store_pair<T>(s + (r0 + g + 8) * ld + 8 * n + 2 * t, x[n][2], x[n][3]);
  }
}

// rows r0 .. r0 + 15 (those below n_rows, columns below dk) of a head's rows
// in global memory from an accumulator-layout tile: a quad writes a row's 8
// columns of an n-tile, 32 contiguous bytes, a whole sector
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, size_t base, size_t stride,
                                           int n_rows, int dk, int r0, const float (&x)[NT][4]) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
AGSA_UNROLL_COLS
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
    if (c >= dk) continue;
    if (r0 + g < n_rows) store_pair<T>(dst + base + (size_t)(r0 + g) * stride + c, x[n][0], x[n][1]);
    if (r0 + g + 8 < n_rows) {
      store_pair<T>(dst + base + (size_t)(r0 + g + 8) * stride + c, x[n][2], x[n][3]);
    }
  }
}

// B[k][n] = X[k][n] of one head's rows in global memory (row k at base + k
// stride; rows past n_rows and columns past dk read as zero)
template <typename T>
__device__ __forceinline__ typename Mma<T>::B b_kmajor_global(const T* __restrict__ x,
                                                              size_t base, size_t stride,
                                                              int n_rows, int dk, int n0,
                                                              int k0) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int n = n0 + g, k = k0 + 2 * t;
  const T* col = x + base + n;
  const float b0 = (n < dk && k < n_rows) ? __ldg(col + (size_t)k * stride) : 0.0f;
  const float b1 = (n < dk && k + 1 < n_rows) ? __ldg(col + (size_t)(k + 1) * stride) : 0.0f;
  return Mma<T>::b(b0, b1);
}

// The gate weights and biases: Wq, Wk, Wg1, Wg2 (dk, dk) in T, torch's (out,
// in) layout, and bq, bk, bg1, bg2 (dk) fp32
template <typename T>
struct Gates {
  const T* wq;
  const float* bq;
  const T* wk;
  const float* bk;
  const T* wg1;
  const float* bg1;
  const T* wg2;
  const float* bg2;
  // the B fragments of Wq^T, Wk^T, Wg1^T, Wg2^T in shared memory, where a
  // kernel stages them (stage_gate_frags), one after the other
  const typename Packed<T>::type* frag = nullptr;
};

// the gate weights' B fragments are split into shared memory up to this
// width (32 KB at d_k 32); past it they are read from global memory
template <int DK>
__host__ __device__ constexpr bool frags_in_smem() { return DK <= 32; }

// frags a weight: its n-tiles x depth steps x 32 lanes
template <typename T, int DK>
__host__ __device__ constexpr int frags_per_weight() {
  return (DK / 8) * (DK / Mma<T>::kK) * 32;
}

// The B fragments of W^T of Wq, Wk, Wg1, Wg2 into shared memory, split once a
// block: [weight][n-tile][depth step][lane], as prod_wt<kFrag> reads them
template <typename T, int DK>
__device__ __forceinline__ void stage_gate_frags(typename Packed<T>::type* dst,
                                                 const Gates<T>& w, int dk) {
  constexpr int KS = DK / Mma<T>::kK, PER = frags_per_weight<T, DK>();
  for (int idx = threadIdx.x; idx < 4 * PER; idx += blockDim.x) {
    const int wi = idx / PER, f = (idx / 32) % (PER / 32), lane = idx % 32;
    const T* src = wi == 0 ? w.wq : wi == 1 ? w.wk : wi == 2 ? w.wg1 : w.wg2;
    dst[idx] = pack<T>(wt_pair(src, dk, 8 * (f / KS), (f % KS) * Mma<T>::kK, lane));
  }
}

// gq = q Wq^T + bq, gk = k Wk^T + bk and gg = rnd(gq gk) of a row tile
template <typename T, bool kFrag, int NT>
__device__ __forceinline__ void gate_inputs(const float (&q)[NT][4], const float (&k)[NT][4],
                                            const Gates<T>& w, int dk, float (&gq)[NT][4],
                                            float (&gk)[NT][4], float (&gg)[NT][4]) {
  constexpr int PER = NT * 8 / Mma<T>::kK * NT * 32;
  zero(gq);
  prod_wt<T, kFrag>(gq, q, w.wq, dk, w.frag);
  add_bias(gq, w.bq, dk);
  zero(gk);
  prod_wt<T, kFrag>(gk, k, w.wk, dk, kFrag ? w.frag + PER : nullptr);
  add_bias(gk, w.bk, dk);
AGSA_UNROLL_COLS
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) gg[n][i] = rnd<T>(gq[n][i] * gk[n][i]);
  }
}

// m = sigmoid(gg Wg^T + bg) of a row tile: `which` 1 or 2 (fc_g's halves)
template <typename T, bool kFrag, int NT>
__device__ __forceinline__ void gate(const float (&gg)[NT][4], const Gates<T>& w, int which,
                                     int dk, float (&m)[NT][4]) {
  constexpr int PER = NT * 8 / Mma<T>::kK * NT * 32;
  zero(m);
  prod_wt<T, kFrag>(m, gg, which == 1 ? w.wg1 : w.wg2, dk,
                    kFrag ? w.frag + (1 + which) * PER : nullptr);
  const float* bg = which == 1 ? w.bg1 : w.bg2;
  add_bias(m, bg, dk);
AGSA_UNROLL_COLS
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) m[n][i] = sigmoid_f(m[n][i]);
  }
}

// The scores of a query tile against the head's R keys (km rows in shared
// memory), then the softmax over the first n keys: p[j] holds keys 8j .. 8j
// + 7 (p = 0 at keys past n and for j >= R / 8)
template <typename T, int NT>
__device__ __forceinline__ void softmax_rows(const float (&qm)[NT][4], const T* km, int ld,
                                             int rows, int n, int dk,
                                             float (&p)[kKeyTiles][4]) {
  using M = Mma<T>;
  const int t = lane_id() & 3;
  zero(p);
AGSA_UNROLL_COLS
  for (int s = 0; s < NT * 8 / M::kK; ++s) {
    if (s * M::kK >= dk) continue;
    const typename M::A a = a_tile<T>(qm, s);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      if (8 * j < rows) M::mma(p[j], a, b_nmajor<T>(km, ld, 8 * j, s * M::kK));
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    const int c = 8 * j + 2 * t;
    if (c < n) mx0 = fmaxf(mx0, p[j][0]), mx1 = fmaxf(mx1, p[j][2]);
    if (c + 1 < n) mx0 = fmaxf(mx0, p[j][1]), mx1 = fmaxf(mx1, p[j][3]);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    const int c = 8 * j + 2 * t;
    p[j][0] = c < n ? expf(p[j][0] - mx0) : 0.0f;
    p[j][1] = c + 1 < n ? expf(p[j][1] - mx0) : 0.0f;
    p[j][2] = c < n ? expf(p[j][2] - mx1) : 0.0f;
    p[j][3] = c + 1 < n ? expf(p[j][3] - mx1) : 0.0f;
    s0 += p[j][0] + p[j][1];
    s1 += p[j][2] + p[j][3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  const float r0 = 1.0f / s0, r1 = 1.0f / s1;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    p[j][0] *= r0;
    p[j][1] *= r0;
    p[j][2] *= r1;
    p[j][3] *= r1;
  }
}

// acc += P X over the head's R keys: P a 16 x R accumulator-layout tile
// (rounded to T as the A operand), X a k-major shared array (R x DK)
template <typename T, int NT>
__device__ __forceinline__ void prod_keys(float (&acc)[NT][4], const float (&p)[kKeyTiles][4],
                                          const T* x, int ld, int rows, int dk) {
  using M = Mma<T>;
#pragma unroll
  for (int s = 0; s < kKeyTiles * 8 / M::kK; ++s) {
    if (s * M::kK >= rows) continue;
    const typename M::A a = a_tile<T>(p, s);
AGSA_UNROLL_COLS
    for (int n = 0; n < NT; ++n) {
      if (8 * n < dk) M::mma(acc[n], a, b_kmajor<T>(x, ld, 8 * n, s * M::kK));
    }
  }
}

// A launch plan, four ints (the backward's {grid, stages, blocks an SM,
// shared bytes}, the forward's {grid, G, stages, blocks an SM}), remembered
// by its sizes: the occupancy queries behind it cost more host time than a
// launch, and a model calls the same few sizes over and over
struct PlanCache {
  static constexpr int kEntries = 16;
  long long key[kEntries][7];
  int val[kEntries][4];
  int used = 0;
  std::mutex mu;
  bool find(const long long (&k)[7], int (&out)[4]) {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used && i < kEntries; ++i) {
      bool same = true;
      for (int j = 0; j < 7; ++j) same = same && key[i][j] == k[j];
      if (same) {
        for (int j = 0; j < 4; ++j) out[j] = val[i][j];
        return true;
      }
    }
    return false;
  }
  void put(const long long (&k)[7], const int (&v)[4]) {
    std::lock_guard<std::mutex> lock(mu);
    const int i = used++ % kEntries;
    for (int j = 0; j < 7; ++j) key[i][j] = k[j];
    for (int j = 0; j < 4; ++j) val[i][j] = v[j];
  }
};

}  // namespace agsa
