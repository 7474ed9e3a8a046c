// Pieces shared by the persistent GRU kernels (csrc/gru.cu, csrc/gru_bwd.cu):
// the hand-written grid barrier, the block's weight slice in shared memory
// (resident, or streamed through a cp.async ring), and the fp32
// register-tiled product against an exchange row block read from L2, and the
// bf16 tensor-core product (the bf16 modes).
//
// Layout of a launch: kThreads = 256 threads, 8 warps; warp w owns batch rows
// 16 w .. 16 w + 15 of the launch (at most kRows = 128 rows).  The block's N
// weight rows sit in shared memory as [N][ld] with K contiguous; the product
// is out[row][n] = sum_k A[row][k] W[n][k] over K padded to kKAlign with
// zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gru {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;  // batch rows a launch
constexpr int kKAlign = 64;         // K is padded to this; one product iteration
constexpr int kStages = 4;          // ring depth of the streamed route
constexpr int kPadF32 = 4;          // row pad, floats: row stride = 16 B mod 128
constexpr int kPadBf16 = 32;        // row pad, bf16: row stride = 64 B mod 128

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// Grid barrier.  bar[0] counts the blocks that arrived in the current
// generation, bar[1] is the generation; both are zero before the launch.  The
// last block to arrive resets the count and releases the next generation; the
// others spin on it with acquire loads.  __threadfence() on both sides makes
// every write of the block, ordered before thread 0 by __syncthreads(),
// visible to every block after the barrier (cumulativity).  The launch is
// cooperative, so all blocks are resident and the spin cannot deadlock.

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    __threadfence();
    if (atom_add_acq_rel(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      st_release(bar + 1, gen + 1);
    } else {
      while (ld_acquire(bar + 1) == gen) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The block's weight slice: row n (of N) is global row (n / U) * qstride +
// j0 + n % U of a row-major source with leading dimension ldw, valid while
// j0 + n % U < H; columns k < K.  Everything else reads as zero.

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() { return __float2bfloat16(0.0f); }

// Resident: the whole slice, [N][ld] over Kp = round_up(K, kKAlign) columns,
// loaded once by coalesced scalar loads (any H, any alignment), 16 in flight
// a thread.
template <typename T, int N, int U>
__device__ void load_resident(T* ws, int ld, const T* __restrict__ src, int ldw, int qstride,
                              int j0, int H, int K, int Kp) {
  constexpr int kBatch = 16;
  const int count = N * Kp;
  for (int base = threadIdx.x; base < count; base += kThreads * kBatch) {
    T v[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int idx = base + e * kThreads;
      const int n = idx / Kp, k = idx - n * Kp;
      const int j = j0 + n % U;
      v[e] = (idx < count && j < H && k < K) ? src[(size_t)((n / U) * qstride + j) * ldw + k]
                                             : zero_of<T>();
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int idx = base + e * kThreads;
      const int n = idx / Kp;
      if (idx < count) ws[(size_t)n * ld + idx - n * Kp] = v[e];
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Streamed (fp32): chunk `chunk` of a run of products, each product
// Kp / kKAlign chunks of kKAlign columns, lands in ring slot chunk % kStages
// ([N][kKAlign + kPadF32]).  The source's rows are 16-byte aligned (ldw % 4
// == 0, the wrapper pads) and zero past K, so a piece is whole or absent.
// One commit group per call, empty past the last chunk.
template <int N, int U>
__device__ __forceinline__ void ring_issue(float* ring, int chunk, int total, int per_product,
                                           const float* __restrict__ src, int ldw, int qstride,
                                           int j0, int H, int K) {
  constexpr int kPieces = kKAlign / 4;
  constexpr int kLd = kKAlign + kPadF32;
  if (chunk < total) {
    float* slot = ring + (chunk % kStages) * N * kLd;
    const int k0 = (chunk % per_product) * kKAlign;
    for (int idx = threadIdx.x; idx < N * kPieces; idx += kThreads) {
      const int n = idx / kPieces, p = idx - n * kPieces;
      const int j = j0 + n % U, k = k0 + 4 * p;
      const bool ok = j < H && k < K;
      const float* g = ok ? src + (size_t)((n / U) * qstride + j) * ldw + k : src;
      cp_async16(slot + n * kLd + 4 * p, g, ok ? 16 : 0);
    }
  }
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// fp32 product.  A warp's 16 rows split into 16 / R groups of R rows
// (rows rg + (16 / R) i of the warp's tile); the S = 2 R lanes of a group
// split K: lane c takes k = KB b + 4 c .. KB b + 4 c + 3 of every block b of
// KB = 4 S columns and sums, in order, its partial products for the group's
// R rows and all N weight rows; reduce_lanes then adds the S partials.  Each
// 16-byte weight load feeds 4 R FMAs a lane (R = 4 where the accumulators
// fit: the adjoint, the forward at 8 units).  The A rows come from the
// exchange, written by other blocks during this launch: __ldcg reads them at
// L2, never from a stale L1 line; kDepth - 1 blocks are in flight while one
// is summed (the loads' latency, not their bytes, paces a warp; deeper
// rings spill registers and measured slower on the H100).

constexpr int kDepth = 4;

template <int R>
__device__ __forceinline__ void load_rows(float4 (&x)[R], const float* a, int step, int valid) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    x[i] = i < valid ? __ldcg(reinterpret_cast<const float4*>(a + (size_t)i * step))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// acc[i][n] += x[i] . w[n][0..3] (w at the lane's 4 columns, row stride ld)
template <int R, int N>
__device__ __forceinline__ void fma_block(float (&acc)[R][N], const float4 (&x)[R], const float* w,
                                          int ld) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float4 v = *reinterpret_cast<const float4*>(w + n * ld);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      acc[i][n] = fmaf(x[i].x, v.x, acc[i][n]);
      acc[i][n] = fmaf(x[i].y, v.y, acc[i][n]);
      acc[i][n] = fmaf(x[i].z, v.z, acc[i][n]);
      acc[i][n] = fmaf(x[i].w, v.w, acc[i][n]);
    }
  }
}

// The S lanes' partial sums of each (row i, column n = q U + S a + cc): lane
// c keeps column S a + c of each gate q, res[i][q][a].  Fixed order (halving
// exchanges), so repeated calls are bit-identical.
template <int R, int Q, int U, int S>
__device__ __forceinline__ void reduce_lanes(const float (&acc)[R][Q * U],
                                             float (&res)[R][Q][U / S], int c) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int a = 0; a < U / S; ++a) {
        float v[S];
#pragma unroll
        for (int cc = 0; cc < S; ++cc) v[cc] = acc[i][q * U + S * a + cc];
#pragma unroll
        for (int w = S / 2; w >= 1; w /= 2) {
          const bool up = c & w;
#pragma unroll
          for (int e = 0; e < w; ++e) {
            const float keep = up ? v[w + e] : v[e], give = up ? v[e] : v[w + e];
            v[e] = keep + __shfl_xor_sync(0xffffffffu, give, w);
          }
        }
        res[i][q][a] = v[0];
      }
    }
  }
}

// One product of the launch's rows against the block's N = Q U weight rows,
// fp32: resident (ws holds all Kp columns) or streamed (64-column chunks
// through the ring; `chunk` counts the chunks consumed across products, and
// every thread of the block joins).  rowg: the group's first row; warps
// without rows (`live` false) only keep the ring going.
template <int R, int Q, int U, bool STREAM>
__device__ __forceinline__ void product_f32(float (&res)[R][Q][U / (2 * R)], const float* A,
                                            int lda, int rowg, int B, bool live, float* ws,
                                            int ld, int Kp, int c, int& chunk, int total,
                                            const float* __restrict__ src, int ldw, int qstride,
                                            int j0, int H, int K) {
  constexpr int S = 2 * R, N = Q * U, KB = 4 * S, kPerChunk = kKAlign / KB;
  constexpr int step = 16 / R;  // rows between a lane's rows
  float acc[R][N];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = 0.0f;
  const int valid = rowg < B ? min(R, (B - 1 - rowg) / step + 1) : 0;
  const float* a = A + (size_t)rowg * lda + 4 * c;
  const int nblk = Kp / KB;
  float4 buf[kDepth][R];
#pragma unroll
  for (int d = 0; d < kDepth - 1; ++d)
    if (live && d < nblk) load_rows<R>(buf[d], a + d * KB, step * lda, valid);
  for (int b0 = 0; b0 < nblk; b0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int b = b0 + d;
      if (b < nblk) {
        if (live && b + kDepth - 1 < nblk) {
          load_rows<R>(buf[(d + kDepth - 1) % kDepth], a + (b + kDepth - 1) * KB, step * lda,
                       valid);
        }
        const float* w;
        if constexpr (STREAM) {
          if (b % kPerChunk == 0) {
            cp_async_wait<kStages - 2>();
            __syncthreads();
            ring_issue<N, U>(ws, chunk + kStages - 1, total, Kp / kKAlign, src, ldw, qstride, j0,
                             H, K);
            ++chunk;
          }
          w = ws + ((chunk - 1) % kStages) * N * ld + (b % kPerChunk) * KB + 4 * c;
        } else {
          w = ws + b * KB + 4 * c;
        }
        if (live) fma_block<R, N>(acc, buf[d], w, ld);
      }
    }
  }
  if (live) reduce_lanes<R, Q, U, S>(acc, res, c);
}

// ---------------------------------------------------------------------------
// bf16 product on tensor cores (mma.sync m16n8k16, fp32 accumulation): warp w
// takes batch rows 16 w .. 16 w + 15 of an exchange of bf16 rows, the k order
// inside each 32 columns permuted so that a lane's A and B fragments are one
// 16-byte load each.

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 64 columns of rows g and g + 8: two 32-column blocks, lane c holding
// columns 8 c .. 8 c + 7 of each
struct RowsBf16 {
  uint4 a[2], b[2];
};

__device__ __forceinline__ void load64_bf16(RowsBf16& x, const __nv_bfloat16* a0,
                                            const __nv_bfloat16* a1, bool v0, bool v1) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x.a[i] = v0 ? __ldcg(reinterpret_cast<const uint4*>(a0 + 32 * i)) : z;
    x.b[i] = v1 ? __ldcg(reinterpret_cast<const uint4*>(a1 + 32 * i)) : z;
  }
}

// d[t] = the warp's 16 rows x column tile t (8 weight rows t 8 .. t 8 + 7 of
// ws, NT tiles) over Kp, bf16 operands, fp32 accumulation.  In each 32-column block lane c holds physical columns
// 8 c .. 8 c + 7 of its rows (A) and of its weight row (B); the first mma
// takes 8 c .. 8 c + 3 as the fragment's logical columns {2c, 2c + 1, 2c + 8,
// 2c + 9}, the second 8 c + 4 .. 8 c + 7.  A and B use the same map, so the
// sum is the same product over a permuted k.
template <int NT>
__device__ __forceinline__ void product_bf16(float (&d)[NT][4], const __nv_bfloat16* A,
                                             int lda, int row0, int B,
                                             const __nv_bfloat16* ws, int ld, int Kp, int g,
                                             int c) {
#pragma unroll
  for (int t = 0; t < NT; ++t) d[t][0] = d[t][1] = d[t][2] = d[t][3] = 0.0f;
  const bool v0 = row0 < B, v1 = row0 + 8 < B;
  const __nv_bfloat16* a0 = A + (size_t)row0 * lda + 8 * c;
  const __nv_bfloat16* a1 = a0 + (size_t)8 * lda;
  const __nv_bfloat16* w = ws + g * ld + 8 * c;
  const int nblk = Kp / kKAlign;
  RowsBf16 buf[kDepth];  // kDepth - 1 64-column blocks in flight
#pragma unroll
  for (int e = 0; e < kDepth - 1; ++e)
    if (e < nblk) load64_bf16(buf[e], a0 + e * kKAlign, a1 + e * kKAlign, v0, v1);
  for (int b0 = 0; b0 < nblk; b0 += kDepth) {
#pragma unroll
    for (int e = 0; e < kDepth; ++e) {
      const int b = b0 + e;
      if (b >= nblk) continue;
      const int bl = b + kDepth - 1;
      if (bl < nblk) {
        load64_bf16(buf[(e + kDepth - 1) % kDepth], a0 + bl * kKAlign, a1 + bl * kKAlign, v0,
                    v1);
      }
      const RowsBf16& x = buf[e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(w + t * 8 * ld + b * kKAlign + 32 * i);
          mma_bf16(d[t], x.a[i].x, x.b[i].x, x.a[i].y, x.b[i].y, v.x, v.y);
          mma_bf16(d[t], x.a[i].z, x.b[i].z, x.a[i].w, x.b[i].w, v.z, v.w);
        }
      }
    }
  }
}

template <typename W>
__device__ __forceinline__ W to_w(float x);
template <>
__device__ __forceinline__ float to_w<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_w<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to bf16 (to nearest even) and read back: an operand as the bf16
// modes read it
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

}  // namespace gru
