// Shared by the two SCAN score-grid kernels, xattn.cu (t2i) and
// xattn_i2t.cu (i2t): the tile constants, the block order and the A product.
// A block takes a pair of images and a group of whole captions (at most 128
// word columns) and forms the two 36 x 128 tiles of A = img . cap^T in shared
// memory, over chunks of D staged in shared memory: on the tensor cores for
// bf16 inputs (wmma 16x16x16, regions padded to 48 rows, fp32 accumulation,
// cp.async double buffering), by a tiled fp32 FMA loop for fp32 inputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace itrx_xattn {

using namespace nvcuda;

constexpr int kR = 36;          // regions per image
constexpr int kRPad = 48;       // regions padded to three 16-row tensor-core tiles
constexpr int kImgs = 2;        // images per block
constexpr int kCols = 128;      // word columns per block (whole captions)
constexpr int kMaxCaps = 32;    // captions per block at most
constexpr int kThreads = 256;   // 8 warps; the chain runs one (image, word) per thread
constexpr int kLdA = 132;       // row stride (floats) of the fp32 A tiles
constexpr int kPairSwizzle = 16;  // consecutive blocks: 16 image pairs x one caption group
constexpr float kEps = 1e-8f;

// fp32 FMA product: staged chunks of 32 over D
constexpr int kDK = 32;
constexpr int kColThreads = 64;  // threads along the columns; each takes 2
constexpr int kRowsPerThread = kR / (kThreads / kColThreads);  // 9
constexpr int kLdC = kCols + 1;  // padded row of the staged caption chunk

// bf16 tensor-core product: staged chunks of 64 over D
constexpr int kDKT = 64;
constexpr int kLdT = kDKT + 8;   // bf16 row stride of the staged chunks
constexpr int kStageElems = (kImgs * kRPad + kCols) * kLdT;  // bf16 elements of one stage

// dynamic shared memory: the A tiles, which the bf16 stage buffers precede
// in the same place; the fp32 staging lies after the A tiles
constexpr int kTileFloats = kImgs * kRPad * kLdA;
constexpr int kStageF32Floats = kDK * (kR + 1) + kDK * kLdC;
constexpr int kSmemBf16 = 2 * kStageElems * 2;
constexpr int kSmemF32 = (kTileFloats + kStageF32Floats) * 4;
static_assert(kTileFloats * 4 <= kSmemBf16, "the A tiles fit the bf16 stage buffers");
static_assert(kThreads / 32 * 16 == kCols, "one 16-column slice of A per warp");
static_assert(kImgs * kCols == kThreads, "one (image, word) per thread in the chain");

// a_out (rows 0..35, stride kLdA) = img_i (36 x D) . cap_group^T, fp32 FMA
__device__ void product_fma(const float* __restrict__ img_i, const float* __restrict__ cap,
                            int c0, int ncols, int Nc, int L, int D, float* a_out,
                            float* staging) {
  float* img_s = staging;                      // [kDK][kR + 1]
  float* cap_s = staging + kDK * (kR + 1);     // [kDK][kLdC]
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;
  float acc[kRowsPerThread][2];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q][0] = acc[q][1] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += kDK) {
    for (int idx = tid; idx < kR * kDK; idx += kThreads) {
      const int r = idx / kDK, k = idx % kDK, kk = k0 + k;
      img_s[k * (kR + 1) + r] = kk < D ? img_i[(size_t)r * D + kk] : 0.0f;
    }
    for (int idx = tid; idx < kCols * kDK; idx += kThreads) {
      const int col = idx / kDK, k = idx % kDK, kk = k0 + k;
      const int c = c0 + col / L;
      float v = 0.0f;
      if (col < ncols && c < Nc && kk < D) v = cap[((size_t)c * L + col % L) * D + kk];
      cap_s[k * kLdC + col] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kDK; ++k) {
      const float ca = cap_s[k * kLdC + tx];
      const float cb = cap_s[k * kLdC + tx + kColThreads];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const float a = img_s[k * (kR + 1) + ty * kRowsPerThread + q];
        acc[q][0] = fmaf(a, ca, acc[q][0]);
        acc[q][1] = fmaf(a, cb, acc[q][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int r = ty * kRowsPerThread + q;
    a_out[r * kLdA + tx] = acc[q][0];
    a_out[r * kLdA + tx + kColThreads] = acc[q][1];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

// Stage chunk [k0, k0 + kDKT) of the block's images (36 rows each, at row
// p * kRPad) and of the group's words (128 rows) into one stage buffer with
// cp.async; one commit group.  An image past Ni is staged as zeros.
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* stage,
                                            const __nv_bfloat16* __restrict__ img, int i0,
                                            int Ni, const __nv_bfloat16* __restrict__ cap,
                                            int c0, int ncols, int Nc, int L, int D, int k0) {
  __nv_bfloat16* img_s = stage;                          // [kImgs * kRPad][kLdT]
  __nv_bfloat16* cap_s = stage + kImgs * kRPad * kLdT;   // [kCols][kLdT]
  const int tid = threadIdx.x;
  for (int idx = tid; idx < kImgs * kR * (kDKT / 8); idx += kThreads) {
    const int row = idx / (kDKT / 8), v = idx % (kDKT / 8), kk = k0 + v * 8;
    const int p = row / kR, r = row % kR;
    const bool ok = i0 + p < Ni && kk < D;
    cp_async16(img_s + (p * kRPad + r) * kLdT + v * 8,
               ok ? img + ((size_t)(i0 + p) * kR + r) * D + kk : img, ok);
  }
  for (int idx = tid; idx < kCols * (kDKT / 8); idx += kThreads) {
    const int col = idx / (kDKT / 8), v = idx % (kDKT / 8), kk = k0 + v * 8;
    const int c = c0 + col / L;
    const bool ok = col < ncols && c < Nc && kk < D;
    cp_async16(cap_s + col * kLdT + v * 8,
               ok ? cap + ((size_t)c * L + col % L) * D + kk : cap, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A tiles (image p: rows p * kRPad .. + 35 valid) = img . cap_group^T on the
// tensor cores; warp w owns columns 16w .. 16w+15 of both tiles.  Two stage
// buffers: the copy of chunk k+1 runs while chunk k is multiplied.
// D % 8 == 0 and 16-byte aligned rows.
__device__ void product_tc(const __nv_bfloat16* __restrict__ img, int i0, int Ni,
                           const __nv_bfloat16* __restrict__ cap, int c0, int ncols,
                           int Nc, int L, int D, float* buf) {
  // stage st at stage0 + st * kStageElems (an address computed, not an
  // array of pointers indexed at run time, which would live on the stack)
  __nv_bfloat16* const stage0 = reinterpret_cast<__nv_bfloat16*>(buf);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  // the 12 pad rows under each image stay zero in both stages
  constexpr int kPadVecs = (kRPad - kR) * kLdT / 8;
  for (int idx = tid; idx < 2 * kImgs * kPadVecs; idx += kThreads) {
    const int st = idx / (kImgs * kPadVecs), p = idx / kPadVecs % kImgs, v = idx % kPadVecs;
    reinterpret_cast<uint4*>(stage0 + st * kStageElems + (p * kRPad + kR) * kLdT)[v] =
        make_uint4(0u, 0u, 0u, 0u);
  }
  constexpr int kM = kImgs * kRPad / 16;  // 16-row tiles of A per warp column
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) wmma::fill_fragment(acc[m], 0.0f);

  const int n_chunks = (D + kDKT - 1) / kDKT;
  stage_chunk(stage0, img, i0, Ni, cap, c0, ncols, Nc, L, D, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      stage_chunk(stage0 + ((ch + 1) & 1) * kStageElems, img, i0, Ni, cap, c0, ncols, Nc, L, D,
                  (ch + 1) * kDKT);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* img_s = stage0 + (ch & 1) * kStageElems;
    const __nv_bfloat16* cap_s = img_s + kImgs * kRPad * kLdT;
#pragma unroll
    for (int kk = 0; kk < kDKT; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, cap_s + warp * 16 * kLdT + kk, kLdT);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, img_s + m * 16 * kLdT + kk, kLdT);
        wmma::mma_sync(acc[m], a, b, acc[m]);
      }
    }
    __syncthreads();  // stage ch & 1 is refilled next iteration
  }
  // the A tiles replace the stage buffers
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    wmma::store_matrix_sync(buf + m * 16 * kLdA + warp * 16, acc[m], kLdA, wmma::mem_row_major);
  }
}

// Work item `item`'s first image and first caption.  Runs of kPairSwizzle
// image pairs sweep the caption groups, so the items in flight share a few
// caption groups and a few images, and both are read from L2 rather than
// device memory (a bucket's caption stack is larger than the 50 MB L2).
__device__ __forceinline__ void block_origin(int item, int Ni, int caps_per_block,
                                             int n_groups, int* i0, int* c0) {
  const int n_pairs = (Ni + kImgs - 1) / kImgs;
  const int run = item / (kPairSwizzle * n_groups);
  const int pair0 = run * kPairSwizzle;
  const int run_pairs = min(kPairSwizzle, n_pairs - pair0);
  const int rem = item - run * kPairSwizzle * n_groups;
  *i0 = (pair0 + rem % run_pairs) * kImgs;
  *c0 = (rem / run_pairs) * caps_per_block;
}

// The block's first image and first caption: one item per block.
__device__ __forceinline__ void block_origin(int Ni, int caps_per_block, int n_groups,
                                             int* i0, int* c0) {
  block_origin(blockIdx.x, Ni, caps_per_block, n_groups, i0, c0);
}

// Both images' A tiles into `tile` (image p at rows p * kRPad, stride kLdA);
// columns past the group's words and images past Ni are zero (bf16) or
// left unwritten (fp32, image past Ni).  Ends with the tiles written by
// this thread; the caller synchronizes.
template <typename T>
__device__ __forceinline__ void product(const T* __restrict__ img, int i0, int Ni,
                                        const T* __restrict__ cap, int c0, int ncols, int Nc,
                                        int L, int D, float* tile) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    product_tc(img, i0, Ni, cap, c0, ncols, Nc, L, D, tile);
  } else {
    for (int p = 0; p < kImgs && i0 + p < Ni; ++p) {
      product_fma(img + (size_t)(i0 + p) * kR * D, cap, c0, ncols, Nc, L, D,
                  tile + p * kRPad * kLdA, tile + kTileFloats);
    }
  }
}

// captions per block: whole captions, at most kCols words and kMaxCaps captions
inline int caps_per_block(int L) { return kCols / L < kMaxCaps ? kCols / L : kMaxCaps; }

}  // namespace itrx_xattn
