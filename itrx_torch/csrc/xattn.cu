// SCAN t2i stacked cross-attention score grid for sm_90a.
//
// Replaces itrx/ops/pallas/xattn.py::_kernel (raw_feature_norm =
// clipped_l2norm, agg_func LogSumExp or Mean).  For image i and caption c:
//   A[r, l]  = img_ir . cap_cl                      (formed here, fp32 accumulation)
//   h        = leaky_relu(A, 0.1) * mask_l
//   attn     = h / (sqrt(max(sum_l h^2, 1e-16)) + 1e-8)    per region, over the caption's words
//   s[:, l]  = softmax_r(lambda_softmax * attn[:, l])
//   num_l    = sum_r s[r, l] A[r, l]
//   ctx_l    = s[:, l]^T G_i s[:, l]                (|context|^2 by the Gram trick)
//   row_l    = num_l / max(sqrt(max(ctx_l, 1e-16)) * |cap_cl|, 1e-8)
//   score    = log(sum_l mask_l exp(lambda_lse row_l)) / lambda_lse,  or the masked mean
//
// What bounds it here: forming A is 2 * 36 * L * D flops per pair (about
// 1.8 Mflop at L = 24, D = 1024) against a chain of a few thousand flops per
// word, so the A product dominates; the A tensor itself (Ni x Nc x 36 x L)
// would be gigabytes and must never reach device memory.
// Design: one block per (pair of images, group of whole captions).  The
// block forms two 36 x 128 tiles of A (the group's words side by side, one
// tile per image, so each staged caption chunk serves both images) over
// chunks of D staged in shared memory, keeps them in shared memory, runs the
// whole chain there with one thread per (image, word), and writes one fp32
// score per pair.  The block owns whole
// captions, so the l2norm over words needs no exchange between blocks.
// bf16 inputs (the eval_bf16 production mode) form A on the tensor cores
// (wmma 16x16x16, regions padded to 48 rows, fp32 accumulation), with the
// chunks of D copied by cp.async into two stage buffers so that the copy of
// the next chunk overlaps the product of this one; fp32 inputs form it with
// a tiled fp32 FMA loop, so that fp32 stays exact.  The chain after A is
// fp32 either way.  Blocks are ordered so that those in flight share a few
// images and caption groups, which then come from L2: a bucket's caption
// stack (245 MB at 5000 x 24 x 1024 bf16) does not fit the 50 MB L2.  The
// per-image Gram (36 x 36), the word norms and the masked captions come from
// the wrapper, as in the TPU wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

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
  __nv_bfloat16* stages[2] = {reinterpret_cast<__nv_bfloat16*>(buf),
                              reinterpret_cast<__nv_bfloat16*>(buf) + kStageElems};
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  // the 12 pad rows under each image stay zero in both stages
  constexpr int kPadVecs = (kRPad - kR) * kLdT / 8;
  for (int idx = tid; idx < 2 * kImgs * kPadVecs; idx += kThreads) {
    const int st = idx / (kImgs * kPadVecs), p = idx / kPadVecs % kImgs, v = idx % kPadVecs;
    reinterpret_cast<uint4*>(stages[st] + (p * kRPad + kR) * kLdT)[v] = make_uint4(0u, 0u, 0u, 0u);
  }
  constexpr int kM = kImgs * kRPad / 16;  // 16-row tiles of A per warp column
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) wmma::fill_fragment(acc[m], 0.0f);

  const int n_chunks = (D + kDKT - 1) / kDKT;
  stage_chunk(stages[0], img, i0, Ni, cap, c0, ncols, Nc, L, D, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      stage_chunk(stages[(ch + 1) & 1], img, i0, Ni, cap, c0, ncols, Nc, L, D,
                  (ch + 1) * kDKT);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* img_s = stages[ch & 1];
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
xattn_t2i_kernel(const T* __restrict__ img,        // (Ni, 36, D)
                 const T* __restrict__ cap,        // (Nc, L, D), zero at padded words
                 const float* __restrict__ capn,   // (Nc, L) word norms
                 const float* __restrict__ mask,   // (Nc, L)
                 const float* __restrict__ gram,   // (Ni, 36, 36)
                 float* __restrict__ out,          // (Ni, Nc)
                 int Ni, int Nc, int L, int D, int caps_per_block, int n_groups,
                 float lambda_lse, float lambda_softmax, int agg_mean) {
  // staged chunks of D during the product, then the fp32 A tiles
  // [kImgs * kRPad][kLdA]
  extern __shared__ __align__(128) float tile[];
  __shared__ __align__(16) float gram_s[kImgs][kR * kR];
  __shared__ float inv_den[kImgs][kR][kMaxCaps];
  __shared__ float row_sim[kImgs][kCols];

  const int tid = threadIdx.x;
  // Block order: runs of kPairSwizzle image pairs sweep the caption groups,
  // so the blocks in flight share a few caption groups and a few images,
  // and both are read from L2 rather than device memory (the caption stack
  // of a bucket is larger than L2).
  const int n_pairs = (Ni + kImgs - 1) / kImgs;
  const int run = blockIdx.x / (kPairSwizzle * n_groups);
  const int pair0 = run * kPairSwizzle;
  const int run_pairs = min(kPairSwizzle, n_pairs - pair0);
  const int rem = blockIdx.x - run * kPairSwizzle * n_groups;
  const int i0 = (pair0 + rem % run_pairs) * kImgs;
  const int c0 = (rem / run_pairs) * caps_per_block;
  const int ncols = caps_per_block * L;

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    product_tc(img, i0, Ni, cap, c0, ncols, Nc, L, D, tile);
  } else {
    for (int p = 0; p < kImgs && i0 + p < Ni; ++p) {
      product_fma(img + (size_t)(i0 + p) * kR * D, cap, c0, ncols, Nc, L, D,
                  tile + p * kRPad * kLdA, tile + kTileFloats);
    }
  }
  for (int idx = tid; idx < kImgs * kR * kR; idx += kThreads) {
    const int p = idx / (kR * kR);
    gram_s[p][idx % (kR * kR)] = i0 + p < Ni ? gram[(size_t)i0 * kR * kR + idx] : 0.0f;
  }
  __syncthreads();

  // clipped l2norm denominators, per (image, region, caption) over the valid words
  for (int idx = tid; idx < kImgs * kR * caps_per_block; idx += kThreads) {
    const int p = idx / (kR * caps_per_block), r = idx / caps_per_block % kR;
    const int cc = idx % caps_per_block, c = c0 + cc;
    float ss = 0.0f;
    if (c < Nc) {
      const float* a_row = tile + (p * kRPad + r) * kLdA + cc * L;
      for (int l = 0; l < L; ++l) {
        const float a = a_row[l];
        const float h = (a > 0.0f ? a : 0.1f * a) * mask[(size_t)c * L + l];
        ss = fmaf(h, h, ss);
      }
    }
    inv_den[p][r][cc] = 1.0f / (sqrtf(fmaxf(ss, 1e-16f)) + kEps);
  }
  __syncthreads();

  // one (image, word) per thread: region softmax, numerator, Gram context norm
  {
    const int p = tid / kCols, col = tid % kCols;
    const int cc = col / L, l = col % L, c = c0 + cc;
    if (col < ncols && c < Nc && i0 + p < Ni) {
      const float* a_col = tile + p * kRPad * kLdA + col;
      const float m = mask[(size_t)c * L + l];
      float s[kR];
      float mx = -3.0e38f;  // every logit is finite
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float a = a_col[r * kLdA];
        const float h = (a > 0.0f ? a : 0.1f * a) * m;
        s[r] = h * inv_den[p][r][cc] * lambda_softmax;
        mx = fmaxf(mx, s[r]);
      }
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        s[r] = expf(s[r] - mx);
        sum += s[r];
      }
      const float inv_sum = 1.0f / sum;
      float num = 0.0f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        s[r] *= inv_sum;
        num = fmaf(s[r], a_col[r * kLdA], num);
      }
      // ctx = s^T G s; G rows read as float4 (a broadcast: a warp reads one row)
      const float4* g4 = reinterpret_cast<const float4*>(gram_s[p]);
      float ctx = 0.0f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        float y = 0.0f;
#pragma unroll
        for (int q = 0; q < kR / 4; ++q) {
          const float4 g = g4[r * (kR / 4) + q];
          y = fmaf(g.x, s[4 * q], y);
          y = fmaf(g.y, s[4 * q + 1], y);
          y = fmaf(g.z, s[4 * q + 2], y);
          y = fmaf(g.w, s[4 * q + 3], y);
        }
        ctx = fmaf(s[r], y, ctx);
      }
      row_sim[p][col] = num / fmaxf(sqrtf(fmaxf(ctx, 1e-16f)) * capn[(size_t)c * L + l], kEps);
    }
  }
  __syncthreads();

  // aggregate each (image, caption)'s words
  if (tid < kImgs * caps_per_block) {
    const int p = tid / caps_per_block, cc = tid % caps_per_block, c = c0 + cc;
    if (c < Nc && i0 + p < Ni) {
      float acc0 = 0.0f, cnt = 0.0f;
      for (int l = 0; l < L; ++l) {
        const float m = mask[(size_t)c * L + l];
        const float v = row_sim[p][cc * L + l];
        if (agg_mean) {
          acc0 += v * m;
          cnt += m;
        } else {
          acc0 += expf(v * lambda_lse) * m;
        }
      }
      out[(size_t)(i0 + p) * Nc + c] = agg_mean ? acc0 / fmaxf(cnt, 1.0f) : logf(acc0) / lambda_lse;
    }
  }
}

template <typename T>
int run(const void* img, const void* cap, const void* capn, const void* mask,
        const void* gram, void* out, int Ni, int Nc, int L, int D,
        float lambda_lse, float lambda_softmax, int agg_mean, cudaStream_t stream) {
  if (L < 1 || L > kCols) return (int)cudaErrorInvalidValue;
  if (std::is_same<T, __nv_bfloat16>::value && D % 8 != 0) return (int)cudaErrorInvalidValue;
  int cpb = kCols / L;
  if (cpb > kMaxCaps) cpb = kMaxCaps;
  const int n_groups = (Nc + cpb - 1) / cpb;
  const long long n_blocks = (long long)n_groups * ((Ni + kImgs - 1) / kImgs);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = std::is_same<T, __nv_bfloat16>::value ? kSmemBf16 : kSmemF32;
  const cudaError_t err = cudaFuncSetAttribute(
      xattn_t2i_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  xattn_t2i_kernel<T><<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(cap),
      static_cast<const float*>(capn), static_cast<const float*>(mask),
      static_cast<const float*>(gram), static_cast<float*>(out), Ni, Nc, L, D, cpb,
      n_groups, lambda_lse, lambda_softmax, agg_mean);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img (Ni, 36, D) and cap (Nc, L, D) both fp32 or both bf16 (bf16 != 0; then
// D % 8 == 0 and both 16-byte aligned), captions zero at padded words; capn,
// mask (Nc, L) fp32; gram (Ni, 36, 36) fp32; out (Ni, Nc) fp32.  One launch
// on `stream` of CUDA device `device`; returns cudaGetLastError().
// 1 <= L <= 128.
int itrx_xattn_t2i(const void* img, const void* cap, const void* capn, const void* mask,
                   const void* gram, void* out, int Ni, int Nc, int L, int D, int bf16,
                   float lambda_lse, float lambda_softmax, int agg_mean, int device,
                   void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return run<__nv_bfloat16>(img, cap, capn, mask, gram, out, Ni, Nc, L, D, lambda_lse,
                              lambda_softmax, agg_mean, s);
  }
  return run<float>(img, cap, capn, mask, gram, out, Ni, Nc, L, D, lambda_lse,
                    lambda_softmax, agg_mean, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
