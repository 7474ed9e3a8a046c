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
// the wrapper, as in the TPU wrapper.  The tiling, the block order and the A
// product are shared with the i2t kernel (xattn_product.cuh).
#include "xattn_product.cuh"

namespace {

using namespace itrx_xattn;

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
  int i0, c0;
  block_origin(Ni, caps_per_block, n_groups, &i0, &c0);
  const int ncols = caps_per_block * L;

  product(img, i0, Ni, cap, c0, ncols, Nc, L, D, tile);
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
  const int cpb = caps_per_block(L);
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
