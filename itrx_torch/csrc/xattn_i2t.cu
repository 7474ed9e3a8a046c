// SCAN i2t stacked cross-attention score grid for sm_90a.
//
// Replaces itrx/ops/pallas/xattn.py::_kernel_i2t (raw_feature_norm =
// clipped_l2norm, agg_func LogSumExp or Mean).  For image i, caption c,
// region r and valid word l:
//   A[r, l]  = img_ir . cap_cl                      (formed here, fp32 accumulation;
//                                                    captions zero at padded words)
//   h        = leaky_relu(A, 0.1)
//   attn     = h / (sqrt(max(sum_r h^2, 1e-16)) + 1e-8)    per word, over the 36 regions
//   s[r, :]  = softmax over the caption's valid words of lambda_softmax * attn[r, :]
//   num_r    = sum_l s[r, l] A[r, l]
//   ctx_r    = s[r, :]^T G_c s[r, :]                (G_c the caption's (L, L) word Gram)
//   row_r    = num_r / max(sqrt(max(ctx_r, 1e-16)) * |img_ir|, 1e-8)
//   score    = log(sum_r exp(lambda_lse row_r)) / lambda_lse,  or sum_r row_r / 36
//
// What bounds it here: as for t2i, forming A (2 * 36 * L * D flops per pair,
// about 1.8 Mflop at L = 24, D = 1024) dominates; the chain after it costs
// 36 * L * (L + a few) flops per pair (the context norm's s . G_c is 36 L^2,
// under 3% of A at L = 24), and the A tensor (Ni x Nc x 36 x L) must never
// reach device memory.
// Design: the tiling, block order and A product of the t2i kernel
// (xattn_product.cuh): one block per (pair of images, group of whole
// captions), two 36 x 128 tiles of A in shared memory.  The chain then runs
// in three steps: one thread per (image, word column) takes the l2norm over
// the 36 region rows; one thread per (image, region, caption) takes the
// softmax over that caption's words (local, since the block owns whole
// captions), the numerator and the context norm against the caption's Gram,
// staged in shared memory for the group; one thread per (image, caption)
// aggregates over the regions.  As in the TPU kernel, the word softmax needs
// no max subtraction (|attn| <= 1, so exp is bounded by e^lambda_softmax)
// and pad words leave it by a multiply with the mask; the LogSumExp over
// regions has none either.  The chain is fp32 for both input types.  The
// per-caption Grams (fp32), the region norms and the masked captions come
// from the wrapper, as in the TPU wrapper.
#include "xattn_product.cuh"

namespace {

using namespace itrx_xattn;

// dynamic shared memory below the staged word Grams: the product's staging
// and A tiles
template <typename T>
__host__ __device__ constexpr int gram_offset_floats() {
  return (std::is_same<T, __nv_bfloat16>::value ? kSmemBf16 : kSmemF32) / 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xattn_i2t_kernel(const T* __restrict__ img,        // (Ni, 36, D)
                 const T* __restrict__ cap,        // (Nc, L, D), zero at padded words
                 const float* __restrict__ imn,    // (Ni, 36) region norms
                 const float* __restrict__ mask,   // (Nc, L)
                 const float* __restrict__ gram,   // (Nc, L, L) word Grams
                 float* __restrict__ out,          // (Ni, Nc)
                 int Ni, int Nc, int L, int D, int caps_per_block, int n_groups,
                 float lambda_lse, float lambda_softmax, int agg_mean) {
  // staged chunks of D during the product, then the fp32 A tiles
  // [kImgs * kRPad][kLdA]; after them the group's word Grams
  // [caps_per_block][L][L]
  extern __shared__ __align__(128) float smem[];
  float* tile = smem;
  float* gram_s = smem + gram_offset_floats<T>();
  __shared__ float inv_rden[kImgs][kCols];
  __shared__ float row_sim[kImgs][kR][kMaxCaps];

  const int tid = threadIdx.x;
  int i0, c0;
  block_origin(Ni, caps_per_block, n_groups, &i0, &c0);
  const int ncols = caps_per_block * L;
  const int gram_len = L * L;

  product(img, i0, Ni, cap, c0, ncols, Nc, L, D, tile);
  for (int idx = tid; idx < caps_per_block * gram_len; idx += kThreads) {
    const int c = c0 + idx / gram_len;
    gram_s[idx] = c < Nc ? gram[(size_t)c0 * gram_len + idx] : 0.0f;
  }
  __syncthreads();

  // clipped l2norm over the regions: one (image, word column) per thread
  {
    const int p = tid / kCols, col = tid % kCols;
    const float* a_col = tile + p * kRPad * kLdA + col;
    float ss = 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float a = a_col[r * kLdA];
      const float h = a > 0.0f ? a : 0.1f * a;
      ss = fmaf(h, h, ss);
    }
    inv_rden[p][col] = 1.0f / (sqrtf(fmaxf(ss, 1e-16f)) + kEps);
  }
  __syncthreads();

  // one (image, region, caption) per thread: the softmax over the caption's
  // words, the numerator and the context norm.  The thread owns the row
  // segment A[r, caption's words] and overwrites it with s.
  for (int idx = tid; idx < kImgs * kR * caps_per_block; idx += kThreads) {
    const int p = idx / (kR * caps_per_block);
    const int cc = idx / kR % caps_per_block, r = idx % kR, c = c0 + cc;
    if (c >= Nc || i0 + p >= Ni) continue;
    float* a_row = tile + (p * kRPad + r) * kLdA + cc * L;
    const float* m = mask + (size_t)c * L;
    const float* inv = inv_rden[p] + cc * L;
    float den = 0.0f, num = 0.0f;
    for (int l = 0; l < L; ++l) {
      const float a = a_row[l];
      const float h = a > 0.0f ? a : 0.1f * a;
      const float e = expf(h * inv[l] * lambda_softmax) * m[l];
      den += e;
      num = fmaf(e, a, num);
      a_row[l] = e;
    }
    const float inv_sum = 1.0f / fmaxf(den, 1e-30f);
    for (int l = 0; l < L; ++l) a_row[l] *= inv_sum;
    // ctx = s^T G_c s
    const float* g = gram_s + cc * gram_len;
    float ctx = 0.0f;
    for (int l = 0; l < L; ++l) {
      float y = 0.0f;
      for (int k = 0; k < L; ++k) y = fmaf(g[l * L + k], a_row[k], y);
      ctx = fmaf(a_row[l], y, ctx);
    }
    row_sim[p][r][cc] = num * inv_sum /
        fmaxf(sqrtf(fmaxf(ctx, 1e-16f)) * imn[(size_t)(i0 + p) * kR + r], kEps);
  }
  __syncthreads();

  // aggregate each (image, caption) over the 36 regions
  if (tid < kImgs * caps_per_block) {
    const int p = tid / caps_per_block, cc = tid % caps_per_block, c = c0 + cc;
    if (c < Nc && i0 + p < Ni) {
      float acc = 0.0f;
      for (int r = 0; r < kR; ++r) {
        const float v = row_sim[p][r][cc];
        acc += agg_mean ? v : expf(v * lambda_lse);
      }
      out[(size_t)(i0 + p) * Nc + c] = agg_mean ? acc / kR : logf(acc) / lambda_lse;
    }
  }
}

template <typename T>
int run(const void* img, const void* cap, const void* imn, const void* mask,
        const void* gram, void* out, int Ni, int Nc, int L, int D,
        float lambda_lse, float lambda_softmax, int agg_mean, cudaStream_t stream) {
  if (L < 1 || L > kCols) return (int)cudaErrorInvalidValue;
  if (std::is_same<T, __nv_bfloat16>::value && D % 8 != 0) return (int)cudaErrorInvalidValue;
  const int cpb = caps_per_block(L);
  const int n_groups = (Nc + cpb - 1) / cpb;
  const long long n_blocks = (long long)n_groups * ((Ni + kImgs - 1) / kImgs);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the Grams of a group: cpb * L^2 <= 128 L floats, 64 KB at L = 128
  const int smem = (gram_offset_floats<T>() + cpb * L * L) * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      xattn_i2t_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  xattn_i2t_kernel<T><<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(cap),
      static_cast<const float*>(imn), static_cast<const float*>(mask),
      static_cast<const float*>(gram), static_cast<float*>(out), Ni, Nc, L, D, cpb,
      n_groups, lambda_lse, lambda_softmax, agg_mean);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img (Ni, 36, D) and cap (Nc, L, D) both fp32 or both bf16 (bf16 != 0; then
// D % 8 == 0 and both 16-byte aligned), captions zero at padded words; imn
// (Ni, 36) fp32 region norms; mask (Nc, L) fp32; gram (Nc, L, L) fp32 word
// Grams of the zeroed captions; out (Ni, Nc) fp32.  One launch on `stream` of
// CUDA device `device`; returns cudaGetLastError().  1 <= L <= 128.
int itrx_xattn_i2t(const void* img, const void* cap, const void* imn, const void* mask,
                   const void* gram, void* out, int Ni, int Nc, int L, int D, int bf16,
                   float lambda_lse, float lambda_softmax, int agg_mean, int device,
                   void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return run<__nv_bfloat16>(img, cap, imn, mask, gram, out, Ni, Nc, L, D, lambda_lse,
                              lambda_softmax, agg_mean, s);
  }
  return run<float>(img, cap, imn, mask, gram, out, Ni, Nc, L, D, lambda_lse,
                    lambda_softmax, agg_mean, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
