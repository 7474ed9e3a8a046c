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
// 36 * L * (2 L + a few) fp32 flops per pair (the context's quadratic form),
// and the A tensor (Ni x Nc x 36 x L) must never reach device memory.
// Design: the tiles, ring and product of the t2i kernel (xattn_wgmma.cuh:
// up to 128 word rows of whole captions x K images from a TMA ring, bf16 on
// wgmma, fp32 as exact fp64 products, a persistent grid).  A loop over the
// tile's images (on a copy of the image's column groups, take_block) runs
// the chain in three steps an image.  On the accumulators, within each
// quad: the clipped l2norm over the image's 36 regions of each word row,
// and the softmax's numerators e = exp(lambda_softmax attn) mask_l (as in
// the TPU kernel, no max subtraction: |attn| <= 1; pad words leave by the
// mask), written with e A to shared memory.  Then one unit of 8 words x
// three regions a thread (at most 16 units: one round): its words' sums of
// e and e A, and e^T (G_c e) over the caption's words (G_c staged in shared
// memory per tile, read as float4 broadcasts).  Then one warp a caption,
// a lane a region: ctx = e^T G_c e / den^2, the row score, and the sum over
// the 36 regions by a fixed shuffle tree.  fp32 throughout after A, in
// fixed orders: repeats are bit-identical.  The per-caption Grams (fp32),
// the region norms and the masked captions come from the wrapper, as in
// the TPU wrapper.
#include "xattn_wgmma.cuh"

namespace {

using namespace itrx_xwg;

// the epilogue's shared memory after the ring, in floats: fixed parts, then
// the group's word Grams [cpb][L][L]
struct Epi {
  static constexpr int kE = 0;                        // [128 words][36] e
  static constexpr int kEA = kE + kRows * kR;         // [128][36] e A
  static constexpr int kDen = kEA + kRows * kR;       // [16 units][36] sums of e
  static constexpr int kNum = kDen + 16 * kR;         // [16][36] sums of e A
  static constexpr int kCtx = kNum + 16 * kR;         // [16][36] e^T G e
  static constexpr int kMask = kCtx + 16 * kR;        // [128] the group's word mask
  static constexpr int kImn = kMask + kRows;          // [6 * 36] the images' region norms
  static constexpr int kGram = kImn + 6 * kR;         // [cpb][L][L]
  static int floats(const Plan& pl) { return kGram + pl.cpb * pl.L * pl.L; }
};

__device__ __forceinline__ float sum_quad(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One image's softmax numerators for this thread's two words (rows h = 0,
// 1) on its block of the accumulators (take_block; parity Odd): the clipped
// l2norm over the image's regions (within the quad), e = exp(lambda_softmax
// attn) mask_l and e A, written to shared memory [word][region].
template <int Odd>
__device__ __forceinline__ void softmax_terms(const float (&blk)[5][4], int t, int rg0, int g,
                                              const float (&m)[2], float lambda_softmax,
                                              float* e_s, float* ea_s) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float ss = 0.0f;
#pragma unroll
    for (int il = 0; il < 5; ++il) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float hv = leaky(blk[il][2 * h + e]);
        if (in_image<Odd>(il, e, t)) ss = fmaf(hv, hv, ss);
      }
    }
    const float inv = 1.0f / (sqrtf(fmaxf(sum_quad(ss), 1e-16f)) + kEps);
    const int row = 8 * (rg0 + h) + g;
#pragma unroll
    for (int il = 0; il < 5; ++il) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (in_image<Odd>(il, e, t)) {
          const float a = blk[il][2 * h + e];
          const float ev = expf(leaky(a) * inv * lambda_softmax) * m[h];
          const int r = 8 * il + 2 * t + e - 4 * Odd;
          e_s[row * kR + r] = ev;
          ea_s[row * kR + r] = ev * a;
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
xattn_i2t_kernel(const __grid_constant__ CUtensorMap cap_map,
                 const __grid_constant__ CUtensorMap img_map, const Plan pl,
                 const float* __restrict__ imn,    // (Ni, 36) region norms
                 const float* __restrict__ mask,   // (Nc, L)
                 const float* __restrict__ gram,   // (Nc, L, L) word Grams
                 float* __restrict__ out,          // (Ni, Nc)
                 float lambda_lse, float lambda_softmax, int agg_mean) {
  constexpr int K = Mode<T>::K, NG = kNG<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Bars bars;
  float* ep;
  Ring rg = setup<T>(smem, pl, bars, &cap_map, &img_map, &ep);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg0 = 2 * (threadIdx.x / 32);  // this warp's first 8-row group
  const int L = pl.L, g8 = L / 8, LL = L * L;
  float* const e_s = ep + Epi::kE;
  float* const ea_s = ep + Epi::kEA;
  float* const den_s = ep + Epi::kDen;
  float* const num_s = ep + Epi::kNum;
  float* const ctx_s = ep + Epi::kCtx;
  const float* const mask_s = ep + Epi::kMask;
  const float* const imn_s = ep + Epi::kImn;
  const float* const gram_s = ep + Epi::kGram;

  for (int item = blockIdx.x; item < pl.n_items; item += gridDim.x) {
    int ig, cg;
    tile_origin(item, pl, &ig, &cg);
    const int i0 = ig * K, c0 = cg * pl.cpb, ncols = pl.cpb * L, units = ncols / 8;
    stage_floats(ep + Epi::kGram, gram + (size_t)c0 * LL, pl.cpb * LL, (pl.Nc - c0) * LL);
    stage_floats(ep + Epi::kMask, mask + (size_t)c0 * L, ncols, (pl.Nc - c0) * L);
    stage_floats(ep + Epi::kImn, imn + (size_t)i0 * kR, K * kR, (pl.Ni - i0) * kR);
    staged_commit();

    float d[NG][4];
    product<T>(d, pl, rg);
    staged_wait();
    tile_sync();
#ifdef ITRX_XATTN_PRODUCT_ONLY
    // phase timer build: the product alone, every accumulator kept live
    {
      float keep = 0.0f;
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) keep += d[i][q];
      if (keep == 1.0f) out[(size_t)i0 * pl.Nc + c0] = keep;
    }
    tile_sync();
    continue;
#endif

    float m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 8 * (rg0 + h) + g;
      m[h] = row < ncols && c0 + row / L < pl.Nc ? mask_s[row] : 0.0f;
    }

#pragma unroll 1
    for (int p = 0; p < K; ++p) {
      float blk[5][4];
      image_block(d, p, blk);
      if (p & 1) {
        softmax_terms<1>(blk, t, rg0, g, m, lambda_softmax, e_s, ea_s);
      } else {
        softmax_terms<0>(blk, t, rg0, g, m, lambda_softmax, e_s, ea_s);
      }
      tile_sync();

      // one unit of 8 words x three regions (r, r + 12, r + 24) a thread
      // (at most 16 units: one round): sums of e and e A, and e^T (G_c e)
      // over those 8 words (G_c symmetric: its row m, columns of the
      // unit's words, read once for the three regions)
      constexpr int kThird = kR / 3;
      for (int it = threadIdx.x; it < units * kThird; it += kThreads) {
        const int u = it / kThird, r = it % kThird, c = u / g8, w0 = c * L, l0 = (u % g8) * 8;
        const float* gc = gram_s + c * LL + l0;
        float y[3][8];
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int j = 0; j < 8; ++j) y[k][j] = 0.0f;
#pragma unroll 2
        for (int mw = 0; mw < L; ++mw) {
          const float* em = e_s + (w0 + mw) * kR + r;
          const float ev[3] = {em[0], em[kThird], em[2 * kThird]};
          const float4 ga = *reinterpret_cast<const float4*>(gc + mw * L);
          const float4 gb = *reinterpret_cast<const float4*>(gc + mw * L + 4);
          const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int k = 0; k < 3; ++k) y[k][j] = fmaf(gv[j], ev[k], y[k][j]);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float den = 0.0f, num = 0.0f, ctx = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int w = (w0 + l0 + j) * kR + r + k * kThird;
            den += e_s[w];
            num += ea_s[w];
            ctx = fmaf(e_s[w], y[k][j], ctx);
          }
          den_s[u * kR + r + k * kThird] = den;
          num_s[u * kR + r + k * kThird] = num;
          ctx_s[u * kR + r + k * kThird] = ctx;
        }
      }
      tile_sync();

      // one warp a caption, a lane a region (and lanes 0-3 a second):
      // its units' sums, the row score, then the sum over the 36 regions
      // (a fixed shuffle tree)
      for (int c = threadIdx.x / 32; c < pl.cpb; c += kThreads / 32) {
        float acc = 0.0f;
        for (int r = lane; r < kR; r += 32) {
          float den = 0.0f, num = 0.0f, ctx = 0.0f;
          for (int j = 0; j < g8; ++j) {
            const int w = (c * g8 + j) * kR + r;
            den += den_s[w];
            num += num_s[w];
            ctx += ctx_s[w];
          }
          const float inv_sum = 1.0f / fmaxf(den, 1e-30f);
          const float rs = num * inv_sum /
              fmaxf(sqrtf(fmaxf(ctx * inv_sum * inv_sum, 1e-16f)) * imn_s[p * kR + r], kEps);
          acc += agg_mean ? rs : expf(rs * lambda_lse);
        }
#ifndef ITRX_XATTN_NO_AGG  // the phase timer's cut: no sum over the regions
#pragma unroll
        for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
#endif
        if (lane == 0 && c0 + c < pl.Nc && i0 + p < pl.Ni) {
          out[(size_t)(i0 + p) * pl.Nc + c0 + c] = agg_mean ? acc / kR : logf(acc) / lambda_lse;
        }
      }
    }
    tile_sync();
  }
}

template <typename T>
int run(const void* img, const void* cap, const void* imn, const void* mask, const void* gram,
        void* out, int Ni, int Nc, int L, int D, float lambda_lse, float lambda_softmax,
        int agg_mean, int device, cudaStream_t stream) {
  return launch<T>(xattn_i2t_kernel<T>, [](const Plan& pl) { return Epi::floats(pl) * 4; }, img, cap, Ni, Nc, L,
                   D, device, stream, static_cast<const float*>(imn),
                   static_cast<const float*>(mask), static_cast<const float*>(gram),
                   static_cast<float*>(out), lambda_lse, lambda_softmax, agg_mean);
}

}  // namespace

extern "C" {

// bf16 != 0: img (Ni, 36, D) and cap (Nc, L, D) bf16; else both fp64 copies
// of the fp32 embeddings.  Rows 16-byte strided and aligned, captions zero
// at padded words, L a multiple of 8 in [8, 128]; imn (Ni, 36) fp32 region norms;
// mask (Nc, L) fp32; gram (Nc, L, L) fp32 word Grams of the zeroed captions;
// out (Ni, Nc) fp32.  One launch on `stream` of CUDA device `device`;
// returns a CUDA error code (cudaGetLastError() after the launch).
int itrx_xattn_i2t(const void* img, const void* cap, const void* imn, const void* mask,
                   const void* gram, void* out, int Ni, int Nc, int L, int D, int bf16,
                   float lambda_lse, float lambda_softmax, int agg_mean, int device,
                   void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return run<__nv_bfloat16>(img, cap, imn, mask, gram, out, Ni, Nc, L, D, lambda_lse,
                              lambda_softmax, agg_mean, device, s);
  }
  return run<float>(img, cap, imn, mask, gram, out, Ni, Nc, L, D, lambda_lse, lambda_softmax,
                    agg_mean, device, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
