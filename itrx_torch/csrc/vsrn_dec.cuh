// Shared by VSRN's caption-decoder kernels (vsrn_dec.cu, vsrn_dec_bwd.cu):
// the additive attention of one decode step for one batch row (the
// backward's recompute over every row; the forward runs the same arithmetic
// inside its loop), and the GRU gate helpers.  All fp32.
//
//   o_r   = tanh(enc_att_r + hq)                 (R x H)
//   e_r   = o_r . w2,  alpha = softmax_r(e)
//   ctx   = (sum_r alpha_r enc_out_r) * cmask     (H)

#pragma once

#include <cuda_runtime.h>

namespace itrx_vsrn {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxR = 128;      // regions a row may attend over
constexpr int kMaxH = 1024;     // hidden width (the backward stages a row of H)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// One block a row i of hq (n_rows = gridDim.x); its encoder row is i % B.
// Writes ctx row i (the masked context) and, when alpha is not null, the
// softmax weights alpha row i (R).  Every sum runs in a fixed order.
__global__ void __launch_bounds__(kThreads)
attend_kernel(const float* __restrict__ enca, const float* __restrict__ enco,
              const float* __restrict__ hq, const float* __restrict__ w2,
              const float* __restrict__ cmask, float* __restrict__ ctx,
              float* __restrict__ alpha, int B, int R, int H) {
  __shared__ float e[kMaxR];
  const size_t i = blockIdx.x;
  const size_t b = i % B;
  const float* ea = enca + b * R * H;
  const float* eo = enco + b * R * H;
  const float* q = hq + i * H;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < R; r += kWarps) {
    float s = 0.0f;
    for (int j = lane; j < H; j += 32) s = fmaf(tanhf(ea[(size_t)r * H + j] + q[j]), w2[j], s);
    s = warp_sum(s);
    if (lane == 0) e[r] = s;
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -3.0e38f;
    for (int r = lane; r < R; r += 32) mx = fmaxf(mx, e[r]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int r = lane; r < R; r += 32) {
      const float p = expf(e[r] - mx);
      e[r] = p;
      sum += p;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int r = lane; r < R; r += 32) {
      e[r] *= inv;
      if (alpha != nullptr) alpha[i * R + r] = e[r];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += kThreads) {
    float c = 0.0f;
    for (int r = 0; r < R; ++r) c = fmaf(e[r], eo[(size_t)r * H + j], c);
    ctx[i * H + j] = c * cmask[i * H + j];
  }
}

}  // namespace itrx_vsrn
