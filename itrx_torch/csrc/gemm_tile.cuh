// A generic fp32 tile product with loaders and a store given as functors:
// used by the VSRN decoder's forward (vsrn_dec.cu) for its per-step
// products.  A block of 256 threads computes one 64 x 64 tile of C over a
// range of the depth, staged 16 at a time in shared memory.

#pragma once

#include <cuda_runtime.h>

namespace itrx_gemm {

constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

// C (M x N) tile at (m0, n0) = sum over k in [k_begin, k_end) of a(m, k)
// b(k, n); st(m, n, value) for each element inside M x N.  4 x 4 outputs a
// thread.  kAMFast: a's m index is the contiguous one (else k is).
template <bool kAMFast, typename LoadA, typename LoadB, typename Store>
__device__ __forceinline__ void gemm_tile(float (*As)[kBM], float (*Bs)[kBN], int M, int N,
                                          int k_begin, int k_end, int m0, int n0, LoadA la,
                                          LoadB lb, Store st) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + kGemmThreads * j;
      const int m = kAMFast ? idx % kBM : idx / kBK;
      const int k = kAMFast ? idx / kBM : idx % kBK;
      As[k][m] = (m0 + m < M && k0 + k < k_end) ? la(m0 + m, k0 + k) : 0.0f;
      const int kb = idx / kBN, n = idx % kBN;
      Bs[kb][n] = (n0 + n < N && k0 + kb < k_end) ? lb(k0 + kb, n0 + n) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) st(m, n, acc[i][j]);
    }
}

}  // namespace itrx_gemm
