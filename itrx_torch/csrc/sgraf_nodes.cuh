// The alignment nodes of SGRAF's kernels: their assembly, shared by the
// evaluation kernels (sgraf_eval_saf.cu, sgraf_eval_sgr.cu) and the training
// alignment kernels (sgraf_align.cu, sgraf_align_bwd.cu).  For caption c
// (L words, mask m) and image i (36 regions):
//   A[r, l]  = img_ir . cap_cl                              (fp32 accumulation)
//   h        = leaky_relu(A, 0.1) * m_l
//   s[l, :]  = softmax_r(9 h[l, :] / (sqrt(max(sum_l h^2, 1e-16)) + 1e-8))
//   ctx_l    = sum_r s[l, r] img_ir,  |ctx_l|^2 = s G_i s^T  (G_i the region Gram)
//   node_l   = l2norm(W^T (ctx_l / (|ctx_l| + 1e-8) - cap_cl)^2 + b)   valid words
//   node_0   = l2norm(Wg^T (img_glo_i - cap_glo_c)^2 + bg)             the global node
// with l2norm(y) = y / (sqrt(max(|y|^2, 1e-16)) + 1e-8).
//
// A block takes the tiling of the SCAN kernels (a pair of images and a group
// of whole captions) and forms both images' A tiles with the shared product of
// xattn_product.cuh (tensor cores for bf16 inputs, fp32 FMAs for fp32).
// `assemble` runs the region softmax with one thread per (image, word), writes
// the softmax weights over the A tile with the context norm from the Gram, and
// lists the valid (image, word) rows, then the pairs' global rows.  Every
// kernel that forms nodes projects those rows with the split-bf16
// tensor-core products of sgraf_nodes_mma.cuh.  Padded words, ragged
// captions and a group past Nc are masked, not padded.

#pragma once

#include "xattn_product.cuh"

namespace itrx_sgraf {

using namespace itrx_xattn;

constexpr int kMaxS = 256;                  // sim_dim at most (the published 256)
constexpr int kMaxPairs = kImgs * kMaxCaps;
constexpr int kMaxRows = kImgs * kCols + kMaxPairs;
constexpr float kLambda = 9.0f;

// dynamic shared memory, in floats: the A / softmax tiles (and the product's
// staging), then the chain's scratch (its Grams and norm inverses)
constexpr int kTileRegion = kSmemF32 / 4;
constexpr int kXFloats = 2 * 32 * kMaxS;
static_assert(kSmemBf16 <= kSmemF32, "the bf16 product's stages fit the tile region");
static_assert(kImgs * kR * kR + kImgs * kR * kMaxCaps <= kXFloats, "chain scratch fits");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// is (image p, word column col) of the block a valid word
__device__ __forceinline__ bool word_valid(int p, int col, int i0, int c0, int ncols, int Ni,
                                           int Nc, int L, const float* __restrict__ mask) {
  const int c = c0 + col / L;
  return col < ncols && c < Nc && i0 + p < Ni && mask[(size_t)c * L + col % L] > 0.0f;
}

// The block's node state: its dynamic shared memory regions, the static
// arrays of the chain, and the row counts.
struct Nodes {
  float* tile;    // [kImgs * kRPad][kLdA]: A, then the softmax weights
  float* xbuf;    // the chain's scratch
  float* cinv;    // [kImgs * kCols] inverse context norms
  int* rows;      // [kMaxRows] row codes
  int* n_rows;    // [2] (valid words, valid pairs), set by assemble
};

__device__ __forceinline__ Nodes node_smem(float* smem, float* cinv, int* rows, int* n_rows) {
  return Nodes{smem, smem + kTileRegion, cinv, rows, n_rows};
}

// The pair of row code `code`: p * kMaxCaps + cc
__device__ __forceinline__ int pair_of(int code, int L) {
  return code >= kImgs * kCols ? code - kImgs * kCols
                               : code / kCols * kMaxCaps + code % kCols / L;
}

// The A tiles, the region softmax written over them, the inverse context norms
// and the rows: valid (image, word) codes p * kCols + col in order, then the
// pairs' global rows kImgs * kCols + p * kMaxCaps + cc; their counts in
// nd.n_rows.  Ends synchronized.
template <typename T>
__device__ void assemble(const Nodes& nd, const T* __restrict__ cap,
                         const float* __restrict__ mask, const T* __restrict__ img,
                         const float* __restrict__ gram, int i0, int c0, int cpb, int Ni,
                         int Nc, int L, int D) {
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int ncols = cpb * L;

  product(img, i0, Ni, cap, c0, ncols, Nc, L, D, nd.tile);
  float* gram_s = nd.xbuf;                      // [kImgs][kR * kR]
  float* inv_den = nd.xbuf + kImgs * kR * kR;   // [kImgs][kR][kMaxCaps]
  for (int idx = tid; idx < kImgs * kR * kR; idx += kThreads) {
    const int p = idx / (kR * kR);
    gram_s[idx] = i0 + p < Ni ? gram[(size_t)i0 * kR * kR + idx] : 0.0f;
  }
  __syncthreads();

  // clipped l2norm denominators, per (image, region, caption) over the valid words
  for (int idx = tid; idx < kImgs * kR * cpb; idx += kThreads) {
    const int p = idx / (kR * cpb), r = idx / cpb % kR;
    const int cc = idx % cpb, c = c0 + cc;
    float ss = 0.0f;
    if (c < Nc && i0 + p < Ni) {
      const float* a_row_p = nd.tile + (p * kRPad + r) * kLdA + cc * L;
      for (int l = 0; l < L; ++l) {
        const float a = a_row_p[l];
        const float h = (a > 0.0f ? a : 0.1f * a) * mask[(size_t)c * L + l];
        ss = fmaf(h, h, ss);
      }
    }
    inv_den[(p * kR + r) * kMaxCaps + cc] = 1.0f / (sqrtf(fmaxf(ss, 1e-16f)) + kEps);
  }
  __syncthreads();

  // one (image, word) per thread: the region softmax over the A column,
  // written back over it, and the inverse context norm s G s^T
  {
    const int p = tid / kCols, col = tid % kCols;
    if (word_valid(p, col, i0, c0, ncols, Ni, Nc, L, mask)) {
      const int cc = col / L;
      float* a_col = nd.tile + p * kRPad * kLdA + col;
      const float m = mask[(size_t)(c0 + cc) * L + col % L];
      float s[kR];
      float mx = -3.0e38f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float a = a_col[r * kLdA];
        const float h = (a > 0.0f ? a : 0.1f * a) * m;
        s[r] = h * inv_den[(p * kR + r) * kMaxCaps + cc] * kLambda;
        mx = fmaxf(mx, s[r]);
      }
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        s[r] = expf(s[r] - mx);
        sum += s[r];
      }
      const float inv_sum = 1.0f / sum;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        s[r] *= inv_sum;
        a_col[r * kLdA] = s[r];
      }
      const float4* g4 = reinterpret_cast<const float4*>(gram_s + p * kR * kR);
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
      nd.cinv[tid] = 1.0f / (sqrtf(fmaxf(ctx, 1e-16f)) + kEps);
    }
  }

  if (warp == 0) {
    int n = 0;
    for (int j = 0; j < kImgs * kCols; j += 32) {
      const int t = j + lane;
      const bool ok = word_valid(t / kCols, t % kCols, i0, c0, ncols, Ni, Nc, L, mask);
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) nd.rows[n + __popc(bal & ((1u << lane) - 1u))] = t;
      n += __popc(bal);
    }
    const int n_loc = n;
    for (int j = 0; j < kMaxPairs; j += 32) {
      const int q = j + lane, p = q / kMaxCaps, cc = q % kMaxCaps;
      const bool ok = cc < cpb && c0 + cc < Nc && i0 + p < Ni;
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) nd.rows[n + __popc(bal & ((1u << lane) - 1u))] = kImgs * kCols + q;
      n += __popc(bal);
    }
    if (lane == 0) {
      nd.n_rows[0] = n_loc;
      nd.n_rows[1] = n - n_loc;
    }
  }
  __syncthreads();
}

}  // namespace itrx_sgraf
