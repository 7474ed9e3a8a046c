// SGRAF-SAF evaluation scores for sm_90a.
//
// Replaces itrx/ops/pallas/sgraf_eval.py::_eval_saf_kernel.  For caption c
// (L words, mask m) and image i (36 regions):
//   A[r, l]  = img_ir . cap_cl                              (fp32 accumulation)
//   h        = leaky_relu(A, 0.1) * m_l
//   s[l, :]  = softmax_r(9 h[l, :] / (sqrt(max(sum_l h^2, 1e-16)) + 1e-8))
//   ctx_l    = sum_r s[l, r] img_ir,  |ctx_l|^2 = s G_i s^T  (G_i the region Gram)
//   node_l   = l2norm(W^T (ctx_l / (|ctx_l| + 1e-8) - cap_cl)^2 + b)   valid words
//   node_0   = l2norm(Wg^T (img_glo_i - cap_glo_c)^2 + bg)             the global node
//   a_n      = sigmoid(node_n . awf + abf)      (SAF's gate, eval BatchNorm folded in)
//   saf      = sum_n a_n node_n / (sum_n a_n + 1e-8)
//   score    = sigmoid(ew . saf / (sqrt(max(|saf|^2, 1e-16)) + 1e-8) + eb)
// with l2norm(y) = y / (sqrt(max(|y|^2, 1e-16)) + 1e-8).  Only the fp32 score
// per pair reaches device memory.
//
// What bounds it here: the projection of the word nodes, D x S multiply-adds
// per valid word (about 78% of the operations at D 1024, S 256), then the A
// and context products (36 x D each per word) and the global node (D x S per
// pair).
// Design: one block per (pair of images, group of whole captions), the tiling
// of the SCAN kernels.  The block forms both images' A tiles with the shared
// product of xattn_product.cuh (tensor cores for bf16 inputs, fp32 FMAs for
// fp32), runs the region softmax with one thread per (image, word) and writes
// the softmax weights over the A tile, with the context norm from the Gram.
// The valid (image, word) rows are then listed and projected 64 at a time
// (the pairs' global rows last): over slabs of 32 of D, the block stages the
// slab of W (D x S, fp32; cp.async, the next slab's copy running during this
// slab's product) and of both images in shared memory, forms the slab of
// squared differences of its rows there (the context is never stored), and
// accumulates y = diff . W in registers, a 32 x 2 corner of the 64 x S tile
// per thread.  Each tile ends with the row norms, the SAF gates
// and the pooled sums per pair, added in a fixed order (no atomics, so a
// grid is the same on every run), and the block ends with one warp per pair
// for the epilogue.  Every step after reading the inputs is fp32.  Padded
// words, ragged captions and a group past Nc are masked here, not padded.
#include "xattn_product.cuh"

namespace {

using namespace itrx_xattn;

constexpr int kMaxS = 256;                  // sim_dim at most (the published 256)
constexpr int kTileRows = 64;               // rows of one projection tile
constexpr int kKS = 32;                     // slab of D
constexpr int kLdD = kTileRows + 4;         // row stride of the transposed diff slab
constexpr int kMaxPairs = kImgs * kMaxCaps;
constexpr int kMaxRows = kImgs * kCols + kMaxPairs;
constexpr float kLambda = 9.0f;

// dynamic shared memory, in floats: the A / softmax tiles (and the product's
// staging), the two W slab buffers (first the chain's Grams and norm
// inverses), the image slab, the transposed diff slab and the pooled sums per
// pair
constexpr int kTileRegion = kSmemF32 / 4;
constexpr int kWSlab = kKS * kMaxS;
constexpr int kXFloats = 2 * kWSlab;
constexpr int kImgSlab = kImgs * kR * kKS;
constexpr int kDiffFloats = kKS * kLdD;
constexpr int kSafFloats = kMaxPairs * kMaxS;
constexpr int kSmemBytes = (kTileRegion + kXFloats + kImgSlab + kDiffFloats + kSafFloats) * 4;
static_assert(kSmemBf16 <= kSmemF32, "the bf16 product's stages fit the tile region");
static_assert(kImgs * kR * kR + kImgs * kR * kMaxCaps <= kXFloats, "chain scratch fits");
static_assert(kThreads == 4 * kTileRows && kThreads == 2 * (kMaxS / 2), "thread maps");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// slab [k0, k0 + kKS) of the (D, S) weight into w_s [kKS][kMaxS] by cp.async,
// rows past D zero; one commit group.  S % 4 == 0.
__device__ __forceinline__ void stage_w(float* w_s, const float* __restrict__ wmat, int k0,
                                        int D, int S) {
  const int vecs = S / 4;
  for (int idx = threadIdx.x; idx < kKS * vecs; idx += kThreads) {
    const int k = idx / vecs, v = idx % vecs;
    const bool ok = k0 + k < D;
    cp_async16(w_s + k * kMaxS + 4 * v, ok ? wmat + (size_t)(k0 + k) * S + 4 * v : wmat, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// is (image p, word column col) of the block a valid word
__device__ __forceinline__ bool word_valid(int p, int col, int i0, int c0, int ncols, int Ni,
                                           int Nc, int L, const float* __restrict__ mask) {
  const int c = c0 + col / L;
  return col < ncols && c < Nc && i0 + p < Ni && mask[(size_t)c * L + col % L] > 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sgraf_eval_saf_kernel(const T* __restrict__ cap,        // (Nc, L, D)
                      const float* __restrict__ mask,   // (Nc, L)
                      const T* __restrict__ img,        // (Ni, 36, D)
                      const float* __restrict__ gram,   // (Ni, 36, 36)
                      const T* __restrict__ gloc,       // (Nc, D) caption global embeddings
                      const T* __restrict__ imgglo,     // (Ni, D) image global embeddings
                      const float* __restrict__ wt,     // (D, S) sim_tranloc_w
                      const float* __restrict__ bias,   // (S,)
                      const float* __restrict__ gwt,    // (D, S) sim_tranglo_w
                      const float* __restrict__ gbias,  // (S,)
                      const float* __restrict__ awf,    // (S,) folded SAF gate
                      const float* __restrict__ abf,    // (1,)
                      const float* __restrict__ ew,     // (S,) sim_eval_w
                      const float* __restrict__ eb,     // (1,)
                      float* __restrict__ out,          // (Nc, Ni)
                      int Ni, int Nc, int L, int D, int S, int cpb, int n_groups) {
  extern __shared__ __align__(128) float smem[];
  float* tile = smem;                        // [kImgs * kRPad][kLdA]: A, then s
  float* xbuf = smem + kTileRegion;          // chain scratch, then two W slabs [kKS][kMaxS]
  float* img_s = xbuf + kXFloats;            // [kImgs][kR][kKS]
  float* diff_t = img_s + kImgSlab;          // [kKS][kLdD]
  float* saf_acc = diff_t + kDiffFloats;     // [kMaxPairs][kMaxS]
  __shared__ float cinv[kImgs * kCols];
  __shared__ int rows[kMaxRows];
  __shared__ float red_sq[4][kTileRows];
  __shared__ float red_lg[4][kTileRows];
  __shared__ float a_row[kTileRows];
  __shared__ float yinv_row[kTileRows];
  __shared__ float l1_acc[kMaxPairs];
  __shared__ int n_rows_s[2];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  int i0, c0;
  block_origin(Ni, cpb, n_groups, &i0, &c0);
  const int ncols = cpb * L;

  product(img, i0, Ni, cap, c0, ncols, Nc, L, D, tile);
  float* gram_s = xbuf;                      // [kImgs][kR * kR]
  float* inv_den = xbuf + kImgs * kR * kR;   // [kImgs][kR][kMaxCaps]
  for (int idx = tid; idx < kImgs * kR * kR; idx += kThreads) {
    const int p = idx / (kR * kR);
    gram_s[idx] = i0 + p < Ni ? gram[(size_t)i0 * kR * kR + idx] : 0.0f;
  }
  for (int idx = tid; idx < kSafFloats; idx += kThreads) saf_acc[idx] = 0.0f;
  if (tid < kMaxPairs) l1_acc[tid] = 0.0f;
  __syncthreads();

  // clipped l2norm denominators, per (image, region, caption) over the valid words
  for (int idx = tid; idx < kImgs * kR * cpb; idx += kThreads) {
    const int p = idx / (kR * cpb), r = idx / cpb % kR;
    const int cc = idx % cpb, c = c0 + cc;
    float ss = 0.0f;
    if (c < Nc && i0 + p < Ni) {
      const float* a_row_p = tile + (p * kRPad + r) * kLdA + cc * L;
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
      float* a_col = tile + p * kRPad * kLdA + col;
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
      cinv[tid] = 1.0f / (sqrtf(fmaxf(ctx, 1e-16f)) + kEps);
    }
  }

  // the rows: valid (image, word) codes p * kCols + col in order, then the
  // pairs' global rows kImgs * kCols + p * kMaxCaps + cc
  if (warp == 0) {
    int n = 0;
    for (int j = 0; j < kImgs * kCols; j += 32) {
      const int t = j + lane;
      const bool ok = word_valid(t / kCols, t % kCols, i0, c0, ncols, Ni, Nc, L, mask);
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) rows[n + __popc(bal & ((1u << lane) - 1u))] = t;
      n += __popc(bal);
    }
    const int n_loc = n;
    for (int j = 0; j < kMaxPairs; j += 32) {
      const int q = j + lane, p = q / kMaxCaps, cc = q % kMaxCaps;
      const bool ok = cc < cpb && c0 + cc < Nc && i0 + p < Ni;
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) rows[n + __popc(bal & ((1u << lane) - 1u))] = kImgs * kCols + q;
      n += __popc(bal);
    }
    if (lane == 0) {
      n_rows_s[0] = n_loc;
      n_rows_s[1] = n - n_loc;
    }
  }
  __syncthreads();
  const int n_loc = n_rows_s[0], n_glo = n_rows_s[1];

  // thread maps of a tile: the diff slab, one row and 8 of the slab's 32
  // columns per thread; the product, rows 32h .. 32h+31 x columns 2cp, 2cp+1
  const int drow = tid % kTileRows, dk = (tid / kTileRows) * 8;
  const int h = tid / (kThreads / 2), cp = tid % (kThreads / 2);
  const bool col_ok = 2 * cp < S;

  for (int phase = 0; phase < 2; ++phase) {
    const bool glo = phase == 1;
    const int r_begin = glo ? n_loc : 0, r_end = glo ? n_loc + n_glo : n_loc;
    const float* wmat = glo ? gwt : wt;
    const float* bvec = glo ? gbias : bias;
    for (int t0 = r_begin; t0 < r_end; t0 += kTileRows) {
      const int nrows = min(kTileRows, r_end - t0);
      // this thread's diff row
      const bool row_ok = drow < nrows;
      const int code = row_ok ? rows[t0 + drow] : 0;
      int p = 0;
      const T* cap_row = cap;
      const T* ig_row = imgglo;
      const T* cg_row = gloc;
      const float* s_col = tile;  // the row's softmax weights, stride kLdA
      float ci = 0.0f;
      if (!glo) {
        p = code / kCols;
        const int col = code % kCols;
        cap_row = cap + ((size_t)(c0 + col / L) * L + col % L) * D;
        s_col = tile + p * kRPad * kLdA + col;
        ci = row_ok ? cinv[code] : 0.0f;
      } else {
        const int q = row_ok ? code - kImgs * kCols : 0;
        p = q / kMaxCaps;
        ig_row = imgglo + (size_t)(i0 + p) * D;
        cg_row = gloc + (size_t)(c0 + q % kMaxCaps) * D;
      }
      const bool half_active = 32 * h < nrows;
      float acc[32][2];
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[r][0] = acc[r][1] = 0.0f;

      stage_w(xbuf, wmat, 0, D, S);
      for (int k0 = 0, si = 0; k0 < D; k0 += kKS, ++si) {
        __syncthreads();  // the previous slab's readers are done
        const float* w_s = xbuf + (si & 1) * kWSlab;
        if (k0 + kKS < D) {
          stage_w(xbuf + ((si + 1) & 1) * kWSlab, wmat, k0 + kKS, D, S);
          asm volatile("cp.async.wait_group 1;\n" ::);
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::);
        }
        if (!glo) {
          for (int idx = tid; idx < kImgSlab; idx += kThreads) {
            const int pr = idx / kKS, k = idx % kKS, pp = pr / kR;
            img_s[idx] = (i0 + pp < Ni && k0 + k < D)
                             ? to_f(img[((size_t)i0 * kR + pr) * D + k0 + k]) : 0.0f;
          }
        }
        __syncthreads();
        // the squared differences of this thread's row and 8 columns
        float dv[8];
        if (!glo) {
#pragma unroll
          for (int j = 0; j < 8; ++j) dv[j] = 0.0f;
          const float* im = img_s + p * kR * kKS + dk;
#pragma unroll 6
          for (int r = 0; r < kR; ++r) {
            const float sr = row_ok ? s_col[r * kLdA] : 0.0f;
            const float4 u = *reinterpret_cast<const float4*>(im + r * kKS);
            const float4 v = *reinterpret_cast<const float4*>(im + r * kKS + 4);
            dv[0] = fmaf(sr, u.x, dv[0]);
            dv[1] = fmaf(sr, u.y, dv[1]);
            dv[2] = fmaf(sr, u.z, dv[2]);
            dv[3] = fmaf(sr, u.w, dv[3]);
            dv[4] = fmaf(sr, v.x, dv[4]);
            dv[5] = fmaf(sr, v.y, dv[5]);
            dv[6] = fmaf(sr, v.z, dv[6]);
            dv[7] = fmaf(sr, v.w, dv[7]);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int kk = k0 + dk + j;
            const float e = (row_ok && kk < D) ? dv[j] * ci - to_f(cap_row[kk]) : 0.0f;
            dv[j] = e * e;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int kk = k0 + dk + j;
            const float e = (row_ok && kk < D) ? to_f(ig_row[kk]) - to_f(cg_row[kk]) : 0.0f;
            dv[j] = e * e;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) diff_t[(dk + j) * kLdD + drow] = dv[j];
        __syncthreads();
        // y[rows of half h][2cp, 2cp+1] += diff . W over the slab
        if (half_active && col_ok) {
#pragma unroll 4
          for (int k = 0; k < kKS; ++k) {
            const float2 w = *reinterpret_cast<const float2*>(w_s + k * kMaxS + 2 * cp);
            const float4* d4 = reinterpret_cast<const float4*>(diff_t + k * kLdD + 32 * h);
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const float4 d = d4[q];
              acc[4 * q][0] = fmaf(d.x, w.x, acc[4 * q][0]);
              acc[4 * q][1] = fmaf(d.x, w.y, acc[4 * q][1]);
              acc[4 * q + 1][0] = fmaf(d.y, w.x, acc[4 * q + 1][0]);
              acc[4 * q + 1][1] = fmaf(d.y, w.y, acc[4 * q + 1][1]);
              acc[4 * q + 2][0] = fmaf(d.z, w.x, acc[4 * q + 2][0]);
              acc[4 * q + 2][1] = fmaf(d.z, w.y, acc[4 * q + 2][1]);
              acc[4 * q + 3][0] = fmaf(d.w, w.x, acc[4 * q + 3][0]);
              acc[4 * q + 3][1] = fmaf(d.w, w.y, acc[4 * q + 3][1]);
            }
          }
        }
      }

      // bias, then per row |y|^2 and y . awf, reduced over the S columns
      const float b0 = col_ok ? bvec[2 * cp] : 0.0f, b1 = col_ok ? bvec[2 * cp + 1] : 0.0f;
      const float g0 = col_ok ? awf[2 * cp] : 0.0f, g1 = col_ok ? awf[2 * cp + 1] : 0.0f;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        acc[r][0] = col_ok ? acc[r][0] + b0 : 0.0f;
        acc[r][1] = col_ok ? acc[r][1] + b1 : 0.0f;
        const float sq = warp_sum(acc[r][0] * acc[r][0] + acc[r][1] * acc[r][1]);
        const float lg = warp_sum(acc[r][0] * g0 + acc[r][1] * g1);
        if (lane == 0) {
          red_sq[warp % 4][32 * h + r] = sq;
          red_lg[warp % 4][32 * h + r] = lg;
        }
      }
      __syncthreads();
      if (tid < nrows) {
        const float sq = ((red_sq[0][tid] + red_sq[1][tid]) + red_sq[2][tid]) + red_sq[3][tid];
        const float lg = ((red_lg[0][tid] + red_lg[1][tid]) + red_lg[2][tid]) + red_lg[3][tid];
        const float yinv = 1.0f / (sqrtf(fmaxf(sq, 1e-16f)) + kEps);
        a_row[tid] = 1.0f / (1.0f + expf(-(lg * yinv + abf[0])));
        yinv_row[tid] = yinv;
      }
      __syncthreads();
      // pooled sums per pair: half 0's rows, then half 1's, each in row order
      for (int hh = 0; hh < 2; ++hh) {
        if (h == hh && col_ok) {
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            const int tr = 32 * h + r;
            if (tr < nrows) {
              const int rc = rows[t0 + tr];
              const int pair = rc >= kImgs * kCols
                                   ? rc - kImgs * kCols
                                   : rc / kCols * kMaxCaps + rc % kCols / L;
              const float coef = a_row[tr] * yinv_row[tr];
              saf_acc[pair * kMaxS + 2 * cp] += coef * acc[r][0];
              saf_acc[pair * kMaxS + 2 * cp + 1] += coef * acc[r][1];
              if (cp == 0) l1_acc[pair] += a_row[tr];
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // per pair: l1 normalization, l2norm, sim_eval_w and the sigmoid
  for (int q = warp; q < kMaxPairs; q += kThreads / 32) {
    const int p = q / kMaxCaps, cc = q % kMaxCaps, c = c0 + cc;
    if (cc >= cpb || c >= Nc || i0 + p >= Ni) continue;
    const float inv_l1 = 1.0f / (l1_acc[q] + kEps);
    float sq = 0.0f, dot = 0.0f;
    for (int col = lane; col < S; col += 32) {
      const float v = saf_acc[q * kMaxS + col] * inv_l1;
      sq = fmaf(v, v, sq);
      dot = fmaf(v, ew[col], dot);
    }
    sq = warp_sum(sq);
    dot = warp_sum(dot);
    if (lane == 0) {
      const float z = dot / (sqrtf(fmaxf(sq, 1e-16f)) + kEps) + eb[0];
      out[(size_t)c * Ni + i0 + p] = 1.0f / (1.0f + expf(-z));
    }
  }
}

template <typename T>
int run(const void* cap, const void* mask, const void* img, const void* gram, const void* gloc,
        const void* imgglo, const void* wt, const void* b, const void* gwt, const void* gb,
        const void* awf, const void* abf, const void* ew, const void* eb, void* out, int Ni,
        int Nc, int L, int D, int S, cudaStream_t stream) {
  if (L < 1 || L > kCols || S < 4 || S > kMaxS || S % 4 != 0 || D < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (std::is_same<T, __nv_bfloat16>::value && D % 8 != 0) return (int)cudaErrorInvalidValue;
  const int cpb = caps_per_block(L);
  const int n_groups = (Nc + cpb - 1) / cpb;
  const long long n_blocks = (long long)n_groups * ((Ni + kImgs - 1) / kImgs);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return (int)cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sgraf_eval_saf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  sgraf_eval_saf_kernel<T><<<(unsigned)n_blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(cap), f(mask), static_cast<const T*>(img), f(gram),
      static_cast<const T*>(gloc), static_cast<const T*>(imgglo), f(wt), f(b), f(gwt), f(gb),
      f(awf), f(abf), f(ew), f(eb), static_cast<float*>(out), Ni, Nc, L, D, S, cpb, n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cap (Nc, L, D), img (Ni, 36, D), gloc (Nc, D) and imgglo (Ni, D) all fp32
// or all bf16 (bf16 != 0; then D % 8 == 0 and cap, img 16-byte aligned);
// mask (Nc, L), gram (Ni, 36, 36), wt and gwt (D, S), b, gb, awf, ew (S,),
// abf, eb (1,) fp32; out (Nc, Ni) fp32.  1 <= L <= 128; S % 4 == 0, S <= 256;
// wt and gwt 16-byte aligned.
// One launch on `stream` of CUDA device `device`; returns cudaGetLastError().
int itrx_sgraf_eval_saf(const void* cap, const void* mask, const void* img, const void* gram,
                        const void* gloc, const void* imgglo, const void* wt, const void* b,
                        const void* gwt, const void* gb, const void* awf, const void* abf,
                        const void* ew, const void* eb, void* out, int Ni, int Nc, int L,
                        int D, int S, int bf16, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return run<__nv_bfloat16>(cap, mask, img, gram, gloc, imgglo, wt, b, gwt, gb, awf, abf, ew,
                              eb, out, Ni, Nc, L, D, S, s);
  }
  return run<float>(cap, mask, img, gram, gloc, imgglo, wt, b, gwt, gb, awf, abf, ew, eb, out,
                    Ni, Nc, L, D, S, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
