// SGRAF alignment nodes in training, the backward, for sm_90a.
//
// Replaces itrx/ops/pallas/sgraf_align.py::_bwd_kernel: for the nodes'
// cotangent g (Nc, Ni, L, S), the exact derivative of the forward
// (sgraf_align.cu) with respect to cap, img, W and b.  Per (caption c,
// image i, valid word l), with e = ctx_n - cap and y = W^T e^2 + b:
//   gy    = g / (|y| + eps) - y (g . y) / ((|y| + eps)^2 |y|)   (l2norm over S)
//   ge    = 2 e (W gy);  dW += gy e^2^T;  db += gy;  dcap -= ge
//   gctx  = ge cinv - ctx_n (ge . ctx_n) / |ctx|                (l2norm over D)
//   gs_r  = gctx . img_r;  dimg_r += s_r gctx
//   gz    = 9 s (gs - s . gs)                                    (softmax over regions)
//   gh    = gz inv_r - h (sum_words gz h) inv_r^2 / |h_r|        (l2norm over words)
//   gA    = (A > 0 ? 1 : 0.1) m gh;  dcap += gA^T img;  dimg += gA cap
// where the second term of each l2norm's backward vanishes if its norm is
// clamped at 1e-8.
//
// What bounds it here: fp32 operations; per valid word and image the
// recomputed forward (A, context, projection), W gy and the dW product (D x S
// each) and four 36 x D products (gs, both dimg terms, dcap).
// Design: five passes over a compact list of rows, one per (caption, image,
// valid word), caption-major (the wrapper ranks the words: row = Ni cstart_c
// + i len_c + rank), with fp32 workspaces in device memory; every sum in a
// fixed order (no atomics), so two calls give identical gradients.
//   1. rows_kernel: the forward's tiling and node assembly (sgraf_nodes.cuh);
//      per 64-row tile the projection, with e written as it is formed, then
//      gy and the row's cinv.
//   2. gdiff_kernel: ge = 2 e (gy W), a 64 x 64 fp32 tile product.
//   3. gw_kernel: [dW | db] = gy^T [e^2 | 1] over 16 fixed splits of the rows
//      (the same tile product), then gw_reduce sums the splits in order.
//   4. ctx_bwd_kernel: one warp per row, gctx.
//   5. region_kernel: per block (pair of images, group of whole captions),
//      the A tiles again, the softmax, gs, the softmax and word-norm
//      backward to gA, then per slab of D the block's dcap (both images
//      summed) and dimg (the group's captions summed) partials;
//      gcap_reduce and gimg_reduce sum the partials over image pairs and
//      caption groups in order and cast to the embeddings' dtype.
#include "gemm_tile.cuh"
#include "sgraf_nodes.cuh"

namespace {

using namespace itrx_gemm;
using namespace itrx_sgraf;

constexpr int kNodeBytes = kNodeFloats * 4;

// The compact rows of the valid (caption, image, word) triples.
struct Rows {
  const int* cstart;  // (Nc,) valid words before each caption
  const int* pos;     // (Nc, L) rank of each valid word in its caption
  int Ni, Nc, L, n_words;

  __device__ __forceinline__ long long row(int c, int i, int l) const {
    const int len = (c + 1 < Nc ? cstart[c + 1] : n_words) - cstart[c];
    return (long long)Ni * cstart[c] + (long long)i * len + pos[c * L + l];
  }
  __device__ __forceinline__ int word(int c, int l) const { return cstart[c] + pos[c * L + l]; }
};

__device__ __forceinline__ float leaky(float a) { return a > 0.0f ? a : 0.1f * a; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------- pass 1
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rows_kernel(const T* __restrict__ cap, const float* __restrict__ mask,
            const T* __restrict__ img, const float* __restrict__ gram,
            const float* __restrict__ wt, const float* __restrict__ bias,
            const T* __restrict__ g, Rows rw, float* __restrict__ gy_out,
            float* __restrict__ e_out, float* __restrict__ cinv_out, int Ni, int Nc, int L,
            int D, int S, int cpb, int n_groups) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float cinv[kImgs * kCols];
  __shared__ int rows[kMaxRows];
  __shared__ int n_rows[2];
  __shared__ float red_sq[4][kTileRows];
  __shared__ float red_gd[4][kTileRows];
  __shared__ float coef_a[kTileRows];
  __shared__ float coef_b[kTileRows];
  const Nodes nd = node_smem(smem, cinv, rows, n_rows);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  int i0, c0;
  block_origin(Ni, cpb, n_groups, &i0, &c0);
  assemble(nd, cap, mask, img, gram, i0, c0, cpb, Ni, Nc, L, D);
  const int n_loc = n_rows[0];
  const int drow = tid % kTileRows;
  const int h = tid / (kThreads / 2), cp = tid % (kThreads / 2);
  const bool col_ok = 2 * cp < S;

  for (int t0 = 0; t0 < n_loc; t0 += kTileRows) {
    const int nrows = min(kTileRows, n_loc - t0);
    // this thread's operand row (the projection's row map of `project`)
    const bool row_ok = drow < nrows;
    const int code = row_ok ? rows[t0 + drow] : 0;
    const int p = code / kCols, col = code % kCols;
    const int c = c0 + col / L, l = col % L;
    const T* cap_row = cap + ((size_t)c * L + l) * D;
    const float* s_col = nd.tile + p * kRPad * kLdA + col;
    const float ci = row_ok ? cinv[code] : 0.0f;
    float* e_row = row_ok ? e_out + rw.row(c, i0 + p, l) * D : e_out;
    const auto stage = [&](int k0) {
      for (int idx = tid; idx < kImgSlab; idx += kThreads) {
        const int pr = idx / kKS, k = idx % kKS, pp = pr / kR;
        nd.img_s[idx] = (i0 + pp < Ni && k0 + k < D)
                            ? to_f(img[((size_t)i0 * kR + pr) * D + k0 + k]) : 0.0f;
      }
    };
    const auto row = [&](int k0, int dk, float (&dv)[8]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) dv[j] = 0.0f;
      const float* im = nd.img_s + p * kR * kKS + dk;
#pragma unroll 6
      for (int r = 0; r < kR; ++r) {
        const float sr = row_ok ? s_col[r * kLdA] : 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) dv[j] = fmaf(sr, im[r * kKS + j], dv[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = k0 + dk + j;
        const bool ok = row_ok && kk < D;
        const float e = ok ? dv[j] * ci - to_f(cap_row[kk]) : 0.0f;
        if (ok) e_row[kk] = e;
        dv[j] = e * e;
      }
    };
    float acc[32][2];
    tile_product(acc, wt, D, S, nd, 32 * h < nrows, stage, row);
    const float b0 = col_ok ? bias[2 * cp] : 0.0f, b1 = col_ok ? bias[2 * cp + 1] : 0.0f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      acc[r][0] = col_ok ? acc[r][0] + b0 : 0.0f;
      acc[r][1] = col_ok ? acc[r][1] + b1 : 0.0f;
    }
    // the cotangent at this thread's two columns of row tr
    const auto g_at = [&](int tr, float* g0, float* g1) {
      const int cd = rows[t0 + tr];
      const int pp = cd / kCols, cl = cd % kCols;
      const T* gr = g + (((size_t)(c0 + cl / L) * Ni + i0 + pp) * L + cl % L) * S + 2 * cp;
      *g0 = to_f(gr[0]);
      *g1 = to_f(gr[1]);
    };
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int tr = 32 * h + r;
      float g0 = 0.0f, g1 = 0.0f;
      if (tr < nrows && col_ok) g_at(tr, &g0, &g1);
      const float sq = warp_sum(acc[r][0] * acc[r][0] + acc[r][1] * acc[r][1]);
      const float gd = warp_sum(acc[r][0] * g0 + acc[r][1] * g1);
      if (lane == 0) {
        red_sq[warp % 4][tr] = sq;
        red_gd[warp % 4][tr] = gd;
      }
    }
    __syncthreads();
    if (tid < nrows) {
      const float sq = ((red_sq[0][tid] + red_sq[1][tid]) + red_sq[2][tid]) + red_sq[3][tid];
      const float gd = ((red_gd[0][tid] + red_gd[1][tid]) + red_gd[2][tid]) + red_gd[3][tid];
      const float ny = sqrtf(fmaxf(sq, 1e-16f));
      const float yinv = 1.0f / (ny + kEps);
      coef_a[tid] = yinv;
      coef_b[tid] = sq > 1e-16f ? gd * yinv * yinv / ny : 0.0f;
      const int cd = rows[t0 + tid];
      const int pp = cd / kCols, cl = cd % kCols;
      cinv_out[rw.row(c0 + cl / L, i0 + pp, cl % L)] = cinv[cd];
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int tr = 32 * h + r;
        if (tr < nrows) {
          float g0, g1;
          g_at(tr, &g0, &g1);
          const int cd = rows[t0 + tr];
          const int pp = cd / kCols, cl = cd % kCols;
          float* dst = gy_out + rw.row(c0 + cl / L, i0 + pp, cl % L) * S + 2 * cp;
          *reinterpret_cast<float2*>(dst) =
              make_float2(g0 * coef_a[tr] - acc[r][0] * coef_b[tr],
                          g1 * coef_a[tr] - acc[r][1] * coef_b[tr]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- pass 2
__global__ void __launch_bounds__(kGemmThreads)
gdiff_kernel(const float* __restrict__ gy, const float* __restrict__ w,
             const float* __restrict__ e, float* __restrict__ ge, int n_rows, int D, int S) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  gemm_tile<false>(
      As, Bs, n_rows, D, 0, S, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int m, int k) { return gy[(size_t)m * S + k]; },
      [&](int k, int n) { return w[(size_t)k * D + n]; },
      [&](int m, int n, float v) {
        const size_t o = (size_t)m * D + n;
        ge[o] = 2.0f * e[o] * v;
      });
}

// ---------------------------------------------------------------- pass 3
__global__ void __launch_bounds__(kGemmThreads)
gw_kernel(const float* __restrict__ gy, const float* __restrict__ e, float* __restrict__ part,
          int n_rows, int D, int S, int per_split) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int z = blockIdx.z;
  const int kb = min(n_rows, z * per_split), ke = min(n_rows, kb + per_split);
  gemm_tile<true>(
      As, Bs, S, D + 1, kb, ke, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int m, int k) { return gy[(size_t)k * S + m]; },
      [&](int k, int n) {
        if (n == D) return 1.0f;
        const float v = e[(size_t)k * D + n];
        return v * v;
      },
      [&](int m, int n, float v) { part[((size_t)z * S + m) * (D + 1) + n] = v; });
}

__global__ void gw_reduce(const float* __restrict__ part, float* __restrict__ gw,
                          float* __restrict__ gb, int S, int D, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_out = (size_t)S * (D + 1);
  if (idx >= n_out) return;
  float sum = 0.0f;
  for (int z = 0; z < splits; ++z) sum += part[(size_t)z * n_out + idx];
  const int m = idx / (D + 1), n = idx % (D + 1);
  if (n < D) {
    gw[(size_t)m * D + n] = sum;
  } else {
    gb[m] = sum;
  }
}

// ---------------------------------------------------------------- pass 4
template <typename T>
__global__ void __launch_bounds__(256)
ctx_bwd_kernel(const T* __restrict__ cap, const float* __restrict__ mask,
               const float* __restrict__ e, const float* __restrict__ ge,
               const float* __restrict__ cinv_rows, Rows rw, float* __restrict__ gctx, int Ni,
               int Nc, int L, int D) {
  const long long w = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long long)Nc * Ni * L) return;
  const int c = w / ((long long)Ni * L), i = (w / L) % Ni, l = w % L;
  if (!(mask[(size_t)c * L + l] > 0.0f)) return;
  const long long row = rw.row(c, i, l);
  const float* er = e + row * D;
  const float* gr = ge + row * D;
  const T* cr = cap + ((size_t)c * L + l) * D;
  float dot = 0.0f;
  for (int k = lane; k < D; k += 32) dot = fmaf(gr[k], er[k] + to_f(cr[k]), dot);
  dot = warp_sum(dot);
  const float ci = cinv_rows[row];
  const float n = 1.0f / ci - kEps;  // |ctx|, clamped at 1e-8
  const float cb = n > 1.0001e-8f ? dot / n : 0.0f;
  float* out = gctx + row * D;
  for (int k = lane; k < D; k += 32) out[k] = gr[k] * ci - (er[k] + to_f(cr[k])) * cb;
}

// ---------------------------------------------------------------- pass 5
constexpr int kSTile = kImgs * kR * kCols;         // softmax weights / gA, [p][r][col]
constexpr int kLdG = kKS + 1;                      // padded row of the staged slabs
constexpr int kGSlab = kImgs * kCols * kLdG;       // gctx slab, [p * kCols + col][k]
constexpr int kCapSlab = kCols * kLdG;             // cap slab, [col][k]
constexpr int kCoef = kImgs * kR * kMaxCaps;       // per (image, region, caption)
constexpr int kATileFloats = kSmemF32 / 4;         // the A product's region
constexpr int kRegionFloats =
    kATileFloats + 2 * kSTile + kGSlab + kImgSlab + kCapSlab + 2 * kCoef;
constexpr int kRegionBytes = kRegionFloats * 4;
constexpr int kOutsPerThread = kImgs * kR * kKS / kThreads;  // dimg outputs per slab
static_assert(kRegionBytes <= 232448 - 4096, "region_kernel's shared memory fits");
static_assert(kCapSlab <= kATileFloats, "the dcap exchange fits the A region");
static_assert(kOutsPerThread * kThreads == kImgs * kR * kKS, "dimg outputs per thread");

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
region_kernel(const T* __restrict__ cap, const float* __restrict__ mask,
              const T* __restrict__ img, const float* __restrict__ ge,
              const float* __restrict__ gctx, Rows rw, float* __restrict__ gcap_p,
              float* __restrict__ gimg_p, int Ni, int Nc, int L, int D, int cpb,
              int n_groups) {
  extern __shared__ __align__(128) float smem[];
  float* a_tile = smem;                     // [p * kRPad + r][kLdA], A
  float* s_tile = smem + kATileFloats;      // [p][r][kCols], softmax weights
  float* g_tile = s_tile + kSTile;          // [p][r][kCols], gattn, then gA
  float* gslab = g_tile + kSTile;           // [p * kCols + col][kLdG]
  float* islab = gslab + kGSlab;            // [p][r][kKS]
  float* cslab = islab + kImgSlab;          // [col][kLdG]
  float* inv_den = cslab + kCapSlab;        // [p][r][kMaxCaps]
  float* coef = inv_den + kCoef;            // [p][r][kMaxCaps]
  float* xch = smem;                        // [col][kLdG], over the A tile once gA is formed
  __shared__ long long row_of[kImgs * kCols];

  const int tid = threadIdx.x;
  int i0, c0;
  block_origin(Ni, cpb, n_groups, &i0, &c0);
  const int ncols = cpb * L;
  const int p = tid / kCols, col = tid % kCols;
  const bool valid = word_valid(p, col, i0, c0, ncols, Ni, Nc, L, mask);
  const int cc = col / L, c = c0 + cc, l = col % L;
  row_of[tid] = valid ? rw.row(c, i0 + p, l) : -1;
  const float m = valid ? mask[(size_t)c * L + l] : 0.0f;

  product(img, i0, Ni, cap, c0, ncols, Nc, L, D, a_tile);
  __syncthreads();

  // per (image, region, caption): the word-norm's inverse and |h|^2
  for (int idx = tid; idx < kImgs * kR * cpb; idx += kThreads) {
    const int p2 = idx / (kR * cpb), r = idx / cpb % kR, c2 = idx % cpb, cg = c0 + c2;
    float ss = 0.0f;
    if (cg < Nc && i0 + p2 < Ni) {
      const float* a_row = a_tile + (p2 * kRPad + r) * kLdA + c2 * L;
      for (int l2 = 0; l2 < L; ++l2) {
        const float hh = leaky(a_row[l2]) * mask[(size_t)cg * L + l2];
        ss = fmaf(hh, hh, ss);
      }
    }
    inv_den[(p2 * kR + r) * kMaxCaps + c2] = 1.0f / (sqrtf(fmaxf(ss, 1e-16f)) + kEps);
    coef[(p2 * kR + r) * kMaxCaps + c2] = ss;
  }
  __syncthreads();

  // the region softmax of this thread's (image, word)
  if (valid) {
    float sv[kR];
    float mx = -3.0e38f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float hh = leaky(a_tile[(p * kRPad + r) * kLdA + col]) * m;
      sv[r] = hh * inv_den[(p * kR + r) * kMaxCaps + cc] * kLambda;
      mx = fmaxf(mx, sv[r]);
    }
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      sv[r] = expf(sv[r] - mx);
      sum += sv[r];
    }
    const float inv_sum = 1.0f / sum;
#pragma unroll
    for (int r = 0; r < kR; ++r) s_tile[(p * kR + r) * kCols + col] = sv[r] * inv_sum;
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r) s_tile[(p * kR + r) * kCols + col] = 0.0f;
  }

  // stage the slab [k0, k0 + kKS) of gctx's rows (zero for no row) and of the
  // block's images
  const auto stage_gctx_img = [&](int k0) {
    for (int idx = tid; idx < kImgs * kCols * kKS; idx += kThreads) {
      const int rr = idx / kKS, k = idx % kKS;
      const long long ro = row_of[rr];
      gslab[rr * kLdG + k] = (ro >= 0 && k0 + k < D) ? gctx[ro * D + k0 + k] : 0.0f;
    }
    for (int idx = tid; idx < kImgSlab; idx += kThreads) {
      const int pr = idx / kKS, k = idx % kKS, pp = pr / kR;
      islab[idx] = (i0 + pp < Ni && k0 + k < D)
                       ? to_f(img[((size_t)i0 * kR + pr) * D + k0 + k]) : 0.0f;
    }
  };

  // gs_r = gctx . img_r over D
  float gs[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) gs[r] = 0.0f;
  for (int k0 = 0; k0 < D; k0 += kKS) {
    __syncthreads();  // the previous slab's readers are done
    stage_gctx_img(k0);
    __syncthreads();
    if (valid) {
      const float* gr = gslab + tid * kLdG;
      const float* im = islab + p * kR * kKS;
#pragma unroll 4
      for (int k = 0; k < kKS; ++k) {
        const float gv = gr[k];
#pragma unroll
        for (int r = 0; r < kR; ++r) gs[r] = fmaf(gv, im[r * kKS + k], gs[r]);
      }
    }
  }

  // the softmax backward at lambda 9: gattn
  if (valid) {
    float dot = 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) dot = fmaf(s_tile[(p * kR + r) * kCols + col], gs[r], dot);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float sr = s_tile[(p * kR + r) * kCols + col];
      g_tile[(p * kR + r) * kCols + col] = kLambda * sr * (gs[r] - dot);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r) g_tile[(p * kR + r) * kCols + col] = 0.0f;
  }
  __syncthreads();

  // per (image, region, caption): (sum_words gattn h) inv^2 / |h|, 0 if clamped
  for (int idx = tid; idx < kImgs * kR * cpb; idx += kThreads) {
    const int p2 = idx / (kR * cpb), r = idx / cpb % kR, c2 = idx % cpb, cg = c0 + c2;
    float dg = 0.0f;
    if (cg < Nc && i0 + p2 < Ni) {
      for (int l2 = 0; l2 < L; ++l2) {
        const int col2 = c2 * L + l2;
        const float hh = leaky(a_tile[(p2 * kRPad + r) * kLdA + col2]) *
                         mask[(size_t)cg * L + l2];
        dg = fmaf(g_tile[(p2 * kR + r) * kCols + col2], hh, dg);
      }
    }
    const int q = (p2 * kR + r) * kMaxCaps + c2;
    const float ss = coef[q], ci = inv_den[q];
    coef[q] = ss > 1e-16f ? dg * ci * ci / sqrtf(ss) : 0.0f;
  }
  __syncthreads();

  // gA: the word-norm backward, the mask and the leaky ReLU
  if (valid) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float a = a_tile[(p * kRPad + r) * kLdA + col];
      const int q = (p * kR + r) * kMaxCaps + cc;
      const int gi = (p * kR + r) * kCols + col;
      const float gh = (g_tile[gi] * inv_den[q] - leaky(a) * m * coef[q]) * m;
      g_tile[gi] = a > 0.0f ? gh : 0.1f * gh;
    }
  }

  const int group = c0 / cpb, pair = i0 / kImgs;
  for (int k0 = 0; k0 < D; k0 += kKS) {
    __syncthreads();  // gA formed / the previous slab's readers are done
    stage_gctx_img(k0);
    for (int idx = tid; idx < kCols * kKS; idx += kThreads) {
      const int col2 = idx / kKS, k = idx % kKS, cg = c0 + col2 / L;
      cslab[col2 * kLdG + k] = (col2 < ncols && cg < Nc && k0 + k < D)
                                   ? to_f(cap[((size_t)cg * L + col2 % L) * D + k0 + k])
                                   : 0.0f;
    }
    __syncthreads();
    // dcap of this thread's (image, word): gA^T img - ge, both images summed
    float v[kKS];
    if (valid) {
#pragma unroll
      for (int k = 0; k < kKS; ++k) v[k] = 0.0f;
      const float* im = islab + p * kR * kKS;
      for (int r = 0; r < kR; ++r) {
        const float ga = g_tile[(p * kR + r) * kCols + col];
#pragma unroll
        for (int k = 0; k < kKS; ++k) v[k] = fmaf(ga, im[r * kKS + k], v[k]);
      }
      const float* ger = ge + row_of[tid] * D + k0;
#pragma unroll
      for (int k = 0; k < kKS; ++k) v[k] -= (k0 + k < D) ? ger[k] : 0.0f;
      if (p == 1) {
#pragma unroll
        for (int k = 0; k < kKS; ++k) xch[col * kLdG + k] = v[k];
      }
    }
    __syncthreads();
    if (valid && p == 0) {
      const bool with_1 = word_valid(1, col, i0, c0, ncols, Ni, Nc, L, mask);
      float* dst = gcap_p + ((size_t)pair * rw.n_words + rw.word(c, l)) * D + k0;
#pragma unroll
      for (int k = 0; k < kKS; ++k) {
        if (k0 + k < D) dst[k] = v[k] + (with_1 ? xch[col * kLdG + k] : 0.0f);
      }
    }
    // dimg of the block's images at this slab: s^T gctx + gA cap over the words
#pragma unroll 1
    for (int j = 0; j < kOutsPerThread; ++j) {
      const int idx = tid + kThreads * j;
      const int pp = idx / (kR * kKS), r = idx / kKS % kR, k = idx % kKS;
      if (i0 + pp >= Ni || k0 + k >= D) continue;
      const float* srow = s_tile + (pp * kR + r) * kCols;
      const float* grow = g_tile + (pp * kR + r) * kCols;
      const float* gsl = gslab + pp * kCols * kLdG + k;
      const float* csl = cslab + k;
      float acc = 0.0f;
      for (int col2 = 0; col2 < ncols; ++col2) {
        acc = fmaf(srow[col2], gsl[col2 * kLdG], acc);
        acc = fmaf(grow[col2], csl[col2 * kLdG], acc);
      }
      gimg_p[(((size_t)group * Ni + i0 + pp) * kR + r) * D + k0 + k] = acc;
    }
  }
}

template <typename T>
__global__ void gcap_reduce(const float* __restrict__ gcap_p, const float* __restrict__ mask,
                            Rows rw, T* __restrict__ gcap, int D, int n_pairs) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)rw.Nc * rw.L * D) return;
  const int k = idx % D;
  const size_t cl = idx / D;
  float sum = 0.0f;
  if (mask[cl] > 0.0f) {
    const int w = rw.word(cl / rw.L, cl % rw.L);
    for (int pp = 0; pp < n_pairs; ++pp) sum += gcap_p[((size_t)pp * rw.n_words + w) * D + k];
  }
  gcap[idx] = from_f<T>(sum);
}

template <typename T>
__global__ void gimg_reduce(const float* __restrict__ gimg_p, T* __restrict__ gimg,
                            size_t n_out, int n_groups) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  float sum = 0.0f;
  for (int grp = 0; grp < n_groups; ++grp) sum += gimg_p[(size_t)grp * n_out + idx];
  gimg[idx] = from_f<T>(sum);
}

unsigned blocks_for(size_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <typename T>
int run(const void* cap, const void* mask, const void* img, const void* gram, const void* wt,
        const void* w, const void* b, const void* g, const int* pos, const int* cstart,
        void* gcap, void* gimg, float* gw, float* gb, float* ws_gy, float* ws_e, float* ws_ge,
        float* ws_gctx, float* ws_cinv, float* gcap_p, float* gimg_p, float* gw_p, int Ni,
        int Nc, int L, int D, int S, int n_words, int splits, cudaStream_t stream) {
  if (L < 1 || L > kCols || S < 4 || S > kMaxS || S % 4 != 0 || D < 1 || splits < 1 ||
      n_words < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (std::is_same<T, __nv_bfloat16>::value && D % 8 != 0) return (int)cudaErrorInvalidValue;
  const int cpb = caps_per_block(L);
  const int n_groups = (Nc + cpb - 1) / cpb;
  const int n_pairs = (Ni + kImgs - 1) / kImgs;
  const long long n_blocks = (long long)n_groups * n_pairs;
  const long long n_rows = (long long)n_words * Ni;
  if (n_blocks > 0x7fffffffLL || (n_rows + kBM - 1) / kBM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (Nc == 0 || Ni == 0) return (int)cudaSuccess;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const T* capt = static_cast<const T*>(cap);
  const T* imgt = static_cast<const T*>(img);
  const Rows rw{cstart, pos, Ni, Nc, L, n_words};
  const int rows_n = (int)n_rows;
  if (n_rows > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kNodeBytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(region_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRegionBytes);
    if (err != cudaSuccess) return (int)err;
    rows_kernel<T><<<(unsigned)n_blocks, kThreads, kNodeBytes, stream>>>(
        capt, f(mask), imgt, f(gram), f(wt), f(b), static_cast<const T*>(g), rw, ws_gy, ws_e,
        ws_cinv, Ni, Nc, L, D, S, cpb, n_groups);
    gdiff_kernel<<<dim3((D + kBN - 1) / kBN, (rows_n + kBM - 1) / kBM), kGemmThreads, 0,
                   stream>>>(ws_gy, f(w), ws_e, ws_ge, rows_n, D, S);
    ctx_bwd_kernel<T><<<blocks_for((size_t)Nc * Ni * L * 32, 256), 256, 0, stream>>>(
        capt, f(mask), ws_e, ws_ge, ws_cinv, rw, ws_gctx, Ni, Nc, L, D);
    region_kernel<T><<<(unsigned)n_blocks, kThreads, kRegionBytes, stream>>>(
        capt, f(mask), imgt, ws_ge, ws_gctx, rw, gcap_p, gimg_p, Ni, Nc, L, D, cpb, n_groups);
  } else {
    const cudaError_t err = cudaMemsetAsync(
        gimg_p, 0, sizeof(float) * (size_t)n_groups * Ni * kR * D, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_split = (int)((n_rows + splits - 1) / splits);
  gw_kernel<<<dim3((D + 1 + kBN - 1) / kBN, (S + kBM - 1) / kBM, splits), kGemmThreads, 0,
              stream>>>(ws_gy, ws_e, gw_p, rows_n, D, S, per_split);
  gw_reduce<<<blocks_for((size_t)S * (D + 1), 256), 256, 0, stream>>>(gw_p, gw, gb, S, D,
                                                                     splits);
  gcap_reduce<T><<<blocks_for((size_t)Nc * L * D, 256), 256, 0, stream>>>(
      gcap_p, f(mask), rw, static_cast<T*>(gcap), D, n_pairs);
  gimg_reduce<T><<<blocks_for((size_t)Ni * kR * D, 256), 256, 0, stream>>>(
      gimg_p, static_cast<T*>(gimg), (size_t)Ni * kR * D, n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward of itrx_sgraf_align.  cap (Nc, L, D), img (Ni, 36, D), g
// (Nc, Ni, L, S), gcap and gimg (out) all fp32 or all bf16 (bf16 != 0; then
// D % 8 == 0, cap and img 16-byte aligned); mask (Nc, L), gram (Ni, 36, 36),
// wt (D, S) and w (S, D) (sim_tranloc_w, both 16-byte aligned), b (S,) fp32;
// pos (Nc, L) and cstart (Nc,) int32, the valid words' ranks and each
// caption's first word (n_words in all); gw (S, D) and gb (S,) fp32 out.
// Workspaces, fp32: ws_gy (rows, S), ws_e, ws_ge, ws_gctx (rows, D), ws_cinv
// (rows,), gcap_p (ceil(Ni / 2), n_words, D), gimg_p (caption groups, Ni, 36,
// D), gw_p (splits, S, D + 1); rows = n_words * Ni.  1 <= L <= 128;
// S % 4 == 0, S <= 256.  Nine launches on `stream` of CUDA device `device`;
// returns cudaGetLastError().
int itrx_sgraf_align_bwd(const void* cap, const void* mask, const void* img, const void* gram,
                         const void* wt, const void* w, const void* b, const void* g,
                         const void* pos, const void* cstart, void* gcap, void* gimg, void* gw,
                         void* gb, void* ws_gy, void* ws_e, void* ws_ge, void* ws_gctx,
                         void* ws_cinv, void* gcap_p, void* gimg_p, void* gw_p, int Ni, int Nc,
                         int L, int D, int S, int n_words, int splits, int bf16, int device,
                         void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto fp = [](void* v) { return static_cast<float*>(v); };
  const int* ip = static_cast<const int*>(pos);
  const int* ic = static_cast<const int*>(cstart);
  if (bf16) {
    return run<__nv_bfloat16>(cap, mask, img, gram, wt, w, b, g, ip, ic, gcap, gimg, fp(gw),
                              fp(gb), fp(ws_gy), fp(ws_e), fp(ws_ge), fp(ws_gctx), fp(ws_cinv),
                              fp(gcap_p), fp(gimg_p), fp(gw_p), Ni, Nc, L, D, S, n_words,
                              splits, s);
  }
  return run<float>(cap, mask, img, gram, wt, w, b, g, ip, ic, gcap, gimg, fp(gw), fp(gb),
                    fp(ws_gy), fp(ws_e), fp(ws_ge), fp(ws_gctx), fp(ws_cinv), fp(gcap_p),
                    fp(gimg_p), fp(gw_p), Ni, Nc, L, D, S, n_words, splits, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
