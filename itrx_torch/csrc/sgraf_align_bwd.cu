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
// clamped at 1e-8.  gctx is never formed: with ci = 1 / (|ctx| + eps),
// ctx = sum_r s_r img_r, GS_r = ge . img_r and the region Gram G,
//   cb     = ci (s . GS) / |ctx|                  (= (ge . ctx_n) / |ctx|)
//   gs_r   = ci (GS_r - cb (G s)_r)
//   dimg_r = sum_rows [s_r ci ge + gA_r cap] - sum_r' (sum_rows s_r ci cb s_r') img_r'
//
// What bounds it: the products, per valid word and image the recomputed
// context and projection, W gy and the dW product (D x S each) and four
// 36 x D products (GS, dcap, both dimg terms).  Every one runs on the tensor
// cores as a split-bf16 product (sgraf_nodes_mma.cuh: x = hi + lo both bf16,
// three passes a_hi b_lo + a_lo b_hi + a_hi b_hi, fp32 accumulation; two
// passes where one operand is a bf16 embedding, which is exact), so the
// gradients keep fp32 accuracy; the rest of the chain is fp32.  Only the A
// recompute stays as xattn_product.cuh forms it (wmma for bf16, fp32 FMAs for
// fp32 embeddings).
// Design: four passes over a list of rows, one per (caption, image, valid
// word), caption-major (the wrapper ranks the words on the device: row =
// Ni cstart_c + i len_c + rank), and three ordered reductions; every sum in
// a fixed order (no atomics), so two calls give identical gradients.  No pass
// reads the row count on the host: grids and workspaces are sized from the
// shapes (Nc L Ni rows at most), and a pass reads the count from cstart.  One
// fp32 workspace of D (rounded up to 32) per row holds e, then ge, then the
// row's dcap.
//   1. rows_kernel: the forward's node assembly (sgraf_nodes.cuh) and its
//      split projection (sgraf_nodes_mma.cuh: wgmma from TMA-staged weight
//      slabs, the context on mma.sync), with e stored as the operand is
//      formed; then gy in the tile's epilogue.
//   2. gw_kernel: [dW | db] = gy^T [e^2 | 1] over gw splits of the rows, a
//      64 x 256 tile a block on wgmma, both operands split as they are staged
//      (a slab ahead, in registers); gw_reduce sums the splits in order.
//   3. ge_kernel: ge = 2 e (gy W) per 64-row tile on wgmma (mma_tile, W^T
//      split once a call by the wrapper, by TMA), written over e.
//   4. region_kernel: per block (pair of images, group of whole captions), A
//      again, the softmax, then GS over slabs of 32 of D (mma.sync, a warp per
//      32 rows of an image), the context- and word-norm backward to gA, M on
//      mma.sync, then over slabs of 32 of D: dimg's partial (six warps, one
//      per image and 16 regions, their A fragments held in registers for all
//      slabs) and dcap per row, written over ge (every warp, from gA split once
//      into shared memory); gcap_reduce sums the rows over images and
//      gimg_reduce the partials over caption groups, in order, and cast to the
//      embeddings' dtype.
// Each pass's time on the card, at one training chunk, is in PERF.md §6.
#include "sgraf_nodes.cuh"
#include "sgraf_nodes_mma.cuh"

namespace {

using namespace itrx_sgraf_mma;

// The compact rows of the valid (caption, image, word) triples.
struct Rows {
  const int* cstart;  // (Nc + 1,) valid words before each caption, then all
  const int* pos;     // (Nc, L) rank of each valid word in its caption
  int Ni, Nc, L;

  __device__ __forceinline__ long long row(int c, int i, int l) const {
    const int len = cstart[c + 1] - cstart[c];
    return (long long)Ni * cstart[c] + (long long)i * len + pos[c * L + l];
  }
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

// the register of a B (or A) fragment holding (x0, x1): hi, and lo where the
// value is not exact in bf16 (fp32)
__device__ __forceinline__ void frag_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  split2(x0, x1, hi, lo);
}
__device__ __forceinline__ void frag_pair(__nv_bfloat16 x0, __nv_bfloat16 x1, uint32_t& hi,
                                          uint32_t& lo) {
  hi = bits(__halves2bfloat162(x0, x1));
  lo = 0u;
}

// a . b as a split product, the passes with a lo part into dlo and hi x hi
// into dhi (two dependency chains): a always split (hi, lo); b split when
// kSplitB, else exact in its hi part
template <bool kSplitB>
__device__ __forceinline__ void mma_split(float (&dlo)[4], float (&dhi)[4],
                                          const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  if constexpr (kSplitB) mma16(dlo, ah, bl0, bl1);
  mma16(dlo, al, bh0, bh1);
  mma16(dhi, ah, bh0, bh1);
}

// A fragment (hi, lo) of fp32 values: x(row, k) for rows g, g + 8 and k 2t,
// 2t + 1, 2t + 8, 2t + 9 of a 16 x 16 tile, pairs given by xy(row, k) as float2
template <typename Pair>
__device__ __forceinline__ void a_frag(uint32_t (&ah)[4], uint32_t (&al)[4], Pair xy) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v = xy(g + 8 * (q & 1), 2 * t + 8 * (q >> 1));
    split2(v.x, v.y, ah[q], al[q]);
  }
}

// cp.async of `n` elements of T (16-byte vectors when the rows allow it,
// else 4 bytes at a time) from src (row of a matrix with `D` columns, at
// column k0) to dst; zeros where !ok or past D
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* __restrict__ src, bool ok, int k0,
                                          int D, int n, int part, int parts) {
  constexpr int kVec = 16 / sizeof(T);
  if (sizeof(T) == 2 || D % 4 == 0) {
    for (int v = part; v < n / kVec; v += parts) {
      const bool in = ok && k0 + kVec * v < D;
      cp_async16(dst + kVec * v, in ? src + kVec * v : src, in);
    }
  } else {
    for (int k = part; k < n; k += parts) {
      const bool in = ok && k0 + k < D;
      cp_async4(dst + k, in ? src + k : src, in);
    }
  }
}

// ---------------------------------------------------------------- pass 1
// e of a tile's rows into the (rows, ldE) workspace as the projection forms it
struct ESink {
  float* e;
  const long long* row_at;  // the tile rows' compact rows (shared memory)
  int ld;

  __device__ __forceinline__ void operator()(int r, int k, bool ok, float v) const {
    if (ok) e[row_at[r] * ld + k] = v;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rows_kernel(const T* __restrict__ cap, const float* __restrict__ mask, const T* __restrict__ img,
            const float* __restrict__ gram, const uint32_t* __restrict__ wsplit,
            const float* __restrict__ bias, const T* __restrict__ g, Rows rw,
            float* __restrict__ gy_out, float* __restrict__ e_out, int Ni, int Nc, int L, int D,
            int Kp, int S, int S8, int cpb, int n_groups) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float cinv[kImgs * kCols];
  __shared__ int rows[kMaxRows];
  __shared__ int n_rows[2];
  __shared__ long long row_at[kMmaRows];
  __shared__ long long g_at[kMmaRows];
  __shared__ float coef_a[kMmaRows];
  __shared__ float coef_b[kMmaRows];
  const Nodes nd = node_smem(smem, cinv, rows, n_rows);
  const Ring rg = ring_smem(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  int i0, c0;
  block_origin(Ni, cpb, n_groups, &i0, &c0);
  init_weight_bars();
  assemble(nd, cap, mask, img, gram, i0, c0, cpb, Ni, Nc, L, D);
  split_softmax(nd);
  const int n_loc = n_rows[0];
  if (n_loc == 0) return;
  const int step = tile_step(n_loc);
  for (int t0 = 0; t0 < n_loc; t0 += step) {
    const int nrows = min(step, n_loc - t0);
    // the tile rows' compact rows and cotangent rows (read after mma_tile's
    // first barrier; the last tile's readers passed tile_out's)
    if (tid < nrows) {
      const int code = rows[t0 + tid], p = code / kCols, col = code % kCols;
      const int c = c0 + col / L, l = col % L;
      row_at[tid] = rw.row(c, i0 + p, l);
      g_at[tid] = (((long long)c * Ni + i0 + p) * L + l) * S;
    }
    WordRows<T, ESink> prod{nd, rg, cap, img, t0, nrows, i0, c0, Ni, L, D, {},
                            ESink{e_out, row_at, Kp}};
    Acc acc;
    mma_tile(acc, rg, wsplit, Kp, S8, nrows, prod);
    tile_out(acc, rg, nrows, [&](const float* y, int n) {
      // a warp per row: |y|^2 and y . g, the l2norm's backward coefficients
      for (int i = warp; i < n; i += kThreads / 32) {
        const T* gr = g + g_at[i];
        float sq = 0.0f, gd = 0.0f;
#pragma unroll 8
        for (int c = lane; c < S; c += 32) {
          const float v = y[i * kLdY + c] + bias[c];
          sq = fmaf(v, v, sq);
          gd = fmaf(v, to_f(gr[c]), gd);
        }
        sq = warp_sum(sq);
        gd = warp_sum(gd);
        if (lane == 0) {
          const float ny = sqrtf(fmaxf(sq, 1e-16f));
          const float yinv = 1.0f / (ny + kEps);
          coef_a[i] = yinv;
          coef_b[i] = sq > 1e-16f ? gd * yinv * yinv / ny : 0.0f;
        }
      }
      __syncthreads();
      // a thread per column: the rows' gy, 8 rows' loads in flight at a time
      for (int c = tid; c < S; c += kThreads) {
        const float b = bias[c];
        for (int r0 = 0; r0 < n; r0 += 8) {
          float gv[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) gv[q] = r0 + q < n ? to_f(g[g_at[r0 + q] + c]) : 0.0f;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int i = r0 + q;
            if (i < n) {
              gy_out[row_at[i] * S + c] = gv[q] * coef_a[i] - (y[i * kLdY + c] + b) * coef_b[i];
            }
          }
        }
      }
    });
  }
}

// ---------------------------------------------------------------- pass 2
// [dW | db] partials of one split of the rows: a 64 (S) x 256 (D) tile of
// dW = gy^T e^2 on wgmma (the mma_tile product, both operands formed here)
constexpr int kGwM = kMmaRows;            // rows of S in a tile: one m64
constexpr int kGwN = kMaxS;               // columns of D: two warpgroups of n128
constexpr int kGwA = kGwM * kSlab;        // words of one A slab (gy^T, split)
constexpr int kGwB = kGwN * kSlab;        // words of one B slab (e^2, split)
constexpr int kGwBytes = 2 * (kGwA + kGwB) * 4;

__global__ void __launch_bounds__(kThreads, 1)
gw_kernel(const float* __restrict__ gy, const float* __restrict__ e,
          const int* __restrict__ cstart, float* __restrict__ gw_p, float* __restrict__ gb_p,
          int Ni, int Nc, int D, int ldE, int S, int splits) {
  extern __shared__ __align__(128) float smem[];
  uint32_t* const a_s = reinterpret_cast<uint32_t*>(smem);   // [2][kGwA]
  uint32_t* const b_s = a_s + 2 * kGwA;                      // [2][kGwB]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, wg = tid / 128;
  const int s0 = blockIdx.x * kGwM, d0 = blockIdx.y * kGwN, z = blockIdx.z;
  const long long n_rows = (long long)Ni * cstart[Nc];
  const long long per = (n_rows + splits - 1) / splits;
  const long long kb = min(n_rows, (long long)z * per), ke = min(n_rows, kb + per);
  const int nslab = (int)((ke - kb + kSlab - 1) / kSlab);
  // this thread forms k pairs 4c + t (c = 2 st + kg) of A row as_ and of B
  // rows 8 (warp + 8j) + lane / 4: lanes of a warp on 8 rows x 4 pairs, so
  // that their words fall in 32 banks
  const int t = tid % 4, as_ = tid / 4, bd = lane / 4;
  const bool a_ok = s0 + as_ < S;
  float pa[8], pb[32];
  float db = 0.0f;
  const auto load = [&](int sl) {
    const long long k0 = kb + (long long)sl * kSlab;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long k = k0 + 2 * (4 * c + t) + h;
        const bool ok = k < ke;
        pa[2 * c + h] = (ok && a_ok) ? gy[k * S + s0 + as_] : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + 8 * (warp + 8 * j) + bd;
          pb[8 * j + 2 * c + h] = (ok && d < D) ? e[k * ldE + d] : 0.0f;
        }
      }
  };
  const auto make = [&](int buf) {
    uint32_t* a = a_s + buf * kGwA;
    uint32_t* b = b_s + buf * kGwB;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int st = c / 2, kg = c % 2;
      uint32_t hi, lo;
      split2(pa[2 * c], pa[2 * c + 1], hi, lo);
      a[2 * st * (kGwM * 8) + core_word(as_, kg, t)] = hi;
      a[(2 * st + 1) * (kGwM * 8) + core_word(as_, kg, t)] = lo;
      db += pa[2 * c] + pa[2 * c + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 8 * (warp + 8 * j) + bd;
        const float x0 = pb[8 * j + 2 * c], x1 = pb[8 * j + 2 * c + 1];
        split2(x0 * x0, x1 * x1, hi, lo);
        b[2 * st * (kGwN * 8) + core_word(d, kg, t)] = hi;
        b[(2 * st + 1) * (kGwN * 8) + core_word(d, kg, t)] = lo;
      }
    }
  };

  Acc acc;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  fence_acc(acc);
  if (nslab > 0) {
    load(0);
    make(0);
    if (nslab > 1) load(1);
  }
  for (int sl = 0; sl < nslab; ++sl) {
    // slab sl is formed and visible to the tensor cores; every warpgroup is
    // done with slab sl - 1
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t* as = a_s + (sl & 1) * kGwA;
    const uint32_t* bs = b_s + (sl & 1) * kGwB + wg * 16 * 2 * kCoreWords;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const uint64_t ah = smem_desc(as + (2 * st) * (kGwM * 8), 128, 256);
      const uint64_t al = smem_desc(as + (2 * st + 1) * (kGwM * 8), 128, 256);
      const uint64_t bh = smem_desc(bs + (2 * st) * (kGwN * 8), 128, 256);
      const uint64_t bl = smem_desc(bs + (2 * st + 1) * (kGwN * 8), 128, 256);
      wgmma_m64n128(acc, ah, bl);
      wgmma_m64n128(acc, al, bh);
      wgmma_m64n128(acc, ah, bh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the products of slab sl run while slab sl + 1 is formed
    if (sl + 1 < nslab) {
      make((sl + 1) & 1);
      if (sl + 2 < nslab) load(sl + 2);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }
  const Frag f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = s0 + f.row(h);
    if (s >= S) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int d = d0 + f.col(i, 0);
      if (d < ldE) {
        *reinterpret_cast<float2*>(gw_p + ((size_t)z * S + s) * ldE + d) =
            make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
      }
    }
  }
  // db: the four pair groups of each s summed in a fixed order
  db += __shfl_xor_sync(0xffffffffu, db, 1);
  db += __shfl_xor_sync(0xffffffffu, db, 2);
  if (blockIdx.y == 0 && t == 0 && a_ok) gb_p[(size_t)z * S + s0 + as_] = db;
}

__global__ void gw_reduce(const float* __restrict__ gw_p, const float* __restrict__ gb_p,
                          float* __restrict__ gw, float* __restrict__ gb, int S, int D, int ldE,
                          int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_w = (size_t)S * D;
  float sum = 0.0f;
  if (idx < n_w) {
    const size_t m = idx / D, n = idx % D;
    for (int z = 0; z < splits; ++z) sum += gw_p[((size_t)z * S + m) * ldE + n];
    gw[idx] = sum;
  } else if (idx < n_w + S) {
    const size_t m = idx - n_w;
    for (int z = 0; z < splits; ++z) sum += gb_p[(size_t)z * S + m];
    gb[m] = sum;
  }
}

// ---------------------------------------------------------------- pass 3
constexpr int kWtChunk = kMaxS;  // columns of D in one ge product: two warpgroups of n128
constexpr int kGeBytes = (kWStages * kWStage + 2 * kAStage) * 4;
static_assert(kWtChunk == kThreads, "a thread per column in the ge epilogue");

// ge = 2 e (gy W) for rows t0 .. t0 + 63, over e in place; E's columns past D
// zeroed.  Two blocks an SM (128 registers, 2 x 112 KB of shared memory), so
// that one block's epilogue runs under the other's products.
__global__ void __launch_bounds__(kThreads, 2)
ge_kernel(const float* __restrict__ gy, const uint32_t* __restrict__ wtsplit,
          float* __restrict__ e, const int* __restrict__ cstart, int Ni, int Nc, int D, int ldE,
          int S, int Ks) {
  extern __shared__ __align__(128) float smem[];
  uint32_t* const u = reinterpret_cast<uint32_t*>(smem);
  const Ring rg{u + kWStages * kWStage, u, smem};
  const long long n_rows = (long long)Ni * cstart[Nc];
  const long long t0 = (long long)blockIdx.x * kMmaRows;
  if (t0 >= n_rows) return;
  const int nrows = (int)min((long long)kMmaRows, n_rows - t0);
  const int tid = threadIdx.x;
  init_weight_bars();
  for (int j = 0; j * kWtChunk < ldE; ++j) {
    SrcRows prod{gy + t0 * S, 0, nrows, S, {}};
    Acc acc;
    mma_tile(acc, rg, wtsplit + (size_t)j * kWtChunk * Ks, Ks, kWtChunk, nrows, prod);
    tile_out(acc, rg, nrows, [&](const float* y, int n) {
      const int d = kWtChunk * j + tid;
      if (d >= ldE) return;
      float* col = e + t0 * ldE + d;
      // 16 rows' loads in flight at a time (the stores could alias them)
      for (int r0 = 0; r0 < n; r0 += 16) {
        float v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) v[q] = (r0 + q < n && d < D) ? col[(r0 + q) * ldE] : 0.0f;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          if (r0 + q < n) col[(r0 + q) * ldE] = 2.0f * v[q] * y[(r0 + q) * kLdY + tid];
        }
      }
    });
  }
}

// ---------------------------------------------------------------- pass 4
constexpr int kLdS = kCols + 4;                 // row stride of the [p][r][col] tiles
constexpr int kPRTile = kImgs * kR * kLdS;      // softmax weights; h, then gA; GS, then gattn
constexpr int kAux = kImgs * 48 * 48;           // word-norm inverses and |h|^2, then -M
constexpr int kSA = 32;                         // phase A (GS) slab of D
constexpr int kLdGA = kSA + 4;                  // row stride of the staged ge (floats)
constexpr int kLdIA = kSA + 8;                  // row stride of the staged images (elements)
constexpr int kSB = 32;                         // phase B (dcap, dimg) slab of D
constexpr int kNB = kSB / 8;                    // its n8 tiles
constexpr int kLdGB = kSB + 4;
// staged caption and image rows (elements): 16-byte rows, lanes' fragment
// loads on distinct banks
template <typename T>
__host__ __device__ constexpr int ld_cb() { return sizeof(T) == 2 ? kSB + 8 : kSB + 4; }
constexpr int kRowsB = kImgs * kCols;           // the block's (image, word) rows
constexpr int kStageA = 2 * kRowsB * kLdGA + 2 * kImgs * kR * kLdIA;
constexpr int kStageB = 2 * kRowsB * kLdGB + 2 * kImgs * kR * ld_cb<float>();  // captions in h_t
constexpr int kStageMid = kPRTile + kImgs * kR * kR;
constexpr int kStage = kStageA;                 // in floats (fp32 elements: the larger)
constexpr int kRegionFloats = 2 * kPRTile + kAux + 2 * kRowsB + kStage;
constexpr int kRegionBytes = kRegionFloats * 4;
static_assert(kStageB <= kStage && kStageMid <= kStage && kSmemF32 / 4 <= kStage,
              "the stage region holds every phase");
static_assert(kRegionBytes <= 232448 - 4096, "region_kernel's shared memory fits");
static_assert(kImgs * kR * kMaxCaps * 2 <= kAux, "the word-norm terms fit");
static_assert(2 * kCols * ld_cb<float>() <= kPRTile && ld_cb<__nv_bfloat16>() <= 2 * ld_cb<float>(),
              "the caption slabs fit the gA tile");
static_assert(kThreads == kRowsB, "one (image, word) per thread");

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
region_kernel(const T* __restrict__ cap, const float* __restrict__ mask,
              const T* __restrict__ img, const float* __restrict__ gram, float* __restrict__ e,
              Rows rw, float* __restrict__ gimg_p, int Ni, int Nc, int L, int D, int ldE,
              int cpb, int n_groups) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kLdCB = ld_cb<T>();
  extern __shared__ __align__(128) float smem[];
  float* s_t = smem;                    // [p][r][kLdS] softmax weights
  float* h_t = s_t + kPRTile;           // [p][r][kLdS] h = leaky(A) m, then gA
  float* aux = h_t + kPRTile;           // [p][r][kMaxCaps] 1 / (|h_r| + eps), |h_r|^2; then -M
  float* ci_s = aux + kAux;             // [row] ci
  float* cbci_s = ci_s + kRowsB;        // [row] cb ci
  float* stage = cbci_s + kRowsB;       // the A product; then the phases' slabs
  __shared__ long long row_of[kRowsB];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  int i0, c0;
  block_origin(Ni, cpb, n_groups, &i0, &c0);
  const int ncols = cpb * L;
  const int p = tid / kCols, col = tid % kCols;
  const bool valid = word_valid(p, col, i0, c0, ncols, Ni, Nc, L, mask);
  const int cc = col / L, c = c0 + cc, l = col % L;
  row_of[tid] = valid ? rw.row(c, i0 + p, l) : -1;
  const float m = valid ? mask[(size_t)c * L + l] : 0.0f;
  float* inv_den = aux;                          // [p][r][kMaxCaps]
  float* ssq = aux + kImgs * kR * kMaxCaps;      // [p][r][kMaxCaps]

  // A = img . cap^T, the word norms, the softmax, h
  float* a_tile = stage;
  product(img, i0, Ni, cap, c0, ncols, Nc, L, D, a_tile);
  __syncthreads();
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
    ssq[(p2 * kR + r) * kMaxCaps + c2] = ss;
  }
  __syncthreads();
  {
    float sv[kR];
    float mx = -3.0e38f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float hh = valid ? leaky(a_tile[(p * kRPad + r) * kLdA + col]) * m : 0.0f;
      h_t[(p * kR + r) * kLdS + col] = hh;
      sv[r] = valid ? hh * inv_den[(p * kR + r) * kMaxCaps + cc] * kLambda : 0.0f;
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
    for (int r = 0; r < kR; ++r) s_t[(p * kR + r) * kLdS + col] = valid ? sv[r] * inv_sum : 0.0f;
  }
  __syncthreads();  // the A tiles are read: the stage region is free

  // ---- phase A: GS[row][r] = ge_row . img_r over D (mma.sync, ge split)
  float* ge_a = stage;                                        // [2][kRowsB][kLdGA]
  T* img_a = reinterpret_cast<T*>(stage + 2 * kRowsB * kLdGA);  // [2][kImgs * kR][kLdIA]
  const auto stage_a = [&](int sl, int buf) {
    const int k0 = kSA * sl;
    // ge: a row a thread, 8 vectors
    {
      const long long ro = row_of[tid];
      float* dst = ge_a + (buf * kRowsB + tid) * kLdGA;
      const float* src = e + (ro >= 0 ? ro : 0) * ldE + k0;
#pragma unroll
      for (int v = 0; v < kSA / 4; ++v) cp_async16(dst + 4 * v, src + 4 * v, ro >= 0);
    }
    constexpr int kParts = kThreads / (kImgs * kR) ;  // threads per image row: 3
    if (tid < kParts * kImgs * kR) {
      const int pr = tid / kParts;
      const bool ok = i0 + pr / kR < Ni;
      stage_row(img_a + (buf * kImgs * kR + pr) * kLdIA,
                img + (ok ? ((size_t)i0 * kR + pr) * D + k0 : 0), ok, k0, D, kSA, tid % kParts,
                kParts);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // warp w: image w / 4, rows 32 (w % 4) .. + 31 (two m16), regions 0 .. 39 (five n8)
  const int pa_ = warp / 4, rbase = 32 * (warp % 4);
  float gsacc[2][5][4] = {}, gslo[2][5][4] = {};
  const int nsa = ldE / kSA;
  stage_a(0, 0);
  for (int sl = 0; sl < nsa; ++sl) {
    if (sl + 1 < nsa) {
      stage_a(sl + 1, (sl + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* gsl = ge_a + ((sl & 1) * kRowsB + pa_ * kCols + rbase) * kLdGA;
    const T* isl = img_a + ((sl & 1) * kImgs + pa_) * kR * kLdIA;
#pragma unroll
    for (int kk = 0; kk < kSA / 16; ++kk) {
      uint32_t bh[5][2], bl[5][2];
#pragma unroll
      for (int n = 0; n < 5; ++n) {
        const int r = 8 * n + g;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = 16 * kk + 2 * t + 8 * j;
          if (r < kR) {
            frag_pair(isl[r * kLdIA + k], isl[r * kLdIA + k + 1], bh[n][j], bl[n][j]);
          } else {
            bh[n][j] = bl[n][j] = 0u;
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t ah[4], al[4];
        a_frag(ah, al, [&](int rr, int k) {
          return *reinterpret_cast<const float2*>(gsl + (16 * mi + rr) * kLdGA + 16 * kk + k);
        });
#pragma unroll
        for (int n = 0; n < 5; ++n) {
          mma_split<kF32>(gslo[mi][n], gsacc[mi][n], ah, al, bh[n][0], bh[n][1], bl[n][0],
                          bl[n][1]);
        }
      }
    }
    __syncthreads();  // the slab's readers are done before it is refilled
  }

  // ---- the context-norm and softmax backward: gattn; ci, cb ci per row
  float* gs_t = stage;                       // [p][r][kLdS] GS, then gattn
  float* gram_s = stage + kPRTile;           // [p][kR * kR]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 5; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 8 * n + 2 * t + (q & 1);
        const int rowc = rbase + 16 * mi + g + 8 * (q >> 1);
        if (r < kR) gs_t[(pa_ * kR + r) * kLdS + rowc] = gslo[mi][n][q] + gsacc[mi][n][q];
      }
  for (int idx = tid; idx < kImgs * kR * kR; idx += kThreads) {
    const int p2 = idx / (kR * kR);
    gram_s[idx] = i0 + p2 < Ni ? gram[(size_t)i0 * kR * kR + idx] : 0.0f;
  }
  __syncthreads();
  {
    float sv[kR], gv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) sv[r] = s_t[(p * kR + r) * kLdS + col];
    // (G s)_r and |ctx|^2 = s G s^T, as the node assembly forms them
    const float4* g4 = reinterpret_cast<const float4*>(gram_s + p * kR * kR);
    float ctx2 = 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float y = 0.0f;
#pragma unroll
      for (int q = 0; q < kR / 4; ++q) {
        const float4 gq = g4[r * (kR / 4) + q];
        y = fmaf(gq.x, sv[4 * q], y);
        y = fmaf(gq.y, sv[4 * q + 1], y);
        y = fmaf(gq.z, sv[4 * q + 2], y);
        y = fmaf(gq.w, sv[4 * q + 3], y);
      }
      gv[r] = y;
      ctx2 = fmaf(sv[r], y, ctx2);
    }
    const float ci = 1.0f / (sqrtf(fmaxf(ctx2, 1e-16f)) + kEps);
    float* gcol = gs_t + p * kR * kLdS + col;
    float sgs = 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) sgs = fmaf(sv[r], gcol[r * kLdS], sgs);
    const float n = 1.0f / ci - kEps;  // |ctx|, clamped at 1e-8
    const float cb = n > 1.0001e-8f ? ci * sgs / n : 0.0f;
    float dot = 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      gv[r] = ci * (gcol[r * kLdS] - cb * gv[r]);  // gs_r
      dot = fmaf(sv[r], gv[r], dot);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      gcol[r * kLdS] = valid ? kLambda * sv[r] * (gv[r] - dot) : 0.0f;
    }
    ci_s[tid] = valid ? ci : 0.0f;
    cbci_s[tid] = valid ? cb * ci : 0.0f;
  }
  __syncthreads();

  // ---- the word-norm backward: per (image, region, caption) its coefficient,
  // then gA (over h)
  for (int idx = tid; idx < kImgs * kR * cpb; idx += kThreads) {
    const int p2 = idx / (kR * cpb), r = idx / cpb % kR, c2 = idx % cpb;
    float dg = 0.0f;
    if (c0 + c2 < Nc && i0 + p2 < Ni) {
      const float* gr = gs_t + (p2 * kR + r) * kLdS + c2 * L;
      const float* hr = h_t + (p2 * kR + r) * kLdS + c2 * L;
      for (int l2 = 0; l2 < L; ++l2) dg = fmaf(gr[l2], hr[l2], dg);
    }
    const int q = (p2 * kR + r) * kMaxCaps + c2;
    const float ss = ssq[q], ci = inv_den[q];
    ssq[q] = ss > 1e-16f ? dg * ci * ci / sqrtf(ss) : 0.0f;
  }
  __syncthreads();
#pragma unroll 4
  for (int r = 0; r < kR; ++r) {
    const int q = (p * kR + r) * kMaxCaps + cc;
    const int gi = (p * kR + r) * kLdS + col;
    float ga = 0.0f;
    if (valid) {
      const float hh = h_t[gi];
      const float gh = (gs_t[gi] * inv_den[q] - hh * ssq[q]) * m;
      ga = hh > 0.0f ? gh : 0.1f * gh;
    }
    h_t[gi] = ga;
  }
  __syncthreads();

  // ---- -M[p][r][r'] = -sum_rows s_r cb ci s_r' over aux (zero past 36),
  // on mma.sync: warp w < 6 takes image w / 3, regions 16 (w % 3) .. + 15
  for (int idx = tid; idx < kAux; idx += kThreads) aux[idx] = 0.0f;
  __syncthreads();
  const int pi = warp < 6 ? warp / 3 : warp - 6, mt = warp % 3;
  const float* srow = s_t + pi * kR * kLdS;
  const float* hrow = h_t + pi * kR * kLdS;
  const float* cis = ci_s + pi * kCols;
  const auto region_ok = [&](int rr) { return 16 * mt + rr < kR; };
  // an A fragment of (s_r x[row]) over the image's rows kk, x = ci or cb ci
  const auto s_frag = [&](uint32_t (&ah)[4], uint32_t (&al)[4], int kk, const float* x) {
    a_frag(ah, al, [&](int rr, int k) {
      const int cl = 16 * kk + k;
      if (!region_ok(rr)) return make_float2(0.0f, 0.0f);
      const float2 sv = *reinterpret_cast<const float2*>(srow + (16 * mt + rr) * kLdS + cl);
      return make_float2(sv.x * x[cl], sv.y * x[cl + 1]);
    });
  };
  if (warp < 6) {
    float acc[5][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      uint32_t ah[4], al[4];
      s_frag(ah, al, kk, cbci_s + pi * kCols);
#pragma unroll
      for (int n = 0; n < 5; ++n) {
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r2 = 8 * n + g, cl = 16 * kk + 2 * t + 8 * j;
          const float2 sv = r2 < kR ? *reinterpret_cast<const float2*>(srow + r2 * kLdS + cl)
                                    : make_float2(0.0f, 0.0f);
          split2(sv.x, sv.y, bh[j], bl[j]);
        }
        mma_split<true>(acc[n][0], acc[n][1], ah, al, bh[0], bh[1], bl[0], bl[1]);
      }
    }
#pragma unroll
    for (int n = 0; n < 5; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 16 * mt + g + 8 * (q >> 1), r2 = 8 * n + 2 * t + (q & 1);
        if (r < kR && r2 < kR) aux[(pi * 48 + r) * 48 + r2] = -(acc[n][0][q] + acc[n][1][q]);
      }
  }
  __syncthreads();

  // the dimg warps' A fragments, the same for every slab: (s_r ci), gA and
  // -M of image pi, regions 16 mt .. + 15
  uint32_t fwh[8][4], fwl[8][4], fgh[8][4], fgl[8][4], fmh[3][4], fml[3][4];
  if (warp < 6) {
    const float* mrow = aux + pi * 48 * 48;
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      s_frag(fwh[kk], fwl[kk], kk, cis);
      a_frag(fgh[kk], fgl[kk], [&](int rr, int k) {
        if (!region_ok(rr)) return make_float2(0.0f, 0.0f);
        return *reinterpret_cast<const float2*>(hrow + (16 * mt + rr) * kLdS + 16 * kk + k);
      });
    }
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      a_frag(fmh[kk], fml[kk], [&](int rr, int k) {
        return *reinterpret_cast<const float2*>(mrow + (16 * mt + rr) * 48 + 16 * kk + k);
      });
    }
  }
  __syncthreads();
  // gA split once into the dcap products' A words, over the softmax weights:
  // gat_hi / gat_lo [p][region pair][kLdS], a thread per (image, word)
  uint32_t* const gat_hi = reinterpret_cast<uint32_t*>(s_t) + pi * (kR / 2) * kLdS;
  uint32_t* const gat_lo = gat_hi + kImgs * (kR / 2) * kLdS;
  static_assert(2 * kImgs * (kR / 2) * kLdS <= kPRTile, "the split gA fits the softmax tile");
  {
    uint32_t* hi = reinterpret_cast<uint32_t*>(s_t) + p * (kR / 2) * kLdS + col;
#pragma unroll 6
    for (int rp = 0; rp < kR / 2; ++rp) {
      split2(h_t[(p * kR + 2 * rp) * kLdS + col], h_t[(p * kR + 2 * rp + 1) * kLdS + col],
             hi[rp * kLdS], hi[kImgs * (kR / 2) * kLdS + rp * kLdS]);
    }
  }
  // the warps' dcap row tiles: dimg warps one each, the other two five each
  const int mc0 = warp < 6 ? warp % 3 : 3, mc1 = warp < 6 ? mc0 + 1 : kCols / 16;
  __syncthreads();  // gA is split: its tile takes the caption slabs

  // ---- phase B: per slab of D, dcap (over ge, in place) and dimg's partial
  float* ge_b = stage;                                       // [2][kRowsB][kLdGB]
  T* img_b = reinterpret_cast<T*>(stage + 2 * kRowsB * kLdGB);  // [2][kImgs * kR][kLdCB]
  T* cap_b = reinterpret_cast<T*>(h_t);  // [2][kCols][kLdCB], over gA (split into s_t)
  const auto stage_b = [&](int sl, int buf) {
    const int k0 = kSB * sl;
    {
      const long long ro = row_of[tid];
      float* dst = ge_b + (buf * kRowsB + tid) * kLdGB;
      const float* src = e + (ro >= 0 ? ro : 0) * ldE + k0;
#pragma unroll
      for (int v = 0; v < kSB / 4; ++v) cp_async16(dst + 4 * v, src + 4 * v, ro >= 0);
    }
    if (tid < kCols) {
      const int cg = c0 + tid / L;
      const bool ok = tid < ncols && cg < Nc;
      stage_row(cap_b + (buf * kCols + tid) * kLdCB,
                cap + (ok ? ((size_t)cg * L + tid % L) * D + k0 : 0), ok, k0, D, kSB, 0, 1);
    } else if (tid < kCols + kImgs * kR) {
      const int pr = tid - kCols;
      const bool ok = i0 + pr / kR < Ni;
      stage_row(img_b + (buf * kImgs * kR + pr) * kLdCB,
                img + (ok ? ((size_t)i0 * kR + pr) * D + k0 : 0), ok, k0, D, kSB, 0, 1);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  const int group = c0 / cpb;
  const int nsb = ldE / kSB;
  stage_b(0, 0);
  for (int sl = 0; sl < nsb; ++sl) {
    if (sl + 1 < nsb) {
      stage_b(sl + 1, (sl + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int k0 = kSB * sl;
    const float* gsl = ge_b + (sl & 1) * kRowsB * kLdGB;
    const T* csl = cap_b + (sl & 1) * kCols * kLdCB;
    const T* isl = img_b + (sl & 1) * kImgs * kR * kLdCB;
    if (warp < 6) {
      // dimg of image pi, regions 16 mt .. + 15, the slab's n8 tiles
      const float* gp = gsl + pi * kCols * kLdGB;
      const T* ip = isl + pi * kR * kLdCB;
      // [term: ge; cap and M][n8]: independent chains
      float acc[2][kNB][4] = {};
      // sum over the image's rows of (s_r ci) ge
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int cl = 16 * kk + 2 * t + 8 * j;
            split2(gp[cl * kLdGB + 8 * n + g], gp[(cl + 1) * kLdGB + 8 * n + g], bh[j], bl[j]);
          }
          mma_split<true>(acc[0][n], acc[0][n], fwh[kk], fwl[kk], bh[0], bh[1], bl[0],
                          bl[1]);
        }
      }
      // + gA cap
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int cl = 16 * kk + 2 * t + 8 * j;
            frag_pair(csl[cl * kLdCB + 8 * n + g], csl[(cl + 1) * kLdCB + 8 * n + g], bh[j],
                      bl[j]);
          }
          mma_split<kF32>(acc[1][n], acc[1][n], fgh[kk], fgl[kk], bh[0], bh[1], bl[0],
                          bl[1]);
        }
      }
      // - M img
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int r2 = 16 * kk + 2 * t + 8 * j;
            if (r2 < kR) {
              frag_pair(ip[r2 * kLdCB + 8 * n + g], ip[(r2 + 1) * kLdCB + 8 * n + g], bh[j],
                        bl[j]);
            } else {
              bh[j] = bl[j] = 0u;
            }
          }
          mma_split<kF32>(acc[1][n], acc[1][n], fmh[kk], fml[kk], bh[0], bh[1], bl[0],
                          bl[1]);
        }
      }
      if (i0 + pi < Ni) {
        const auto sum = [&](int n, int q) { return acc[0][n][q] + acc[1][n][q]; };
#pragma unroll
        for (int n = 0; n < kNB; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * mt + g + 8 * h;
            if (r < kR) {
              *reinterpret_cast<float2*>(
                  gimg_p + (((size_t)group * Ni + i0 + pi) * kR + r) * ldE + k0 + 8 * n + 2 * t) =
                  make_float2(sum(n, 2 * h), sum(n, 2 * h + 1));
            }
          }
      }
    }
    // dcap of image pi's rows 16 mc .. + 15 for mc in [mc0, mc1): gA^T img -
    // ge, written over ge
    {
      const float* gp = gsl + pi * kCols * kLdGB;
      const T* ip = isl + pi * kR * kLdCB;
      uint32_t bh[3][kNB][2], bl[3][kNB][2];
#pragma unroll
      for (int kk = 0; kk < 3; ++kk)
#pragma unroll
        for (int n = 0; n < kNB; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int r2 = 16 * kk + 2 * t + 8 * j;
            if (r2 < kR) {
              frag_pair(ip[r2 * kLdCB + 8 * n + g], ip[(r2 + 1) * kLdCB + 8 * n + g],
                        bh[kk][n][j], bl[kk][n][j]);
            } else {
              bh[kk][n][j] = bl[kk][n][j] = 0u;
            }
          }
#pragma unroll 1
      for (int mc = mc0; mc < mc1; ++mc) {
        uint32_t ah[3][4], al[3][4];
#pragma unroll
        for (int kk = 0; kk < 3; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int rp = 8 * kk + t + 4 * (q >> 1), cl = 16 * mc + g + 8 * (q & 1);
            ah[kk][q] = rp < kR / 2 ? gat_hi[rp * kLdS + cl] : 0u;
            al[kk][q] = rp < kR / 2 ? gat_lo[rp * kLdS + cl] : 0u;
          }
        // a chain per n8
        float acc[kNB][4] = {};
#pragma unroll
        for (int kk = 0; kk < 3; ++kk)
#pragma unroll
          for (int n = 0; n < kNB; ++n) {
            mma_split<kF32>(acc[n], acc[n], ah[kk], al[kk], bh[kk][n][0], bh[kk][n][1],
                            bl[kk][n][0], bl[kk][n][1]);
          }
#pragma unroll
        for (int n = 0; n < kNB; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long ro = row_of[pi * kCols + 16 * mc + g + 8 * h];
            const float2 gv = *reinterpret_cast<const float2*>(
                gp + (16 * mc + g + 8 * h) * kLdGB + 8 * n + 2 * t);
            if (ro >= 0) {
              *reinterpret_cast<float2*>(e + ro * ldE + k0 + 8 * n + 2 * t) =
                  make_float2(acc[n][2 * h] - gv.x, acc[n][2 * h + 1] - gv.y);
            }
          }
      }
    }
    __syncthreads();  // the slab's readers are done before it is refilled
  }
}

// gcap[c, l] = sum over images of the rows' dcap (E), in image order
template <typename T>
__global__ void gcap_reduce(const float* __restrict__ e, const float* __restrict__ mask, Rows rw,
                            T* __restrict__ gcap, int D, int ldE) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)rw.Nc * rw.L * D) return;
  const int k = idx % D;
  const size_t cl = idx / D;
  const int c = cl / rw.L, l = cl % rw.L;
  float sum = 0.0f;
  if (mask[cl] > 0.0f) {
    const long long r0 = rw.row(c, 0, l);
    const long long len = rw.cstart[c + 1] - rw.cstart[c];
    for (int i = 0; i < rw.Ni; ++i) sum += e[(r0 + i * len) * ldE + k];
  }
  gcap[idx] = from_f<T>(sum);
}

template <typename T>
__global__ void gimg_reduce(const float* __restrict__ gimg_p, T* __restrict__ gimg, int Ni,
                            int D, int ldE, int n_groups) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_out = (size_t)Ni * kR * D;
  if (idx >= n_out) return;
  const size_t ir = idx / D;
  const int k = idx % D;
  float sum = 0.0f;
  for (int grp = 0; grp < n_groups; ++grp) {
    sum += gimg_p[((size_t)grp * Ni * kR + ir) * ldE + k];
  }
  gimg[idx] = from_f<T>(sum);
}

unsigned blocks_for(size_t n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <typename T>
int run(const void* cap, const void* mask, const void* img, const void* gram, const void* wsplit,
        const void* wtsplit, const void* b, const void* g, const int* pos, const int* cstart,
        void* gcap, void* gimg, float* gw, float* gb, float* ws_e, float* ws_gy, float* gimg_p,
        float* gw_p, float* gb_p, int Ni, int Nc, int L, int D, int S, int splits,
        cudaStream_t stream) {
  if (L < 1 || L > kCols || S < 4 || S > kMaxS || S % 4 != 0 || D < 1 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (std::is_same<T, __nv_bfloat16>::value && D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (Nc == 0 || Ni == 0) return (int)cudaSuccess;
  const int ldE = (D + kSlab - 1) / kSlab * kSlab;   // = Kp of the split weight
  const int Ks = (S + kSlab - 1) / kSlab * kSlab;    // depth of the W^T split
  const int S8 = (S + 7) / 8 * 8;
  const int cpb = caps_per_block(L);
  const int n_groups = (Nc + cpb - 1) / cpb;
  const int n_pairs = (Ni + kImgs - 1) / kImgs;
  const long long n_blocks = (long long)n_groups * n_pairs;
  const long long max_rows = (long long)Nc * L * Ni;
  const long long ge_blocks = (max_rows + kMmaRows - 1) / kMmaRows;
  if (n_blocks > 0x7fffffffLL || ge_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  const T* capt = static_cast<const T*>(cap);
  const T* imgt = static_cast<const T*>(img);
  const Rows rw{cstart, pos, Ni, Nc, L};
  const int rows_bytes = kMmaFloats * 4;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  rows_bytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(gw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kGwBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kGeBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(region_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kRegionBytes)) != cudaSuccess) {
    return (int)err;
  }
  rows_kernel<T><<<(unsigned)n_blocks, kThreads, rows_bytes, stream>>>(
      capt, f(mask), imgt, f(gram), u(wsplit), f(b), static_cast<const T*>(g), rw, ws_gy, ws_e,
      Ni, Nc, L, D, ldE, S, S8, cpb, n_groups);
  gw_kernel<<<dim3((S + kGwM - 1) / kGwM, (D + kGwN - 1) / kGwN, splits), kThreads, kGwBytes,
              stream>>>(ws_gy, ws_e, cstart, gw_p, gb_p, Ni, Nc, D, ldE, S, splits);
  gw_reduce<<<blocks_for((size_t)S * D + S, 256), 256, 0, stream>>>(gw_p, gb_p, gw, gb, S, D,
                                                                     ldE, splits);
  ge_kernel<<<(unsigned)ge_blocks, kThreads, kGeBytes, stream>>>(ws_gy, u(wtsplit), ws_e, cstart,
                                                                  Ni, Nc, D, ldE, S, Ks);
  region_kernel<T><<<(unsigned)n_blocks, kThreads, kRegionBytes, stream>>>(
      capt, f(mask), imgt, f(gram), ws_e, rw, gimg_p, Ni, Nc, L, D, ldE, cpb, n_groups);
  gcap_reduce<T><<<blocks_for((size_t)Nc * L * D, 256), 256, 0, stream>>>(
      ws_e, f(mask), rw, static_cast<T*>(gcap), D, ldE);
  gimg_reduce<T><<<blocks_for((size_t)Ni * kR * D, 256), 256, 0, stream>>>(
      gimg_p, static_cast<T*>(gimg), Ni, D, ldE, n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward of itrx_sgraf_align.  cap (Nc, L, D), img (Ni, 36, D), g
// (Nc, Ni, L, S), gcap and gimg (out) all fp32 or all bf16 (bf16 != 0; then
// D % 8 == 0, cap and img 16-byte aligned); mask (Nc, L), gram (Ni, 36, 36),
// b (S,) fp32; wsplit sim_tranloc_w (S, D) split for the tensor cores
// (ops/kernels/sgraf_eval.py::split_weight: S8 rows of Kp words, Kp = D
// rounded up to 32), wtsplit its transpose in chunks of 256 rows of D
// (ops/kernels/sgraf_align.py::split_weight_t: each chunk 256 rows of Ks
// words, Ks = S rounded up to 32); pos (Nc, L) and cstart (Nc + 1,) int32,
// the valid words' ranks and each caption's first word, then their number;
// gw (S, D) and gb (S,) fp32 out.  Workspaces, fp32, rows = Nc L Ni (the
// most valid rows there can be): ws_e (rows, Kp), ws_gy (rows, S), gimg_p
// (ceil(Nc / captions a block), Ni, 36, Kp), gw_p (splits, S, Kp), gb_p
// (splits, S).  1 <= L <= 128; S % 4 == 0, S <= 256.  Seven launches on
// `stream` of CUDA device `device`, none of which the host waits for;
// returns cudaGetLastError().
int itrx_sgraf_align_bwd(const void* cap, const void* mask, const void* img, const void* gram,
                         const void* wsplit, const void* wtsplit, const void* b, const void* g,
                         const void* pos, const void* cstart, void* gcap, void* gimg, void* gw,
                         void* gb, void* ws_e, void* ws_gy, void* gimg_p, void* gw_p, void* gb_p,
                         int Ni, int Nc, int L, int D, int S, int splits, int bf16, int device,
                         void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto fp = [](void* v) { return static_cast<float*>(v); };
  const int* ip = static_cast<const int*>(pos);
  const int* ic = static_cast<const int*>(cstart);
  if (bf16) {
    return run<__nv_bfloat16>(cap, mask, img, gram, wsplit, wtsplit, b, g, ip, ic, gcap, gimg,
                              fp(gw), fp(gb), fp(ws_e), fp(ws_gy), fp(gimg_p), fp(gw_p),
                              fp(gb_p), Ni, Nc, L, D, S, splits, s);
  }
  return run<float>(cap, mask, img, gram, wsplit, wtsplit, b, g, ip, ic, gcap, gimg, fp(gw),
                    fp(gb), fp(ws_e), fp(ws_gy), fp(gimg_p), fp(gw_p), fp(gb_p), Ni, Nc, L, D,
                    S, splits, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
