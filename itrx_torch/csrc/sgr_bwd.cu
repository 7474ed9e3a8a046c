// SGRAF-SGR graph reasoning in training, the backward, for sm_90a.
//
// Replaces itrx/ops/pallas/sgr.py::_bwd_kernel.  Given the forward's input
// s0 and its saved step outputs (sgr.cu), and the cotangent g of the last
// step, the steps run in reverse; for step i with input X (s0 or the
// previous save) and output Y, over each pair's valid nodes:
//   sm     = X M,  e_ab = sm_a . X_b + X_b . v,  a = softmax_b(e),  ctx = a X
//                                                   (recomputed from X)
//   g_pre  = g where Y > 0, else 0                  (the ReLU's adjoint)
//   dWg   += g_pre^T ctx,  dbg += sum g_pre,  g_ctx = g_pre Wg
//   g_a    = g_ctx X^T,  g_e = a (g_a - rowsum(g_a a))   (the softmax's)
//   g_sm   = g_e X,  col_b = sum_a g_e_ab
//   dM    += X^T g_sm,  dv += X^T col
//   g      = a^T g_ctx + g_e^T sm + col v + g_sm M^T     (the cotangent of X)
// with M = Wq^T Wk and v = Wk^T bq; the wrapper turns dM, dv into dWq, dWk,
// dbq (dbk is 0).  The cotangents of masked nodes are ignored and the
// returned g is zero there.
//
// What bounds it: per pair and step five S x S products (X M again,
// g_pre Wg, g_sm M^T and the two weight sums, 10 n S^2), then the edges (the
// forward's again, g_a, g_sm and the key-side sums, about 12 n^2 S), about
// a tenth of the products at n ~ 14, S 256.  All five products run on the
// tensor cores as split-bf16 products (sgraf_nodes_mma.cuh: x = hi + lo both
// bf16, three passes a_hi b_lo + a_lo b_hi + a_hi b_hi, fp32 accumulation;
// two passes where the operand is step 0's bf16 nodes, which are exact), so
// the cotangents keep fp32 accuracy through the steps; the edges are fp32.
// Design: five launches a step over a list of the valid rows formed on the
// card (the rows in order and each pair's first row in it, in device
// memory, by sgr_rows.cuh's plan kernels, in training the forward's: grids
// are sized from B x N and no pass reads the row count on the host):
//   1. gctx_sm_kernel: g_ctx = g_pre Wg (the gate applied as the operand is
//      formed, g_pre written out for the weight sums) and sm = X M, a 64-row
//      tile of the list a block on wgmma (sgr_rows.cuh's row_tile over
//      mma_tile, the weights split once a call by the wrapper and staged by
//      TMA), both products in one grid;
//   2. edge_kernel, a persistent grid (two blocks an SM), block b over the
//      pairs bounds[b] .. (ranges of about equal n (n + 4), from the plan)
//      in batches: as many whole pairs' X, sm and g_ctx rows as
//      fit 110 KB staged by cp.async once, then one warp a unit of two query
//      rows of a pair, sharing each key row's reads: e and g_a over the keys
//      (eight keys' 32 warp sums reduced together by recursive halving), the
//      two softmaxes, ctx and g_sm in one pass; then the column sums and,
//      one warp a unit of two key rows, g_e^T sm + a^T g_ctx + col v.
//      Pairs too large to stage (129 nodes at S 256) take
//      edge_stream_kernel, one block a pair reading the rows from device
//      memory;
//   3. wsum_kernel: [dWg | dbg] = g_pre^T [ctx | 1] and [dM | dv] =
//      X^T [g_sm | col] over fixed splits of the list, a 128 x 256 tile a
//      block (m64n256 wgmma a warpgroup): each slab's gathered rows come by
//      cp.async two slabs ahead (their list entries three ahead), both
//      operands are split from shared memory a slab ahead of their products,
//      the bias column summed as the operand is formed; then wsum_reduce
//      sums the splits in order;
//   4. g_kernel: g = that workspace + g_sm M^T, the tile product with the
//      sum added in its epilogue.
// No atomics: every sum runs in a fixed order, so two calls give identical
// gradients.  Each launch's time on the card, at one training chunk, is in
// PERF.md §6; python -m itrx_torch.tools.sgr_bwd_phases times edge_kernel's
// phases.
#include "sgr_rows.cuh"
#include "sgraf_nodes_mma.cuh"

namespace {

using namespace itrx_sgr;
using namespace itrx_sgraf_mma;

// ---------------------------------------------------------------- rows
// blockIdx.y 0: g_ctx = g_pre Wg, g_pre = g where y > 0 (written to gpre);
// 1: sm = X M; over the list's tile blockIdx.x (a block past the count
// returns)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
gctx_sm_kernel(const float* __restrict__ g, const float* __restrict__ y,
               const T* __restrict__ x, const int* __restrict__ rows,
               const int* __restrict__ count, const uint32_t* __restrict__ gsplit,
               const uint32_t* __restrict__ mtsplit, float* __restrict__ gpre,
               float* __restrict__ gctx, float* __restrict__ sm, int S, int Ks, int S8) {
  __shared__ int row_at[kMmaRows];
  const int n_rows = *count;
  if ((long long)blockIdx.x * kMmaRows >= n_rows) return;
  init_weight_bars();
  if (blockIdx.y == 0) {
    row_tile<true, float, true>(g, y, gpre, nullptr, nullptr, false, gctx, rows, n_rows, row_at,
                                gsplit, S, Ks, S8);
  } else {
    row_tile<sizeof(T) == 4, T, false>(x, nullptr, nullptr, nullptr, nullptr, false, sm, rows,
                                       n_rows, row_at, mtsplit, S, Ks, S8);
  }
}

// g = gx + g_sm M^T over the list's tile blockIdx.x
__global__ void __launch_bounds__(kThreads, 2)
g_kernel(const float* __restrict__ gsm, const float* __restrict__ gx, float* __restrict__ g,
         const int* __restrict__ rows, const int* __restrict__ count,
         const uint32_t* __restrict__ msplit, int S, int Ks, int S8) {
  __shared__ int row_at[kMmaRows];
  const int n_rows = *count;
  if ((long long)blockIdx.x * kMmaRows >= n_rows) return;
  init_weight_bars();
  row_tile<true, float, false>(gsm, nullptr, nullptr, nullptr, gx, false, g, rows, n_rows, row_at,
                               msplit, S, Ks, S8);
}

// ---------------------------------------------------------------- edges
constexpr int kKeys = 8;  // keys a query unit reduces together: 2 rows x 2 sums x 8 = 32

// the rows a batch stages: per row X, sm, g_ctx (S floats each), its two
// table rows (N each), its sv and column sum, its pair's first row and size
// and the batch's row units
__host__ __device__ inline int batch_rows(int N, int S) {
  return kEdgeBytes / 4 / (3 * S + 2 * N + 5);
}

// A unit of one or two query rows of a pair (rows a and a + 1 of it when
// `two`), by one warp, sharing each key row's reads: the edge rows over the
// pair's n keys X(b), e_b = q . X_b + sv[b], and g_a_b = gc . X_b (eight
// keys' 32 sums reduced together); the softmax a into arow and g_e = a (g_a -
// a . g_a) into grow (rows ld apart); then ctx = a X and g_sm = g_e X in one
// pass over the keys.  A lone row is formed twice in the same place.
template <typename XR>
__device__ __forceinline__ void query_rows(const XR& X, const Row8 (&q)[2], const Row8 (&gc)[2],
                                           const float* sv, int n, float* arow, float* grow,
                                           int ld, bool two, Row8 (&ctx)[2], Row8 (&g2)[2]) {
  const int lane = threadIdx.x % 32;
  // lane l holds value l: row l / 16, e of key l % 8 (l % 16 < 8), else g_a
  // (a lone row's second copy, summed in another order, is not written)
  const int row = lane / 16;
  const bool writer = two || row == 0;
  for (int b0 = 0; b0 < n; b0 += kKeys) {
    float p[4 * kKeys];
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const Row8 kb = X(min(b0 + k, n - 1));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        p[2 * kKeys * r + k] = row_part(q[r], kb);
        p[2 * kKeys * r + kKeys + k] = row_part(gc[r], kb);
      }
    }
    const float v = warp_sums(p);
    const int b = b0 + lane % kKeys;
    if (writer && b < n) {
      if (lane % (2 * kKeys) < kKeys) {
        arow[row * ld + b] = v + sv[b];
      } else {
        grow[row * ld + b] = v;
      }
    }
  }
  __syncwarp();
  if (n <= 32) {
    // a lane a key: both rows' softmax and adjoint with their warp sums
    // interleaved (the same order as the loop below)
    const int l1 = two ? ld : 0;
    const bool in = lane < n;
    const float e0 = in ? arow[lane] : -3.0e38f, e1 = in ? arow[l1 + lane] : -3.0e38f;
    float m0 = e0, m1 = e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float p0 = in ? expf(e0 - m0) : 0.0f, p1 = in ? expf(e1 - m1) : 0.0f;
    float s0 = p0, s1 = p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    p0 *= 1.0f / s0;
    p1 *= 1.0f / s1;
    const float g0 = in ? grow[lane] : 0.0f, g1 = in ? grow[l1 + lane] : 0.0f;
    float d0 = fmaf(p0, g0, 0.0f), d1 = fmaf(p1, g1, 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    }
    if (in) {
      arow[lane] = p0;
      grow[lane] = p0 * (g0 - d0);
      if (two) {
        arow[ld + lane] = p1;
        grow[ld + lane] = p1 * (g1 - d1);
      }
    }
  }
  for (int r = 0; n > 32 && r < (two ? 2 : 1); ++r) {
    float* ar = arow + r * ld;
    float* gr = grow + r * ld;
    float mx = -3.0e38f;
    for (int b = lane; b < n; b += 32) mx = fmaxf(mx, ar[b]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int b = lane; b < n; b += 32) {
      const float p = expf(ar[b] - mx);
      ar[b] = p;
      sum += p;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int b = lane; b < n; b += 32) ar[b] *= inv;
    // the softmax's adjoint, over the row
    float d = 0.0f;
    for (int b = lane; b < n; b += 32) d = fmaf(ar[b], gr[b], d);
    d = warp_sum(d);
    for (int b = lane; b < n; b += 32) gr[b] = ar[b] * (gr[b] - d);
  }
  __syncwarp();
  const int l1 = two ? ld : 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ctx[r] = row_zero();
    g2[r] = row_zero();
  }
#pragma unroll 2
  for (int b = 0; b < n; ++b) {
    const Row8 kb = X(b);
    row_fma(ctx[0], arow[b], kb);
    row_fma(g2[0], grow[b], kb);
    row_fma(ctx[1], arow[l1 + b], kb);
    row_fma(g2[1], grow[l1 + b], kb);
  }
}

// A unit of one or two key rows of a pair (columns b and b + 1 of its
// tables when `two`), by one warp, sharing each query row's reads:
// c v + sum_a (att_ab g_ctx_a + gev_ab sm_a) over the pair's n query rows,
// the tables' columns read at stride ld.
template <typename FR>
__device__ __forceinline__ void key_rows(const FR& SM, const FR& GC, const float* att,
                                         const float* gev, int ld, int n, bool two,
                                         const float (&c)[2], const Row8& vr, Row8 (&acc)[2]) {
  const int c1 = two ? 1 : 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    acc[r] = row_zero();
    row_fma(acc[r], c[r], vr);
  }
#pragma unroll 2
  for (int a = 0; a < n; ++a) {
    const Row8 gca = GC(a), sma = SM(a);
    row_fma(acc[0], att[a * ld], gca);
    row_fma(acc[0], gev[a * ld], sma);
    row_fma(acc[1], att[a * ld + c1], gca);
    row_fma(acc[1], gev[a * ld + c1], sma);
  }
}

// The edges of whole pairs in batches of staged X, sm and g_ctx rows
// (sgr_rows.cuh's next_batch; the plan balances the ranges' n (n + 4)),
// then one warp a unit of two query rows of a pair, the column sums, and
// one warp a unit of two key rows.  ctx, g_sm, col and gx are written at the rows.  Every
// pair's N rows fit a batch.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
edge_kernel(const T* __restrict__ x, const int* __restrict__ rows,
            const int* __restrict__ pstart, const int* __restrict__ bounds,
            const float* __restrict__ sm, const float* __restrict__ v,
            const float* __restrict__ gctx, float* __restrict__ ctx, float* __restrict__ gsm,
            float* __restrict__ gx, float* __restrict__ col, int N, int S) {
  extern __shared__ __align__(16) float esmem[];
  __shared__ int n_units;
  const int cap = batch_rows(N, S);
  T* const xs = reinterpret_cast<T*>(esmem);  // [cap][S] X, as given
  float* const ss = esmem + cap * S;    // [cap][S] sm
  float* const gs = ss + cap * S;       // [cap][S] g_ctx
  float* const att = gs + cap * S;      // [cap][N] the query rows' softmax weights a
  float* const gev = att + cap * N;     // [cap][N] g_a, then g_e
  float* const sv = gev + cap * N;      // [cap] X_b . v
  float* const cs = sv + cap;           // [cap] column sums of g_e
  int* const kst = reinterpret_cast<int*>(cs + cap);  // [cap] the row's pair's first row
  int* const kn = kst + cap;                          // [cap] and its rows
  int* const units = kn + cap;                        // [cap] each unit's first row
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int p0 = bounds[blockIdx.x], p1 = bounds[blockIdx.x + 1];
  const Row8 vr = load_row(v, S);
  for (int q0 = p0; q0 < p1;) {
    const Batch bt = next_batch(q0, p1, pstart, cap, kst, kn);
    const int r0 = bt.r0, R = bt.R;
    const int vecs = S / 4;
    for (int idx = tid; idx < R * vecs; idx += kThreads) {
      const int r = idx / vecs, c = 4 * (idx % vecs);
      const size_t o = (size_t)rows[r0 + r] * S + c;
      cp_async_4(xs + r * S + c, x + o, true);
      cp_async16(ss + r * S + c, sm + o, true);
      cp_async16(gs + r * S + c, gctx + o, true);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (warp == 0) pair_units(kst, R, units, &n_units);
    for (int r = warp; r < R; r += kWarps) {
      const float e = row_dot(load_row(xs + r * S, S), vr);
      if (lane == 0) sv[r] = e;
    }
    __syncthreads();
    const int nu = n_units;
    for (int u = warp; u < nu; u += kWarps) {
      const int a = units[u], k0 = kst[a], n = kn[a];
      const bool two = a + 1 < k0 + n;
      const int a1 = two ? a + 1 : a;
      const Row8 q[2] = {load_row(ss + a * S, S), load_row(ss + a1 * S, S)};
      const Row8 gc[2] = {load_row(gs + a * S, S), load_row(gs + a1 * S, S)};
      Row8 c[2], g2[2];
      query_rows(PairRows<T, true>{xs + k0 * S, nullptr, S}, q, gc, sv + k0, n, att + a * N,
                 gev + a * N, N, two, c, g2);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 0 || two) {
          const size_t o = (size_t)rows[r0 + a + r] * S;
          store_row(ctx + o, c[r], S);
          store_row(gsm + o, g2[r], S);
        }
      }
    }
    __syncthreads();
    // the key side: column sums of g_e, then per unit of key rows
    for (int b = tid; b < R; b += kThreads) {
      const int k0 = kst[b], n = kn[b];
      float c = 0.0f;
      for (int a = 0; a < n; ++a) c += gev[(k0 + a) * N + b - k0];
      cs[b] = c;
      col[rows[r0 + b]] = c;
    }
    __syncthreads();
    for (int u = warp; u < nu; u += kWarps) {
      const int b = units[u], k0 = kst[b], n = kn[b];
      const bool two = b + 1 < k0 + n;
      const PairRows<float, true> sk{ss + k0 * S, nullptr, S}, gk{gs + k0 * S, nullptr, S};
      const float c[2] = {cs[b], cs[two ? b + 1 : b]};
      Row8 acc[2];
      key_rows(sk, gk, att + k0 * N + b - k0, gev + k0 * N + b - k0, N, n, two, c, vr, acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 0 || two) store_row(gx + (size_t)rows[r0 + b + r] * S, acc[r], S);
      }
    }
    __syncthreads();  // the next batch restages the rows
    q0 = bt.q1;
  }
}

// The edges of one pair a block, its rows read from device memory (pairs
// whose N rows do not fit a batch), in units of two rows as edge_kernel.
// Dynamic shared memory: the tables a and g_e, N x N each.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_stream_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                   const float* __restrict__ sm, const float* __restrict__ v,
                   const float* __restrict__ gctx, float* __restrict__ ctx,
                   float* __restrict__ gsm, float* __restrict__ gx, float* __restrict__ col,
                   int N, int S) {
  extern __shared__ __align__(16) float esmem[];
  float* const att = esmem;           // [N][N] softmax weights a
  float* const gev = esmem + N * N;   // [N][N] g_a, then g_e
  __shared__ int vidx[kMaxN];
  __shared__ float sv[kMaxN];
  __shared__ float cs[kMaxN];
  __shared__ int n_s;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t base = (size_t)blockIdx.x * N;
  const int n = list_nodes(mask + base, N, vidx, &n_s);
  const PairRows<T, false> X{x + base * S, vidx, S};
  const PairRows<float, false> SM{sm + base * S, vidx, S}, GC{gctx + base * S, vidx, S};
  const Row8 vr = load_row(v, S);
  for (int b = warp; b < n; b += kWarps) {
    const float e = row_dot(X(b), vr);
    if (lane == 0) sv[b] = e;
  }
  __syncthreads();
  for (int a = 2 * warp; a < n; a += 2 * kWarps) {
    const bool two = a + 1 < n;
    const int a1 = two ? a + 1 : a;
    const Row8 q[2] = {SM(a), SM(a1)}, gc[2] = {GC(a), GC(a1)};
    Row8 c[2], g2[2];
    query_rows(X, q, gc, sv, n, att + a * N, gev + a * N, N, two, c, g2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 0 || two) {
        const size_t ra = (base + vidx[a + r]) * S;
        store_row(ctx + ra, c[r], S);
        store_row(gsm + ra, g2[r], S);
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n; b += kThreads) {
    float c = 0.0f;
    for (int a = 0; a < n; ++a) c += gev[a * N + b];
    cs[b] = c;
    col[base + vidx[b]] = c;
  }
  __syncthreads();
  for (int b = 2 * warp; b < n; b += 2 * kWarps) {
    const bool two = b + 1 < n;
    const float c[2] = {cs[b], cs[two ? b + 1 : b]};
    Row8 acc[2];
    key_rows(SM, GC, att + b, gev + b, N, n, two, c, vr, acc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 0 || two) store_row(gx + (base + vidx[b + r]) * S, acc[r], S);
    }
  }
}

// ---------------------------------------------------------------- weight sums
constexpr int kWsM = 2 * kMmaRows;      // rows (of S) of a tile: an m64 a warpgroup
constexpr int kWsN = kMaxS;             // its columns: n256
constexpr int kWsA = kWsM * kSlab;      // words of one A slab (split)
constexpr int kWsB = kWsN * kSlab;      // words of one B slab (split)
// a slab's gathered rows as they come (cp.async), row strides padded so
// that the split's reads (8 rows x 4 k pairs a warp) meet no bank conflict:
// A's 128 columns (fp32, or bf16 in 68 words), B's S columns, and the rows'
// bias weights
constexpr int kLdRA = kWsM + 4;
constexpr int kLdRB = kWsN + 4;
constexpr int kRawA = kSlab * kLdRA;
constexpr int kRawB = kSlab * kLdRB;
constexpr int kRawStage = kRawA + kRawB + kSlab;    // floats
template <typename T>
__host__ __device__ constexpr int ld_ra() { return sizeof(T) == 4 ? kLdRA : kWsM + 8; }
// two split buffers and two raw stages: 194 KB, one block an SM
constexpr int kWsBytes = (2 * (kWsA + kWsB) + 2 * kRawStage) * 4;

// Rows [kb, ke) of the list: the 128 x 256 tile (rows s0.., all S columns)
// of A^T B on wgmma into pw (S, S), warpgroup wg its rows s0 + 64 wg ..,
// and the bias column sum_r A(r, m) w(r) into pb (S,), w(r) = wcol[r] (1
// where wcol is null).  A (B N, S) in TA, B (B N, S) fp32.  kALo false
// where A is bf16 (exact in its hi part: two passes).
template <bool kALo, typename TA>
__device__ __forceinline__ void wsum_tile(const TA* __restrict__ asrc,
                                          const float* __restrict__ bsrc,
                                          const float* __restrict__ wcol,
                                          const int* __restrict__ rows, int kb, int ke, int s0,
                                          int S, float* __restrict__ pw,
                                          float* __restrict__ pb) {
  extern __shared__ __align__(128) float smem[];
  uint32_t* const a_s = reinterpret_cast<uint32_t*>(smem);   // [2][kWsA]
  uint32_t* const b_s = a_s + 2 * kWsA;                      // [2][kWsB]
  float* const raw = smem + 2 * (kWsA + kWsB);               // [2][kRawStage]
  constexpr int kLdA = ld_ra<TA>();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, wg = tid / 128;
  const int nslab = (ke - kb + kSlab - 1) / kSlab;
  // this thread forms k pairs 4c + t (c = 2 st + kg) of A rows as_ and
  // as_ + 64 and of B rows 8 (warp + 8j) + lane / 4: lanes of a warp on 8
  // rows x 4 pairs, so that their words fall in 32 banks
  const int t = tid % 4, as_ = tid / 4, bd = lane / 4;
  float db[2] = {0.0f, 0.0f};
  // the list rows of this thread's copies of a slab (A's 4, B's 8, the
  // weight's 1; -1 past the split), loaded a slab before its copies are
  // issued, so that no copy waits on the list
  constexpr int kCA = kSlab * (kWsM / 4) / kThreads, kCB = kSlab * (kWsN / 4) / kThreads;
  int ra_[kCA], rb_[kCB], rw_;
  const auto load_rows = [&](int sl) {
    const int k0 = kb + sl * kSlab;
#pragma unroll
    for (int i = 0; i < kCA; ++i) {
      const int k = k0 + (tid + kThreads * i) / (kWsM / 4);
      ra_[i] = k < ke ? rows[k] : -1;
    }
#pragma unroll
    for (int i = 0; i < kCB; ++i) {
      const int k = k0 + (tid + kThreads * i) / (kWsN / 4);
      rb_[i] = k < ke ? rows[k] : -1;
    }
    rw_ = tid < kSlab && k0 + tid < ke ? rows[k0 + tid] : -1;
  };
  // the slab whose rows load_rows took into raw stage buf, one commit group
  const auto stage = [&](int buf) {
    float* st = raw + buf * kRawStage;
#pragma unroll
    for (int i = 0; i < kCA; ++i) {
      const int idx = tid + kThreads * i;
      const int rr = idx / (kWsM / 4), m = 4 * (idx % (kWsM / 4));
      const bool ok = ra_[i] >= 0 && s0 + m < S;
      cp_async_4(reinterpret_cast<TA*>(st) + rr * kLdA + m,
                 asrc + (ok ? (size_t)ra_[i] * S + s0 + m : 0), ok);
    }
#pragma unroll
    for (int i = 0; i < kCB; ++i) {
      const int idx = tid + kThreads * i;
      const int rr = idx / (kWsN / 4), n = 4 * (idx % (kWsN / 4));
      const bool ok = rb_[i] >= 0 && n < S;
      cp_async16(st + kRawA + rr * kLdRB + n, ok ? bsrc + (size_t)rb_[i] * S + n : bsrc, ok);
    }
    if (wcol != nullptr && tid < kSlab) {
      cp_async4(st + kRawA + kRawB + tid, rw_ >= 0 ? wcol + rw_ : wcol, rw_ >= 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // raw stage buf into split buffer sb
  const auto make = [&](int buf, int sb) {
    const float* st = raw + buf * kRawStage;
    const TA* ra = reinterpret_cast<const TA*>(st);
    const float* rb = st + kRawA;
    const float* rw = rb + kRawB;
    uint32_t* a = a_s + sb * kWsA;
    uint32_t* b = b_s + sb * kWsB;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int st_ = c / 2, kg = c % 2, k = 2 * (4 * c + t);
      uint32_t hi, lo;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = as_ + 64 * h;
        const float x0 = to_f(ra[k * kLdA + m]), x1 = to_f(ra[(k + 1) * kLdA + m]);
        split2(x0, x1, hi, lo);
        a[2 * st_ * (kWsM * 8) + core_word(m, kg, t)] = hi;
        if constexpr (kALo) a[(2 * st_ + 1) * (kWsM * 8) + core_word(m, kg, t)] = lo;
        if (wcol != nullptr) {
          db[h] = fmaf(x0, rw[k], db[h]);
          db[h] = fmaf(x1, rw[k + 1], db[h]);
        } else {
          db[h] += x0 + x1;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 8 * (warp + 8 * j) + bd;
        split2(rb[k * kLdRB + d], rb[(k + 1) * kLdRB + d], hi, lo);
        b[2 * st_ * (kWsN * 8) + core_word(d, kg, t)] = hi;
        b[(2 * st_ + 1) * (kWsN * 8) + core_word(d, kg, t)] = lo;
      }
    }
  };

  float acc[32][4];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  fence_acc(acc);
  // the rows of slab sl come by cp.async into raw stage sl & 1, issued two
  // slabs ahead (their list entries three ahead); the split buffer sl & 1 is
  // formed a slab ahead, while the products of the slab before run
  if (nslab > 0) {
    load_rows(0);
    stage(0);
    if (nslab > 1) {
      load_rows(1);
      stage(1);
    }
    if (nslab > 2) load_rows(2);
    if (nslab > 1) {
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    make(0, 0);
  }
  for (int sl = 0; sl < nslab; ++sl) {
    // split slab sl is formed and visible to the tensor cores; every
    // thread is done with raw stage sl & 1 and every warpgroup with split
    // slab sl - 1
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (sl + 2 < nslab) {
      stage(sl & 1);
      if (sl + 3 < nslab) load_rows(sl + 3);
    }
    // this warpgroup's 64 rows of A: core rows 8 wg ..
    const uint32_t* as = a_s + (sl & 1) * kWsA + wg * 8 * 2 * kCoreWords;
    const uint32_t* bs = b_s + (sl & 1) * kWsB;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const uint64_t ah = smem_desc(as + (2 * st) * (kWsM * 8), 128, 256);
      const uint64_t al = smem_desc(as + (2 * st + 1) * (kWsM * 8), 128, 256);
      const uint64_t bh = smem_desc(bs + (2 * st) * (kWsN * 8), 128, 256);
      const uint64_t bl = smem_desc(bs + (2 * st + 1) * (kWsN * 8), 128, 256);
      wgmma_m64n256(acc, ah, bl);
      if constexpr (kALo) wgmma_m64n256(acc, al, bh);
      wgmma_m64n256(acc, ah, bh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (sl + 1 < nslab) {
      // slab sl + 1's rows have landed (slab sl + 2's may still be in flight)
      if (sl + 2 < nslab) {
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      make((sl + 1) & 1, (sl + 1) & 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }
  const Frag f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = s0 + 64 * wg + f.row(h);
    if (s >= S) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int d = 8 * i + 2 * f.t;
      if (d < S) {
        *reinterpret_cast<float2*>(pw + (size_t)s * S + d) =
            make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
      }
    }
  }
  // the bias column: the four pair groups of each row summed in a fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    db[h] += __shfl_xor_sync(0xffffffffu, db[h], 1);
    db[h] += __shfl_xor_sync(0xffffffffu, db[h], 2);
    if (t == 0 && s0 + as_ + 64 * h < S) pb[s0 + as_ + 64 * h] = db[h];
  }
}

// Split z of the list's rows: z < splits for [dWg | dbg] = g_pre^T
// [ctx | 1], else [dM | dv] = X^T [g_sm | col]; rows (of S) blockIdx.x *
// 128 ..; partials into pw (2, splits, S, S) and pb (2, splits, S).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wsum_kernel(const float* __restrict__ gpre, const float* __restrict__ ctx,
            const T* __restrict__ x, const float* __restrict__ gsm,
            const float* __restrict__ col, const int* __restrict__ rows,
            const int* __restrict__ count, float* __restrict__ pw, float* __restrict__ pb,
            int S, int splits) {
  const int z = blockIdx.z, s0 = blockIdx.x * kWsM;
  const int n_rows = *count;
  const int per = (n_rows + splits - 1) / splits;
  const int kb = min(n_rows, (z % splits) * per), ke = min(n_rows, kb + per);
  float* const w = pw + (size_t)z * S * S;
  float* const b = pb + (size_t)z * S;
  if (z < splits) {
    wsum_tile<true>(gpre, ctx, nullptr, rows, kb, ke, s0, S, w, b);
  } else {
    wsum_tile<sizeof(T) == 4>(x, gsm, col, rows, kb, ke, s0, S, w, b);
  }
}

// dWg, dbg, dM, dv of one step: the splits of the partials summed in order
__global__ void wsum_reduce(const float* __restrict__ pw, const float* __restrict__ pb,
                            float* __restrict__ dwg, float* __restrict__ dbg,
                            float* __restrict__ dmm, float* __restrict__ dvv, int S,
                            int splits) {
  const size_t sq = (size_t)S * S, n_out = sq + S;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n_out) return;
  const int which = idx / n_out;
  const size_t o = idx % n_out;
  float sum = 0.0f;
  if (o < sq) {
    for (int z = 0; z < splits; ++z) sum += pw[((size_t)which * splits + z) * sq + o];
    (which == 0 ? dwg : dmm)[o] = sum;
  } else {
    for (int z = 0; z < splits; ++z) sum += pb[((size_t)which * splits + z) * S + o - sq];
    (which == 0 ? dbg : dvv)[o - sq] = sum;
  }
}

struct Step {
  const uint32_t* mt;  // M^T split: sm = X M
  const uint32_t* m;   // M split: g_sm M^T
  const uint32_t* wg;  // Wg^T split: g_ctx = g_pre Wg
  const float* vv;     // (S,)
  float *dmm, *dvv, *dwg, *dbg;
};

struct Work {
  float *sm, *ctx, *gctx, *gsm, *gx, *gpre, *col, *pw, *pb;
};

// the valid rows: the list, each pair's first row in it, and their count;
// the edge pass's pair ranges
struct List {
  const int* rows;    // (B N,) the valid rows p N + j in order first
  const int* pstart;  // (B + 1,)
  const int* count;   // pstart + B
  const int* bounds;  // (edge_blocks + 1,) block b's pairs bounds[b] ..
  int edge_blocks;
};

// one step; g_in the cotangent of its output (read at valid rows), g that
// of its input (written at valid rows; g_in may be g)
template <typename T>
int step_bwd(const T* x, const float* y, const float* mask, const List& ls, const Step& w,
             const float* g_in, float* g, const Work& ws, int B, int N, int S, int splits,
             cudaStream_t stream) {
  const int Ks = (S + kSlab - 1) / kSlab * kSlab, S8 = (S + 7) / 8 * 8;
  const unsigned tiles = (unsigned)(((size_t)B * N + kMmaRows - 1) / kMmaRows);
  gctx_sm_kernel<T><<<dim3(tiles, 2), kThreads, kRowsBytes, stream>>>(
      g_in, y, x, ls.rows, ls.count, w.wg, w.mt, ws.gpre, ws.gctx, ws.sm, S, Ks, S8);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (batch_rows(N, S) >= N) {
    edge_kernel<T><<<(unsigned)ls.edge_blocks, kThreads, kEdgeBytes, stream>>>(
        x, ls.rows, ls.pstart, ls.bounds, ws.sm, w.vv, ws.gctx, ws.ctx, ws.gsm, ws.gx, ws.col,
        N, S);
  } else {
    edge_stream_kernel<T><<<(unsigned)B, kThreads, 2 * N * N * sizeof(float), stream>>>(
        x, mask, ws.sm, w.vv, ws.gctx, ws.ctx, ws.gsm, ws.gx, ws.col, N, S);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  wsum_kernel<T><<<dim3((S + kWsM - 1) / kWsM, 1, 2 * splits), kThreads, kWsBytes, stream>>>(
      ws.gpre, ws.ctx, x, ws.gsm, ws.col, ls.rows, ls.count, ws.pw, ws.pb, S, splits);
  const size_t n_out = 2 * ((size_t)S * S + S);
  wsum_reduce<<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(ws.pw, ws.pb, w.dwg, w.dbg,
                                                                  w.dmm, w.dvv, S, splits);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  g_kernel<<<tiles, kThreads, kRowsBytes, stream>>>(ws.gsm, ws.gx, g, ls.rows, ls.count, w.m, S,
                                                    Ks, S8);
  return (int)cudaGetLastError();
}

template <typename T>
int set_smem() {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(gctx_sm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kRowsBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(edge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kEdgeBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(edge_stream_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  2 * kMaxN * kMaxN * (int)sizeof(float))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(wsum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kWsBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kRowsBytes)) != cudaSuccess) {
    return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// The backward of itrx_sgr_fwd.  s0 (B, N, S) fp32 or bf16 (bf16 != 0), as
// given to the forward, 16-byte aligned; outs (steps, B, N, S) its fp32
// saves; mask (B, N) fp32; rows (B N,) int32, the valid rows p N + j in
// order first, pstart (B + 1,) int32, each pair's first row in that list
// and then their number, and bounds (edge_blocks + 1,) int32, the edge
// pass's pair ranges (ascending, bounds[0] = 0, bounds[edge_blocks] = B),
// all in device memory (the host never reads them); per step, split for the
// tensor cores (ops/kernels/sgraf_eval.py::split_weight: S8 rows of Ks
// words, Ks = S rounded up to 32): mtsplit M^T, msplit M, gsplit
// sim_graph_w^T, M = Wq^T Wk; vv (steps, S) fp32 = Wk^T bq; g_in (B, N, S)
// fp32, the cotangent of the last step (read at valid rows); g (B, N, S)
// fp32 out, the cotangent of s0 at valid rows (masked rows untouched; g may
// be g_in).  dmm, dwg (steps, S, S) and dvv, dbg (steps, S) fp32 out.
// Workspaces, fp32: ws_sm, ws_ctx, ws_gctx, ws_gsm, ws_gx, ws_gpre of B x N
// x S, ws_col of B x N, pw of 2 x splits x S x S, pb of 2 x splits x S.
// 1 <= N <= 129, S % 4 == 0, 4 <= S <= 256, steps >= 1, splits >= 1.
// 5 x steps launches on `stream` of CUDA device `device`, none of which the
// host waits for; returns the first CUDA error (cudaGetLastError()) or 0.
int itrx_sgr_bwd(const void* s0, const void* outs, const void* mask, const void* rows,
                 const void* pstart, const void* bounds, const void* mtsplit,
                 const void* msplit, const void* vv, const void* gsplit, const void* g_in,
                 void* g, void* dmm, void* dvv, void* dwg, void* dbg, void* ws_sm, void* ws_ctx,
                 void* ws_gctx, void* ws_gsm, void* ws_gx, void* ws_gpre, void* ws_col, void* pw,
                 void* pb,
                 int B, int N, int S, int steps, int splits, int edge_blocks, int bf16,
                 int device, void* stream) {
  if (N < 1 || N > kMaxN || S < 4 || S > kMaxS || S % 4 != 0 || steps < 1 || B < 0 ||
      splits < 1 || (size_t)B * N > 0x7fffffffULL || (B > 0 && edge_blocks < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  const size_t plane = (size_t)B * N * S, sq = (size_t)S * S;
  if (B == 0) {
    // no row: every weight cotangent is 0
    for (void* p : {dmm, dwg}) {
      const cudaError_t err = cudaMemsetAsync(p, 0, sizeof(float) * steps * sq, st);
      if (err != cudaSuccess) return (int)err;
    }
    for (void* p : {dvv, dbg}) {
      const cudaError_t err = cudaMemsetAsync(p, 0, sizeof(float) * steps * S, st);
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
  }
  int err = bf16 ? set_smem<__nv_bfloat16>() : set_smem<float>();
  if (err != 0) return err;
  if (bf16 && (err = set_smem<float>()) != 0) return err;
  const int Ks = (S + kSlab - 1) / kSlab * kSlab, S8 = (S + 7) / 8 * 8;
  const size_t wstep = (size_t)S8 * Ks;  // words of one step's split weight
  const int* ps = static_cast<const int*>(pstart);
  const List ls{static_cast<const int*>(rows), ps, ps + B, static_cast<const int*>(bounds),
                edge_blocks};
  const Work ws{f(ws_sm),   f(ws_ctx), f(ws_gctx), f(ws_gsm), f(ws_gx),
                f(ws_gpre), f(ws_col), f(pw),       f(pb)};
  for (int i = steps - 1; i >= 0; --i) {
    const Step w{u(mtsplit) + i * wstep, u(msplit) + i * wstep, u(gsplit) + i * wstep,
                 cf(vv) + (size_t)i * S, f(dmm) + i * sq, f(dvv) + (size_t)i * S,
                 f(dwg) + i * sq, f(dbg) + (size_t)i * S};
    const float* y = cf(outs) + i * plane;
    const float* gi = i == steps - 1 ? cf(g_in) : cf(g);
    if (i > 0) {
      err = step_bwd<float>(cf(outs) + (i - 1) * plane, y, cf(mask), ls, w, gi, f(g), ws, B, N,
                            S, splits, st);
    } else if (bf16) {
      err = step_bwd(static_cast<const __nv_bfloat16*>(s0), y, cf(mask), ls, w, gi, f(g), ws,
                     B, N, S, splits, st);
    } else {
      err = step_bwd(cf(s0), y, cf(mask), ls, w, gi, f(g), ws, B, N, S, splits, st);
    }
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
