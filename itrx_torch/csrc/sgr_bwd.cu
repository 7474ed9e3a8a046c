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
// What bounds it here: fp32 operations, per pair and step five S x S products
// (X M again, g_pre Wg, g_sm M^T and the two weight sums, 10 n S^2) and the
// edges (the forward's again, g_a, g_sm and the key-side sums, about
// 12 n^2 S).
// Design: six launches a step over the listed valid rows (sgr_rows.cuh):
//   1. g_ctx = (g where Y > 0) Wg, the tile product with the gate fused in;
//   2. sm = X M, the same product;
//   3. edge_bwd_kernel, one block a pair: one warp a query row forms its
//      edge row and softmax in shared memory (n x n), ctx, g_a, g_e (over
//      the same n x n) and g_sm; then the column sums and, one warp a key
//      row, g_e^T sm + a^T g_ctx + col v into a workspace;
//   4. wgrad_kernel: [dWg | dbg] = g_pre^T [ctx | 1] and [dM | dv] =
//      X^T [g_sm | col] over 16 fixed splits of the rows (gemm_tile.cuh),
//      then wgrad_reduce sums the splits in order;
//   5. g = that workspace + g_sm M^T, the tile product with the sum added.
// No atomics: every sum runs in a fixed order, so two calls give identical
// gradients.
#include "gemm_tile.cuh"
#include "sgr_rows.cuh"

namespace {

using namespace itrx_gemm;
using namespace itrx_sgr;

// Per pair, from X, sm = X M, v and g_ctx: ctx = a X, g_sm = g_e X, the
// column sums col of g_e, and gx = a^T g_ctx + g_e^T sm + col v, at the
// pair's valid rows.  Dynamic shared memory: a and g_e, N x N each.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
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
  const Row8 vr = load_row(v, S);
  for (int b = warp; b < n; b += kWarps) {
    const float e = row_dot(load_row(x + (base + vidx[b]) * S, S), vr);
    if (lane == 0) sv[b] = e;
  }
  __syncthreads();

  for (int a = warp; a < n; a += kWarps) {
    const size_t ra = (base + vidx[a]) * S;
    float* arow = att + a * N;
    float* grow = gev + a * N;
    const Row8 q = load_row(sm + ra, S);
    for (int b = 0; b < n; ++b) {
      const float e = row_dot(q, load_row(x + (base + vidx[b]) * S, S)) + sv[b];
      if (lane == (b & 31)) arow[b] = e;
    }
    __syncwarp();
    float mx = -3.0e38f;
    for (int b = lane; b < n; b += 32) mx = fmaxf(mx, arow[b]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int b = lane; b < n; b += 32) {
      const float p = expf(arow[b] - mx);
      arow[b] = p;
      sum += p;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int b = lane; b < n; b += 32) arow[b] *= inv;
    __syncwarp();
    // the context (for dWg) and g_a
    const Row8 gc = load_row(gctx + ra, S);
    Row8 acc = row_zero();
    for (int b = 0; b < n; ++b) {
      const Row8 kb = load_row(x + (base + vidx[b]) * S, S);
      row_fma(acc, arow[b], kb);
      const float ga = row_dot(gc, kb);
      if (lane == (b & 31)) grow[b] = ga;
    }
    store_row(ctx + ra, acc, S);
    __syncwarp();
    // the softmax's adjoint, over the row
    float d = 0.0f;
    for (int b = lane; b < n; b += 32) d = fmaf(arow[b], grow[b], d);
    d = warp_sum(d);
    for (int b = lane; b < n; b += 32) grow[b] = arow[b] * (grow[b] - d);
    __syncwarp();
    Row8 g2 = row_zero();
    for (int b = 0; b < n; ++b) row_fma(g2, grow[b], load_row(x + (base + vidx[b]) * S, S));
    store_row(gsm + ra, g2, S);
  }
  __syncthreads();

  // the key side: column sums of g_e, then per key row b
  for (int b = threadIdx.x; b < n; b += kThreads) {
    float c = 0.0f;
    for (int a = 0; a < n; ++a) c += gev[a * N + b];
    cs[b] = c;
    col[base + vidx[b]] = c;
  }
  __syncthreads();
  for (int b = warp; b < n; b += kWarps) {
    Row8 acc = row_zero();
    row_fma(acc, cs[b], vr);
    for (int a = 0; a < n; ++a) {
      const size_t ra = (base + vidx[a]) * S;
      row_fma(acc, att[a * N + b], load_row(gctx + ra, S));
      row_fma(acc, gev[a * N + b], load_row(sm + ra, S));
    }
    store_row(gx + (base + vidx[b]) * S, acc, S);
  }
}

// The split z of the rows' weight sums: z < splits for [dWg | dbg] =
// g_pre^T [ctx | 1], else [dM | dv] = X^T [g_sm | col]; each S x (S + 1) into
// part[z].
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
wgrad_kernel(const float* __restrict__ g, const float* __restrict__ y,
             const float* __restrict__ ctx, const T* __restrict__ x,
             const float* __restrict__ gsm, const float* __restrict__ col,
             const int* __restrict__ rows, int n_rows, int S, int splits, int per_split,
             float* __restrict__ part) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int z = blockIdx.z;
  const int zs = z % splits;
  const int kb = min(n_rows, zs * per_split), ke = min(n_rows, kb + per_split);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float* out = part + (size_t)z * S * (S + 1);
  const auto st = [&](int m, int n, float val) { out[(size_t)m * (S + 1) + n] = val; };
  if (z < splits) {
    gemm_tile<true>(
        As, Bs, S, S + 1, kb, ke, m0, n0,
        [&](int m, int k) {
          const size_t o = (size_t)rows[k] * S + m;
          return y[o] > 0.0f ? g[o] : 0.0f;
        },
        [&](int k, int n) { return n == S ? 1.0f : ctx[(size_t)rows[k] * S + n]; }, st);
  } else {
    gemm_tile<true>(
        As, Bs, S, S + 1, kb, ke, m0, n0,
        [&](int m, int k) { return to_f(x[(size_t)rows[k] * S + m]); },
        [&](int k, int n) {
          const size_t r = rows[k];
          return n == S ? col[r] : gsm[r * S + n];
        },
        st);
  }
}

// dWg, dbg, dM, dv of one step: the splits of part summed in order.
__global__ void wgrad_reduce(const float* __restrict__ part, float* __restrict__ dwg,
                             float* __restrict__ dbg, float* __restrict__ dmm,
                             float* __restrict__ dvv, int S, int splits) {
  const size_t n_out = (size_t)S * (S + 1);
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n_out) return;
  const int which = idx / n_out;
  const size_t o = idx % n_out;
  const float* p = part + (size_t)which * splits * n_out + o;
  float sum = 0.0f;
  for (int z = 0; z < splits; ++z) sum += p[(size_t)z * n_out];
  const int m = o / (S + 1), n = o % (S + 1);
  float* w = which == 0 ? dwg : dmm;
  float* b = which == 0 ? dbg : dvv;
  if (n < S) {
    w[(size_t)m * S + n] = sum;
  } else {
    b[m] = sum;
  }
}

struct Step {
  const float* mm;   // (S, S) M
  const float* mmt;  // (S, S) M^T
  const float* vv;   // (S,)
  const float* wg;   // (S, S) Wg, (out, in)
  float *dmm, *dvv, *dwg, *dbg;
};

struct Work {
  float *sm, *ctx, *gctx, *gsm, *gx, *col, *part;
};

template <typename T>
int step_bwd(const T* x, const float* y, const float* mask, const int* rows, int n_rows,
             const Step& w, float* g, const Work& ws, int B, int N, int S, int splits,
             cudaStream_t stream) {
  int err = rows_product<float>(g, y, rows, n_rows, w.wg, nullptr, nullptr, ws.gctx, S, false,
                                stream);
  if (err != 0) return err;
  err = rows_product(x, nullptr, rows, n_rows, w.mm, nullptr, nullptr, ws.sm, S, false, stream);
  if (err != 0) return err;
  const int edge_smem = 2 * N * N * (int)sizeof(float);
  err = (int)cudaFuncSetAttribute(edge_bwd_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  2 * kMaxN * kMaxN * (int)sizeof(float));
  if (err != 0) return err;
  edge_bwd_kernel<T><<<(unsigned)B, kThreads, edge_smem, stream>>>(
      x, mask, ws.sm, w.vv, ws.gctx, ws.ctx, ws.gsm, ws.gx, ws.col, N, S);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int per_split = (n_rows + splits - 1) / splits;
  wgrad_kernel<T><<<dim3((S + 1 + kBN - 1) / kBN, (S + kBM - 1) / kBM, 2 * splits),
                    kGemmThreads, 0, stream>>>(g, y, ws.ctx, x, ws.gsm, ws.col, rows, n_rows,
                                               S, splits, per_split, ws.part);
  const size_t n_out = 2 * (size_t)S * (S + 1);
  wgrad_reduce<<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(ws.part, w.dwg, w.dbg,
                                                                     w.dmm, w.dvv, S, splits);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return rows_product<float>(ws.gsm, nullptr, rows, n_rows, w.mmt, nullptr, ws.gx, g, S, false,
                             stream);
}

}  // namespace

extern "C" {

// The backward of itrx_sgr_fwd.  s0 (B, N, S) fp32 or bf16 (bf16 != 0), as
// given to the forward; outs (steps, B, N, S) its fp32 saves; mask (B, N)
// fp32; rows (n_rows,) int32, the valid rows in order; mm, mmt (M^T), wg
// (sim_graph_w, (out, in)) (steps, S, S) and vv (steps, S) fp32, 16-byte
// aligned; g (B, N, S) fp32: in, the cotangent of the last step (read at
// valid rows); out, the cotangent of s0 at valid rows (masked rows untouched).
// dmm, dwg (steps, S, S) and dvv, dbg (steps, S) fp32 out.  Workspaces, fp32:
// ws_sm, ws_ctx, ws_gctx, ws_gsm, ws_gx of B x N x S, ws_col of B x N, part
// of 2 x splits x S x (S + 1).  1 <= N <= 129, S % 4 == 0, 4 <= S <= 256,
// steps >= 1, splits >= 1.  6 x steps launches on `stream` of CUDA device
// `device`; returns the first CUDA error (cudaGetLastError()) or 0.
int itrx_sgr_bwd(const void* s0, const void* outs, const void* mask, const void* rows,
                 const void* mm, const void* mmt, const void* vv, const void* wg, void* g,
                 void* dmm, void* dvv, void* dwg, void* dbg, void* ws_sm, void* ws_ctx,
                 void* ws_gctx, void* ws_gsm, void* ws_gx, void* ws_col, void* part, int B,
                 int N, int S, int steps, int n_rows, int splits, int bf16, int device,
                 void* stream) {
  if (N < 1 || N > kMaxN || S < 4 || S > kMaxS || S % 4 != 0 || steps < 1 || B < 0 ||
      n_rows < 0 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const size_t plane = (size_t)B * N * S, sq = (size_t)S * S;
  if (B == 0 || n_rows == 0) {
    // no valid row: every weight cotangent is 0
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
  const int* r = static_cast<const int*>(rows);
  const Work ws{f(ws_sm), f(ws_ctx), f(ws_gctx), f(ws_gsm), f(ws_gx), f(ws_col), f(part)};
  for (int i = steps - 1; i >= 0; --i) {
    const Step w{cf(mm) + i * sq, cf(mmt) + i * sq, cf(vv) + (size_t)i * S, cf(wg) + i * sq,
                 f(dmm) + i * sq, f(dvv) + (size_t)i * S, f(dwg) + i * sq,
                 f(dbg) + (size_t)i * S};
    const float* y = cf(outs) + i * plane;
    int err;
    if (i > 0) {
      err = step_bwd<float>(cf(outs) + (i - 1) * plane, y, cf(mask), r, n_rows, w, f(g), ws, B,
                            N, S, splits, st);
    } else if (bf16) {
      err = step_bwd(static_cast<const __nv_bfloat16*>(s0), y, cf(mask), r, n_rows, w, f(g), ws,
                     B, N, S, splits, st);
    } else {
      err = step_bwd(cf(s0), y, cf(mask), r, n_rows, w, f(g), ws, B, N, S, splits, st);
    }
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
