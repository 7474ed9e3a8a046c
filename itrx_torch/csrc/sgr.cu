// SGRAF-SGR graph reasoning in training, the forward, for sm_90a.
//
// Replaces itrx/ops/pallas/sgr.py::_fwd_kernel.  For each pair's nodes X
// (n valid of N, the global node first) and each of `steps` reasoning steps,
// with the q/k fold M = Wq^T Wk, v = Wk^T bq of the wrapper (bk drops out):
//   q_a   = X_a M + v
//   e_ab  = q_a . X_b  (= (X_a M) . X_b + X_b . v)    over the pair's valid nodes b
//   ctx_a = sum_b softmax_b(e_ab) X_b
//   X_a  <- relu(ctx_a Wg^T + bg)
// Every step's output is written in fp32 to outs (steps, B, N, S), the saves
// of the backward (sgr_bwd.cu), zero at masked nodes: each step writes every
// row of its save, so the wrapper allocates them without a memset.  The
// nodes of step 0 are read as they are (fp32 or bf16); every step keeps
// fp32 accuracy.
//
// What bounds it: the saves, 4 x steps x B x N x S bytes written (the bytes
// bound at one training chunk), then the two S x S products (4 n S^2 a pair
// and step), then the edges and contexts (4 n^2 S), about a tenth of the
// products at n ~ 14, S 256.  Both products run on the tensor cores as
// split-bf16 products (sgraf_nodes_mma.cuh: x = hi + lo both bf16, three
// passes a_hi b_lo + a_lo b_hi + a_hi b_hi, fp32 accumulation; two passes
// where the operand is step 0's bf16 nodes, which are exact), over the
// valid rows of a row list formed on the card (nothing is read back: every
// grid is sized from B x N and the kernels read the count).
// Design: 3 + 2 x steps launches a call, all into the steps' saves, each of
// which holds q, then ctx, then the output at each valid row:
//   0. plan_kernel and plan_rows_kernel (sgr_rows.cuh): the row list, each
//      pair's first row in it and the edge pass's pair ranges, as
//      ops/kernels/sgr.py::row_list and edge_bounds form them;
//   1. q_kernel, step 0's q = X M + v, a 64-row tile of the list a block
//      (row_tile: mma_tile on the weight split once a call by the wrapper
//      and staged by TMA);
// then a step:
//   2. edge_kernel, a persistent grid (two blocks an SM), block b over the
//      pairs bounds[b] .. (ranges of about equal n (n + 4)) in batches: as
//      many whole pairs' X rows as fit 110 KB staged by cp.async once, then
//      one warp a unit of two query rows of a pair, sharing each key row's
//      reads: e over the keys (sixteen keys' 32 warp sums reduced together
//      by recursive halving), both softmaxes and ctx = a X in one pass; ctx
//      is written over q.  Pairs too large to stage (129 nodes at S 256)
//      take edge_stream_kernel, one block a pair reading its keys from
//      device memory;
//   3. out_kernel: relu(ctx Wg^T + bg) over the same tiles, written over
//      ctx, and exact zeros at the masked rows of the tile (the tail of the
//      list), so every row of the save is written; then, but for the last
//      step, the next step's q = Y M' + v' over the same tile, its operand
//      the rows this block has just written (no other block reads them),
//      into the next save.
// No atomics: every sum runs in a fixed order, so two calls give the same
// saves.  python -m itrx_torch.tools.sgr_fwd_phases times a block of each
// pass.
#include "sgr_rows.cuh"
#include "sgraf_nodes_mma.cuh"

namespace {

using namespace itrx_sgr;
using namespace itrx_sgraf_mma;

// ---------------------------------------------------------------- products
// q = X M + v over the list's tile blockIdx.x, into the step's save (a block
// past the count returns)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
q_kernel(const T* __restrict__ x, const int* __restrict__ rows, const int* __restrict__ count,
         const uint32_t* __restrict__ mtsplit, const float* __restrict__ v,
         float* __restrict__ q, int S, int Ks, int S8) {
  __shared__ int row_at[kMmaRows];
  const int n_rows = *count;
  if ((long long)blockIdx.x * kMmaRows >= n_rows) return;
  init_weight_bars();
  row_tile<sizeof(T) == 4, T, false>(x, nullptr, nullptr, v, nullptr, false, q, rows, n_rows,
                                     row_at, mtsplit, S, Ks, S8);
}

// y = relu(ctx Wg^T + bg) at the valid rows of the list's tile blockIdx.x,
// over ctx in y, and zero at its masked rows (entries from the count on, up
// to the list's end n_all); then, where qn is given, qn = y M' + v' at the
// tile's valid rows (mtn the next step's split M'^T)
__global__ void __launch_bounds__(kThreads, 2)
out_kernel(float* y, const int* __restrict__ rows, const int* __restrict__ count,
           const uint32_t* __restrict__ gsplit, const float* __restrict__ bg,
           const uint32_t* __restrict__ mtn, const float* __restrict__ vn, float* qn, int n_all,
           int S, int Ks, int S8) {
  __shared__ int row_at[kMmaRows];
  const int n_rows = *count;
  const int t0 = blockIdx.x * kMmaRows;
  const int lane = threadIdx.x % 32;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = max(t0, n_rows) + (int)threadIdx.x / 32; i < min(t0 + kMmaRows, n_all);
       i += kWarps) {
    float* o = y + (size_t)rows[i] * S;
    for (int c = 4 * lane; c < S; c += 128) *reinterpret_cast<float4*>(o + c) = z;
  }
  if (t0 >= n_rows) return;
  init_weight_bars();
  row_tile<true, float, false>(y, nullptr, nullptr, bg, nullptr, true, y, rows, n_rows, row_at,
                               gsplit, S, Ks, S8);
  if (qn != nullptr) {
    row_tile<true, float, false>(y, nullptr, nullptr, vn, nullptr, false, qn, rows, n_rows,
                                 row_at, mtn, S, Ks, S8);
  }
}

// ---------------------------------------------------------------- edges
constexpr int kQKeys = 16;  // keys a query unit reduces together: 2 rows x 16 = 32 sums

// the rows a batch stages: per row X (S floats, or S bf16 in half of them),
// its pair's first row and size and the batch's row units; behind them each
// warp's two softmax rows of N
__host__ __device__ inline int batch_rows(int N, int S) {
  return (kEdgeBytes / 4 - kWarps * 2 * N) / (S + 3);
}

// A unit of one or two query rows of a pair (q[1] a second row when `two`),
// by one warp, sharing each key row's reads: the edge rows over the pair's
// n keys X(b), e_b = q . X_b (sixteen keys' 32 sums reduced together), the
// softmax into prow (rows ld apart), then ctx = a X in one pass over the
// keys.  A lone row is formed twice in the same place.
template <typename XR>
__device__ __forceinline__ void attend_rows(const XR& X, const Row8 (&q)[2], int n, float* prow,
                                            int ld, bool two, Row8 (&ctx)[2]) {
  const int lane = threadIdx.x % 32;
  // lane l holds value l: row l / 16, key l % 16 (a lone row's second copy
  // is not written)
  const int row = lane / kQKeys;
  const bool writer = two || row == 0;
  for (int b0 = 0; b0 < n; b0 += kQKeys) {
    float p[2 * kQKeys];
#pragma unroll
    for (int k = 0; k < kQKeys; ++k) {
      const Row8 kb = X(min(b0 + k, n - 1));
      p[k] = row_part(q[0], kb);
      p[kQKeys + k] = row_part(q[1], kb);
    }
    const float v = warp_sums(p);
    const int b = b0 + lane % kQKeys;
    if (writer && b < n) prow[row * ld + b] = v;
  }
  __syncwarp();
  const int l1 = two ? ld : 0;
  if (n <= 32) {
    // a lane a key: both rows' softmax with their warp sums interleaved
    const bool in = lane < n;
    const float e0 = in ? prow[lane] : -3.0e38f, e1 = in ? prow[l1 + lane] : -3.0e38f;
    float m0 = e0, m1 = e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    const float p0 = in ? expf(e0 - m0) : 0.0f, p1 = in ? expf(e1 - m1) : 0.0f;
    float s0 = p0, s1 = p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (in) {
      prow[lane] = p0 * (1.0f / s0);
      if (two) prow[ld + lane] = p1 * (1.0f / s1);
    }
  }
  for (int r = 0; n > 32 && r < (two ? 2 : 1); ++r) {
    float* pr = prow + r * ld;
    float mx = -3.0e38f;
    for (int b = lane; b < n; b += 32) mx = fmaxf(mx, pr[b]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int b = lane; b < n; b += 32) {
      const float p = expf(pr[b] - mx);
      pr[b] = p;
      sum += p;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int b = lane; b < n; b += 32) pr[b] *= inv;
  }
  __syncwarp();
  ctx[0] = row_zero();
  ctx[1] = row_zero();
#pragma unroll 2
  for (int b = 0; b < n; ++b) {
    const Row8 kb = X(b);
    row_fma(ctx[0], prow[b], kb);
    row_fma(ctx[1], prow[l1 + b], kb);
  }
  __syncwarp();  // prow is the next unit's
}

// The edges of whole pairs in batches of staged X rows (sgr_rows.cuh's
// next_batch; the plan balances the ranges' n (n + 4)), then one warp a
// unit of two query rows of a pair: q read at its rows in qc, ctx written
// there.  Every pair's N rows fit a batch.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
edge_kernel(const T* __restrict__ x, const int* __restrict__ rows,
            const int* __restrict__ pstart, const int* __restrict__ bounds, float* qc, int N,
            int S) {
  extern __shared__ __align__(16) float esmem[];
  __shared__ int n_units;
  const int cap = batch_rows(N, S);
  T* const xs = reinterpret_cast<T*>(esmem);  // [cap][S] X, as given
  float* const prow = esmem + cap * S;        // [kWarps][2][N] softmax rows
  // [cap] each row's pair's first row, and its rows; each unit's first row
  int* const kst = reinterpret_cast<int*>(prow + kWarps * 2 * N);
  int* const kn = kst + cap;
  int* const units = kn + cap;
  const int tid = threadIdx.x, warp = tid / 32;
  float* const pw = prow + warp * 2 * N;
  const int p0 = bounds[blockIdx.x], p1 = bounds[blockIdx.x + 1];
  for (int q0 = p0; q0 < p1;) {
    const Batch bt = next_batch(q0, p1, pstart, cap, kst, kn);
    const int r0 = bt.r0, R = bt.R;
    const int vecs = S / 4;
    for (int idx = tid; idx < R * vecs; idx += kThreads) {
      const int r = idx / vecs, c = 4 * (idx % vecs);
      cp_async_4(xs + r * S + c, x + (size_t)rows[r0 + r] * S + c, true);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (warp == 0) pair_units(kst, R, units, &n_units);
    __syncthreads();
    const int nu = n_units;
    for (int u = warp; u < nu; u += kWarps) {
      const int a = units[u], k0 = kst[a], n = kn[a];
      const bool two = a + 1 < k0 + n;
      const size_t o0 = (size_t)rows[r0 + a] * S, o1 = (size_t)rows[r0 + (two ? a + 1 : a)] * S;
      const Row8 q[2] = {load_row(qc + o0, S), load_row(qc + o1, S)};
      Row8 c[2];
      attend_rows(PairRows<T, true>{xs + k0 * S, nullptr, S}, q, n, pw, N, two, c);
      store_row(qc + o0, c[0], S);
      if (two) store_row(qc + o1, c[1], S);
    }
    __syncthreads();  // the next batch restages the rows
    q0 = bt.q1;
  }
}

// The edges of one pair a block, its keys read from device memory (pairs
// whose N rows do not fit a batch), in units of two query rows as
// edge_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_stream_kernel(const T* __restrict__ x, const int* __restrict__ rows,
                   const int* __restrict__ pstart, float* qc, int S) {
  __shared__ float prow[kWarps][2][kMaxN];
  const int warp = threadIdx.x / 32;
  const int k0 = pstart[blockIdx.x], n = pstart[blockIdx.x + 1] - k0;
  const PairRows<T, false> X{x, rows + k0, S};
  for (int a = 2 * warp; a < n; a += 2 * kWarps) {
    const bool two = a + 1 < n;
    const size_t o0 = (size_t)rows[k0 + a] * S, o1 = (size_t)rows[k0 + (two ? a + 1 : a)] * S;
    const Row8 q[2] = {load_row(qc + o0, S), load_row(qc + o1, S)};
    Row8 c[2];
    attend_rows(X, q, n, &prow[warp][0][0], kMaxN, two, c);
    store_row(qc + o0, c[0], S);
    if (two) store_row(qc + o1, c[1], S);
  }
}

// the valid rows: the list, each pair's first row in it, and their count;
// the edge pass's pair ranges
struct List {
  const int* rows;    // (B N,) the valid rows p N + j in order first
  const int* pstart;  // (B + 1,)
  const int* count;   // pstart + B
  const int* bounds;  // (edge_blocks + 1,) block b's pairs bounds[b] ..
  int edge_blocks;
};

// one step: x its input, y its save; q_kernel first for step 0, and the
// next step's q from out_kernel where yn (its save), mtn, vn are given
template <typename T>
int step_fwd(const T* x, const List& ls, const uint32_t* mt, const float* v, const uint32_t* gw,
             const float* bg, float* y, const uint32_t* mtn, const float* vn, float* yn,
             bool first, int B, int N, int S, cudaStream_t stream) {
  const int Ks = (S + kSlab - 1) / kSlab * kSlab, S8 = (S + 7) / 8 * 8;
  const int n_all = B * N;
  const unsigned tiles = (unsigned)((n_all + kMmaRows - 1) / kMmaRows);
  int err;
  if (first) {
    q_kernel<T><<<tiles, kThreads, kRowsBytes, stream>>>(x, ls.rows, ls.count, mt, v, y, S, Ks,
                                                         S8);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  if (batch_rows(N, S) >= N) {
    edge_kernel<T><<<(unsigned)ls.edge_blocks, kThreads, kEdgeBytes, stream>>>(
        x, ls.rows, ls.pstart, ls.bounds, y, N, S);
  } else {
    edge_stream_kernel<T><<<(unsigned)B, kThreads, 0, stream>>>(x, ls.rows, ls.pstart, y, S);
  }
  if ((err = (int)cudaGetLastError()) != 0) return err;
  out_kernel<<<tiles, kThreads, kRowsBytes, stream>>>(y, ls.rows, ls.count, gw, bg, mtn, vn, yn,
                                                      n_all, S, Ks, S8);
  return (int)cudaGetLastError();
}

template <typename T>
int set_smem() {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(q_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kRowsBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(edge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kEdgeBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kRowsBytes)) != cudaSuccess) {
    return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// s0 (B, N, S) fp32 or bf16 (bf16 != 0), 16-byte aligned; mask (B, N) fp32;
// plan an int32 workspace of 3 B + B N + edge_blocks + 4 entries, 8-byte
// aligned, where the plan kernels form the row list, each pair's first row in
// it and the edge pass's edge_blocks pair ranges (the host never reads
// them); per step, split for the tensor cores (ops/kernels/sgraf_eval.py::
// split_weight: S8 rows of Ks words, Ks = S rounded up to 32): mtsplit M^T
// (M = Wq^T Wk) and gsplit sim_graph_w as it is stored, (out, in); vv
// (steps, S) = Wk^T bq and bg (steps, S), fp32.  outs (steps, B, N, S) fp32
// out, every row written (zero where the mask is 0).  1 <= N <= 129, S % 4
// == 0, 4 <= S <= 256, steps >= 1, 1 <= edge_blocks <= B.  3 + 2 x steps
// launches on `stream` of CUDA device `device`, none of which the host waits
// for; returns the first CUDA error (cudaGetLastError()) or 0.
int itrx_sgr_fwd(const void* s0, const void* mask, void* plan, const void* mtsplit,
                 const void* vv, const void* gsplit, const void* bg, void* outs, int B, int N,
                 int S, int steps, int edge_blocks, int bf16, int device, void* stream) {
  if (N < 1 || N > kMaxN || S < 4 || S > kMaxS || S % 4 != 0 || steps < 1 || B < 0 ||
      (size_t)B * N > 0x7fffffffULL || (B > 0 && (edge_blocks < 1 || edge_blocks > B))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (B == 0) return (int)cudaSuccess;
  int err = bf16 ? set_smem<__nv_bfloat16>() : set_smem<float>();
  if (err != 0) return err;
  if (bf16 && (err = set_smem<float>()) != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  if ((err = launch_plan(cf(mask), B, N, edge_blocks, plan, st)) != 0) return err;
  const Plan pl = plan_of(plan, B, N);
  const List ls{pl.rows, pl.pstart, pl.pstart + B, pl.bounds, edge_blocks};
  const int Ks = (S + kSlab - 1) / kSlab * kSlab, S8 = (S + 7) / 8 * 8;
  const size_t wstep = (size_t)S8 * Ks;  // words of one step's split weight
  float* out = static_cast<float*>(outs);
  const size_t plane = (size_t)B * N * S;
  for (int i = 0; i < steps; ++i) {
    const uint32_t* mt = u(mtsplit) + i * wstep;
    const uint32_t* gw = u(gsplit) + i * wstep;
    const float* v = cf(vv) + (size_t)i * S;
    const float* b = cf(bg) + (size_t)i * S;
    float* y = out + i * plane;
    const bool last = i + 1 == steps;
    const uint32_t* mtn = last ? nullptr : mt + wstep;
    const float* vn = last ? nullptr : v + S;
    float* yn = last ? nullptr : y + plane;
    if (i > 0) {
      err = step_fwd<float>(out + (i - 1) * plane, ls, mt, v, gw, b, y, mtn, vn, yn, false, B, N,
                            S, st);
    } else if (bf16) {
      err = step_fwd(static_cast<const __nv_bfloat16*>(s0), ls, mt, v, gw, b, y, mtn, vn, yn,
                     true, B, N, S, st);
    } else {
      err = step_fwd(cf(s0), ls, mt, v, gw, b, y, mtn, vn, yn, true, B, N, S, st);
    }
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// the plan alone, as itrx_sgr_fwd launches it first (the list and the pair
// ranges into plan; the backward's when it has not the forward's)
int itrx_sgr_plan(const void* mask, void* plan, int B, int N, int edge_blocks, int device,
                  void* stream) {
  if (N < 1 || B < 1 || (size_t)B * N > 0x7fffffffULL || edge_blocks < 1 || edge_blocks > B) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return launch_plan(static_cast<const float*>(mask), B, N, edge_blocks, plan,
                     static_cast<cudaStream_t>(stream));
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
