// SGRAF-SGR graph reasoning in training, the forward, for sm_90a.
//
// Replaces itrx/ops/pallas/sgr.py::_fwd_kernel.  For each pair's nodes X
// (n valid of N, the global node first) and each of `steps` reasoning steps,
// with the q/k fold M = Wq^T Wk, v = Wk^T bq of the wrapper (bk drops out):
//   e_ab  = (X_a M) . X_b + X_b . v            over the pair's valid nodes b
//   ctx_a = sum_b softmax_b(e_ab) X_b
//   X_a  <- relu(ctx_a Wg^T + bg)
// Every step's output is written in fp32 to outs (steps, B, N, S), the saves
// of the backward (sgr_bwd.cu); the rows of masked nodes stay as the caller
// set them (zero).  The nodes of step 0 are read as they are (fp32 or bf16);
// every step computes in fp32.
//
// What bounds it here: fp32 operations, the two S x S products X M and
// ctx Wg^T (4 n S^2 a pair and step), then the edges and contexts
// (4 n^2 S), about a tenth of them at n ~ 14, S 256.
// Design: three launches a step.  X M over the listed valid rows through the
// 64-row tile product (sgr_rows.cuh) into a workspace; then one block a pair:
// the key-side terms X_b . v in shared memory, and one warp a query row that
// forms its edge row, the softmax and the context in one pass over the keys
// (a running maximum), reading the keys from device memory (the pair's rows
// stay in L1 / L2), and writes ctx to a second workspace; then ctx Wg^T + bg
// and the ReLU with the tile product into outs.  No atomics: every sum runs
// in a fixed order, so a call gives the same nodes on every run.
#include "sgr_rows.cuh"

namespace {

using namespace itrx_sgr;

// ctx[a] = sum_b softmax_b(sm[a] . x[b] + x[b] . v) x[b] over each pair's
// valid nodes a, b; one block a pair.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_fwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                const float* __restrict__ sm, const float* __restrict__ v,
                float* __restrict__ ctx, int N, int S) {
  __shared__ int vidx[kMaxN];
  __shared__ float sv[kMaxN];
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
    const Row8 q = load_row(sm + ra, S);
    Row8 acc = row_zero();
    float m = -3.0e38f, l = 0.0f;
    for (int b = 0; b < n; ++b) {
      const Row8 kb = load_row(x + (base + vidx[b]) * S, S);
      const float e = row_dot(q, kb) + sv[b];
      if (e > m) {
        const float sc = expf(m - e);
        l *= sc;
        acc.a.x *= sc; acc.a.y *= sc; acc.a.z *= sc; acc.a.w *= sc;
        acc.b.x *= sc; acc.b.y *= sc; acc.b.z *= sc; acc.b.w *= sc;
        m = e;
      }
      const float p = expf(e - m);
      l += p;
      row_fma(acc, p, kb);
    }
    const float inv = 1.0f / l;
    acc.a.x *= inv; acc.a.y *= inv; acc.a.z *= inv; acc.a.w *= inv;
    acc.b.x *= inv; acc.b.y *= inv; acc.b.z *= inv; acc.b.w *= inv;
    store_row(ctx + ra, acc, S);
  }
}

template <typename T>
int step(const T* x, const float* mask, const int* rows, int n_rows, const float* mm,
         const float* vv, const float* wgt, const float* bg, float* out, float* ws_sm,
         float* ws_ctx, int B, int N, int S, cudaStream_t stream) {
  int err = rows_product(x, nullptr, rows, n_rows, mm, nullptr, nullptr, ws_sm, S, false,
                         stream);
  if (err != 0) return err;
  edge_fwd_kernel<T><<<(unsigned)B, kThreads, 0, stream>>>(x, mask, ws_sm, vv, ws_ctx, N, S);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return rows_product<float>(ws_ctx, nullptr, rows, n_rows, wgt, bg, nullptr, out, S, true,
                             stream);
}

}  // namespace

extern "C" {

// s0 (B, N, S) fp32 or bf16 (bf16 != 0), 16-byte aligned (8 for bf16); mask
// (B, N) fp32; rows (n_rows,) int32, the valid rows p * N + j in order; mm
// (steps, S, S) = Wq^T Wk, vv (steps, S) = Wk^T bq, wgt (steps, S, S) =
// Wg^T (in, out), bg (steps, S), all fp32, mm and wgt 16-byte aligned; outs
// (steps, B, N, S) fp32, zero where the mask is 0 (untouched there); ws_sm
// and ws_ctx fp32 workspaces of B x N x S.  1 <= N <= 129, S % 4 == 0,
// 4 <= S <= 256, steps >= 1.  3 x steps launches on `stream` of CUDA device
// `device`; returns the first CUDA error (cudaGetLastError()) or 0.
int itrx_sgr_fwd(const void* s0, const void* mask, const void* rows, const void* mm,
                 const void* vv, const void* wgt, const void* bg, void* outs, void* ws_sm,
                 void* ws_ctx, int B, int N, int S, int steps, int n_rows, int bf16,
                 int device, void* stream) {
  if (N < 1 || N > kMaxN || S < 4 || S > kMaxS || S % 4 != 0 || steps < 1 || B < 0 ||
      n_rows < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (B == 0 || n_rows == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int* r = static_cast<const int*>(rows);
  float* out = static_cast<float*>(outs);
  const size_t plane = (size_t)B * N * S, sq = (size_t)S * S;
  for (int i = 0; i < steps; ++i) {
    float* o = out + i * plane;
    const float* m = f(mm) + i * sq;
    const float* v = f(vv) + (size_t)i * S;
    const float* w = f(wgt) + i * sq;
    const float* b = f(bg) + (size_t)i * S;
    float* sm = static_cast<float*>(ws_sm);
    float* cx = static_cast<float*>(ws_ctx);
    int err;
    if (i > 0) {
      err = step<float>(out + (i - 1) * plane, f(mask), r, n_rows, m, v, w, b, o, sm, cx, B, N,
                        S, st);
    } else if (bf16) {
      err = step(static_cast<const __nv_bfloat16*>(s0), f(mask), r, n_rows, m, v, w, b, o, sm,
                 cx, B, N, S, st);
    } else {
      err = step(f(s0), f(mask), r, n_rows, m, v, w, b, o, sm, cx, B, N, S, st);
    }
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
