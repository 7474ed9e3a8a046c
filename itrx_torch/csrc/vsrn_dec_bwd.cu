// VSRN's teacher-forced caption decoder, the backward, for sm_90a.
//
// Replaces itrx/ops/pallas/vsrn_dec.py::_bwd_kernel.  From the forward's
// residuals hall[t] = h_{t-1} and ghall[t] = h_{t-1} Whh^T + bhh and the
// cotangent g_hs of the states (all fp32):
//   recompute, for all T x B rows at once: hq = hall Watt^T, the attention
//     (alpha, the masked ctx; vsrn_dec.cuh) and gx = ctx Wctx^T + gxw;
//   then in reverse over t, carrying only g (B x H), g_ht = g + g_hs[t]:
//     the GRU cell's adjoint -> g_gx = [g_prer | g_prez | g_pren] (= g_gxw[t])
//       and g_gh = [g_prer | g_prez | g_pren r]
//     g_ctx = (g_gx Wctx) * cmask_t
//     per batch row: g_alpha_r = g_ctx . enc_out_r, g_e = alpha (g_alpha -
//       alpha . g_alpha), g_pre = g_e w2 (1 - o^2); g_enc_att += g_pre,
//       g_enc_out += alpha g_ctx, g_hq = sum_r g_pre, dw2 part = sum_r g_e o
//     g = g_ht z + [g_hq | g_gh] [Watt ; Whh]
//   then the weight sums over the T x B rows:
//     [dWatt ; dWhh | . ; dbhh] = [g_hq | g_gh]^T [hall | 1],
//     dWctx = g_gx^T ctx,  dw2 = the sum of the parts.
//
// What bounds it here: fp32 operations, about 2 B H^2 x 18 a step (the
// recomputed hq and gx, g_gx Wctx, [g_hq | g_gh] [Watt ; Whh] and the three
// weight sums), the T steps of the carry in sequence.  Design: the
// recomputation and the weight sums run over all T x B rows at once (the
// 64 x 64 fp32 tile product of gemm_tile.cuh; the weight sums over fixed
// splits of the rows summed in order); per step four launches (cell, g_ctx
// product, attention adjoint with one block a batch row, carry product).
// g_enc_att and g_enc_out are sums over t of which each element is owned by
// one thread; no atomics, so two calls give identical gradients.
#include "gemm_tile.cuh"
#include "vsrn_dec.cuh"

namespace {

using namespace itrx_gemm;
using namespace itrx_vsrn;

// C (M x N) = A (M x K, row stride lda) Bm (K x N, row stride ldb), then
// C *= mul and C += add where those are not null (both M x N).
__global__ void __launch_bounds__(kGemmThreads)
dense_kernel(const float* __restrict__ A, int lda, const float* __restrict__ Bm, int ldb,
             const float* __restrict__ mul, const float* __restrict__ add,
             float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  gemm_tile<false>(
      As, Bs, M, N, 0, K, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int m, int k) { return A[(size_t)m * lda + k]; },
      [&](int k, int n) { return Bm[(size_t)k * ldb + n]; },
      [&](int m, int n, float v) {
        const size_t o = (size_t)m * N + n;
        if (mul != nullptr) v *= mul[o];
        if (add != nullptr) v += add[o];
        C[o] = v;
      });
}

// The GRU cell's adjoint at step t, one thread an element of (B, H).
__global__ void cell_bwd_kernel(const float* __restrict__ carry, const float* __restrict__ ghs,
                                const float* __restrict__ gx, const float* __restrict__ gh,
                                const float* __restrict__ hprev, float* __restrict__ ggx,
                                float* __restrict__ ggh, float* __restrict__ gp, int B, int H) {
  const size_t n_el = (size_t)B * H;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n_el;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t b = idx / H, j = idx % H;
    const size_t row = b * 3 * H;
    const float g_ht = carry[idx] + ghs[idx];
    const float r = sigmoid_f(gx[row + j] + gh[row + j]);
    const float z = sigmoid_f(gx[row + H + j] + gh[row + H + j]);
    const float hn = gh[row + 2 * H + j];
    const float n = tanhf(gx[row + 2 * H + j] + r * hn);
    const float g_n = g_ht * (1.0f - z);
    const float g_z = g_ht * (hprev[idx] - n);
    gp[idx] = g_ht * z;
    const float g_pren = g_n * (1.0f - n * n);
    const float g_r = g_pren * hn;
    const float g_prer = g_r * r * (1.0f - r);
    const float g_prez = g_z * z * (1.0f - z);
    ggx[row + j] = g_prer;
    ggx[row + H + j] = g_prez;
    ggx[row + 2 * H + j] = g_pren;
    ggh[row + j] = g_prer;
    ggh[row + H + j] = g_prez;
    ggh[row + 2 * H + j] = g_pren * r;
  }
}

// The attention's adjoint at step t, one block a batch row b (row i = t B + b
// of the recomputed hq and alpha).  Accumulates g_enc_att and g_enc_out;
// writes g_hq and the dw2 part of the row.
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const float* __restrict__ enca, const float* __restrict__ enco,
                const float* __restrict__ hq, const float* __restrict__ alpha,
                const float* __restrict__ w2, const float* __restrict__ gctx,
                float* __restrict__ genca, float* __restrict__ genco, float* __restrict__ ghq,
                float* __restrict__ dw2p, int t, int B, int R, int H) {
  __shared__ float gc[kMaxH];
  __shared__ float al[kMaxR], ga[kMaxR];
  const size_t b = blockIdx.x;
  const size_t i = (size_t)t * B + b;
  const size_t base = b * R * H;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int j = threadIdx.x; j < H; j += kThreads) gc[j] = gctx[b * H + j];
  for (int r = threadIdx.x; r < R; r += kThreads) al[r] = alpha[i * R + r];
  __syncthreads();
  for (int r = warp; r < R; r += kWarps) {
    float s = 0.0f;
    for (int j = lane; j < H; j += 32) s = fmaf(gc[j], enco[base + (size_t)r * H + j], s);
    s = warp_sum(s);
    if (lane == 0) ga[r] = s;
  }
  __syncthreads();
  if (warp == 0) {
    float d = 0.0f;
    for (int r = lane; r < R; r += 32) d = fmaf(al[r], ga[r], d);
    d = warp_sum(d);
    for (int r = lane; r < R; r += 32) ga[r] = al[r] * (ga[r] - d);  // g_e
  }
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += kThreads) {
    const float q = hq[i * H + j], w = w2[j], c = gc[j];
    float g_hq = 0.0f, dw = 0.0f;
    for (int r = 0; r < R; ++r) {
      const size_t o = base + (size_t)r * H + j;
      const float ov = tanhf(enca[o] + q);
      const float g_pre = ga[r] * w * (1.0f - ov * ov);
      genca[o] += g_pre;
      genco[o] += al[r] * c;
      g_hq += g_pre;
      dw = fmaf(ga[r], ov, dw);
    }
    ghq[i * H + j] = g_hq;
    dw2p[i * H + j] = dw;
  }
}

// The carry: g = gp + [g_hq | g_gh] [Watt ; Whh], wcat (4H, H).
__global__ void __launch_bounds__(kGemmThreads)
carry_kernel(const float* __restrict__ ghq, const float* __restrict__ ggh,
             const float* __restrict__ wcat, const float* __restrict__ gp,
             float* __restrict__ out, int B, int H) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  gemm_tile<false>(
      As, Bs, B, H, 0, 4 * H, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int m, int k) {
        return k < H ? ghq[(size_t)m * H + k] : ggh[(size_t)m * 3 * H + k - H];
      },
      [&](int k, int n) { return wcat[(size_t)k * H + n]; },
      [&](int m, int n, float v) {
        const size_t o = (size_t)m * H + n;
        out[o] = v + gp[o];
      });
}

// Split z of the weight sums over rows [z per, (z + 1) per): which == 0 gives
// [g_hq | g_gh]^T [hall | 1] (4H x (H + 1)), which == 1 g_gx^T ctx (3H x H),
// into part + z M N.
__global__ void __launch_bounds__(kGemmThreads)
wgrad_kernel(int which, const float* __restrict__ ghq, const float* __restrict__ ggh,
             const float* __restrict__ hall, const float* __restrict__ ggx,
             const float* __restrict__ ctx, int n_rows, int H, int per_split,
             float* __restrict__ part) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int z = blockIdx.z;
  const int kb = min(n_rows, z * per_split), ke = min(n_rows, kb + per_split);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int M = which == 0 ? 4 * H : 3 * H, N = which == 0 ? H + 1 : H;
  float* out = part + (size_t)z * M * N;
  const auto st = [&](int m, int n, float v) { out[(size_t)m * N + n] = v; };
  if (which == 0) {
    gemm_tile<true>(
        As, Bs, M, N, kb, ke, m0, n0,
        [&](int m, int k) {
          return m < H ? ghq[(size_t)k * H + m] : ggh[(size_t)k * 3 * H + m - H];
        },
        [&](int k, int n) { return n == H ? 1.0f : hall[(size_t)k * H + n]; }, st);
  } else {
    gemm_tile<true>(
        As, Bs, M, N, kb, ke, m0, n0, [&](int m, int k) { return ggx[(size_t)k * 3 * H + m]; },
        [&](int k, int n) { return ctx[(size_t)k * H + n]; }, st);
  }
}

// The splits summed in order: which == 0 into dWatt (H, H), dWhh (3H, H) and
// dbhh (3H); which == 1 into dWctx (3H, H).
__global__ void wreduce_kernel(int which, const float* __restrict__ part, int splits, int H,
                               float* __restrict__ dwatt, float* __restrict__ dwhh,
                               float* __restrict__ dbhh, float* __restrict__ dwctx) {
  const int M = which == 0 ? 4 * H : 3 * H, N = which == 0 ? H + 1 : H;
  const size_t n_out = (size_t)M * N;
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float sum = 0.0f;
  for (int z = 0; z < splits; ++z) sum += part[(size_t)z * n_out + o];
  if (which == 1) {
    dwctx[o] = sum;
    return;
  }
  const int m = o / N, n = o % N;
  if (m < H) {
    if (n < H) dwatt[(size_t)m * H + n] = sum;  // column H (the bias of hq) has no use
  } else if (n < H) {
    dwhh[(size_t)(m - H) * H + n] = sum;
  } else {
    dbhh[m - H] = sum;
  }
}

// dw2 (H) = the sum of the n_rows parts (n_rows x H), in row order.
__global__ void colsum_kernel(const float* __restrict__ part, int n_rows, int H,
                              float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= H) return;
  float sum = 0.0f;
  for (int i = 0; i < n_rows; ++i) sum += part[(size_t)i * H + j];
  out[j] = sum;
}

dim3 tiles(int M, int N) { return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM); }

}  // namespace

extern "C" {

// The backward of itrx_vsrn_dec_fwd.  In, fp32 and contiguous: gxw (T, B, 3H),
// cmask (T, B, H), enco, enca (B, R, H), hall (T, B, H), ghall (T, B, 3H),
// ghs (T, B, H), wcat (4H, H) = [Watt ; Whh], wcatT = wcat^T, w2 (H), wctx
// (3H, H), wctxT = wctx^T.  Out, fp32: ggxw (T, B, 3H), gh0 (B, H), genco,
// genca (B, R, H), dwatt (H, H), dw2 (H), dwctx (3H, H), dwhh (3H, H), dbhh
// (3H).  Workspaces, fp32: hq, ctx, ghq, dw2p of T x B x H, alpha of
// T x B x R, gx and ggh of T x B x 3H, gp and gctx of B x H, carry of
// 2 x B x H, part0 of splits x 4H x (H + 1), part1 of splits x 3H x H.
// 1 <= R <= 128, 1 <= H <= 1024, splits >= 1.  Launches on `stream` of CUDA
// device `device`; returns the first CUDA error (cudaGetLastError()) or 0.
int itrx_vsrn_dec_bwd(const void* gxw, const void* cmask, const void* enco, const void* enca,
                      const void* hall, const void* ghall, const void* ghs, const void* wcat,
                      const void* wcatT, const void* w2, const void* wctx, const void* wctxT,
                      void* ggxw, void* gh0, void* genco, void* genca, void* dwatt, void* dw2,
                      void* dwctx, void* dwhh, void* dbhh, void* ws_hq, void* ws_alpha,
                      void* ws_ctx, void* ws_gx, void* ws_ggh, void* ws_ghq, void* ws_dw2p,
                      void* ws_gp, void* ws_gctx, void* ws_carry, void* part0, void* part1,
                      int T, int B, int R, int H, int splits, int device, void* stream) {
  if (T < 1 || B < 1 || R < 1 || R > kMaxR || H < 1 || H > kMaxH || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const int rows = T * B;
  const size_t bh = (size_t)B * H, bh3 = 3 * bh, brh = (size_t)B * R * H;
  int err;

  // the recomputation, all rows at once: hq, alpha and ctx, gx
  dense_kernel<<<tiles(rows, H), kGemmThreads, 0, st>>>(cf(hall), H, cf(wcatT), 4 * H, nullptr,
                                                       nullptr, f(ws_hq), rows, H, H);
  attend_kernel<<<(unsigned)rows, kThreads, 0, st>>>(cf(enca), cf(enco), f(ws_hq), cf(w2),
                                                     cf(cmask), f(ws_ctx), f(ws_alpha), B, R,
                                                     H);
  dense_kernel<<<tiles(rows, 3 * H), kGemmThreads, 0, st>>>(f(ws_ctx), H, cf(wctxT), 3 * H,
                                                           nullptr, cf(gxw), f(ws_gx), rows,
                                                           3 * H, H);
  for (void* p : {genco, genca}) {
    err = (int)cudaMemsetAsync(p, 0, sizeof(float) * brh, st);
    if (err != 0) return err;
  }
  err = (int)cudaMemsetAsync(ws_carry, 0, sizeof(float) * bh, st);
  if (err != 0) return err;
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  // the reverse steps, carrying g
  const unsigned cell_blocks = (unsigned)((bh + 255) / 256);
  for (int t = T - 1; t >= 0; --t) {
    const float* carry = f(ws_carry) + ((T - 1 - t) % 2) * bh;
    float* next = f(ws_carry) + ((T - t) % 2) * bh;
    cell_bwd_kernel<<<cell_blocks, 256, 0, st>>>(carry, cf(ghs) + t * bh, f(ws_gx) + t * bh3,
                                                 cf(ghall) + t * bh3, cf(hall) + t * bh,
                                                 f(ggxw) + t * bh3, f(ws_ggh) + t * bh3,
                                                 f(ws_gp), B, H);
    dense_kernel<<<tiles(B, H), kGemmThreads, 0, st>>>(f(ggxw) + t * bh3, 3 * H, cf(wctx), H,
                                                       cf(cmask) + t * bh, nullptr, f(ws_gctx),
                                                       B, H, 3 * H);
    attn_bwd_kernel<<<(unsigned)B, kThreads, 0, st>>>(cf(enca), cf(enco), f(ws_hq), f(ws_alpha),
                                                      cf(w2), f(ws_gctx), f(genca), f(genco),
                                                      f(ws_ghq), f(ws_dw2p), t, B, R, H);
    carry_kernel<<<tiles(B, H), kGemmThreads, 0, st>>>(f(ws_ghq) + t * bh, f(ws_ggh) + t * bh3,
                                                       cf(wcat), f(ws_gp),
                                                       t == 0 ? f(gh0) : next, B, H);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }

  // the weight sums over every row, in fixed splits summed in order
  const int per_split = (rows + splits - 1) / splits;
  wgrad_kernel<<<dim3((H + 1 + kBN - 1) / kBN, (4 * H + kBM - 1) / kBM, splits), kGemmThreads,
                 0, st>>>(0, f(ws_ghq), f(ws_ggh), cf(hall), f(ggxw), f(ws_ctx), rows, H,
                          per_split, f(part0));
  wgrad_kernel<<<dim3((H + kBN - 1) / kBN, (3 * H + kBM - 1) / kBM, splits), kGemmThreads, 0,
                 st>>>(1, f(ws_ghq), f(ws_ggh), cf(hall), f(ggxw), f(ws_ctx), rows, H,
                       per_split, f(part1));
  const size_t n0 = (size_t)4 * H * (H + 1), n1 = (size_t)3 * H * H;
  wreduce_kernel<<<(unsigned)((n0 + 255) / 256), 256, 0, st>>>(0, f(part0), splits, H, f(dwatt),
                                                              f(dwhh), f(dbhh), nullptr);
  wreduce_kernel<<<(unsigned)((n1 + 255) / 256), 256, 0, st>>>(1, f(part1), splits, H, nullptr,
                                                              nullptr, nullptr, f(dwctx));
  colsum_kernel<<<(unsigned)((H + 255) / 256), 256, 0, st>>>(f(ws_dw2p), rows, H, f(dw2));
  return (int)cudaGetLastError();
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
