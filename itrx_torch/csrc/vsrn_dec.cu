// VSRN's teacher-forced caption decoder, the forward, for sm_90a.
//
// Replaces itrx/ops/pallas/vsrn_dec.py::_fwd_kernel.  From h_0 (the region
// encoder's final state), for t = 0 .. T-1:
//   hq   = h Watt^T                         (B x H, the decoder-state half of
//                                            the attention's linear1)
//   ctx  = attention(enc_att + hq, enc_out) * cmask_t      (vsrn_dec.cuh)
//   gx   = ctx Wctx^T + gxw_t,  gh = h Whh^T + bhh
//   r = sig(gx_r + gh_r), z = sig(gx_z + gh_z), n = tanh(gx_n + r gh_n)
//   h    = (1 - z) n + z h                  -> hs[t]
// with the residuals hall[t] = h_{t-1} and ghall[t] = gh for the backward.
//
// What bounds it here: fp32 operations, 2 B H^2 x 7 a step (the products
// h [Watt | Whh]^T and ctx Wctx^T), in T steps that follow each other.  The
// TPU kernel kept enc_att, enc_out (9.4 MB each at B 128, R 36, H 512) and the
// 7 MB of weights in VMEM for all steps; one SM holds 227 KB, so here each
// step is three launches and the weights and encoder rows stay in the 50 MB
// L2 between them:
//   1. hproj_kernel: [hq | gh] = h [Watt | Whh]^T (+ bhh), the 64 x 64 fp32
//      tile product of gemm_tile.cuh over B x 4H;
//   2. attend_kernel: one block a batch row, its R x H encoder rows;
//   3. gates_kernel: gx = ctx Wctx^T + gxw_t for the r, z and n columns of a
//      64 x 64 tile of (B, H), then the GRU cell on the tile.
// Every sum runs in a fixed order (no atomics).
#include "gemm_tile.cuh"
#include "vsrn_dec.cuh"

namespace {

using namespace itrx_gemm;
using namespace itrx_vsrn;

// [hq | gh] = h [Watt | Whh]^T: wcatT (H, 4H) = [Watt^T | Whh^T]; gh gets bhh.
__global__ void __launch_bounds__(kGemmThreads)
hproj_kernel(const float* __restrict__ h, const float* __restrict__ wcatT,
             const float* __restrict__ bhh, float* __restrict__ hq, float* __restrict__ gh,
             int B, int H) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int H4 = 4 * H;
  gemm_tile<false>(
      As, Bs, B, H4, 0, H, blockIdx.y * kBM, blockIdx.x * kBN,
      [&](int m, int k) { return h[(size_t)m * H + k]; },
      [&](int k, int n) { return wcatT[(size_t)k * H4 + n]; },
      [&](int m, int n, float v) {
        if (n < H) {
          hq[(size_t)m * H + n] = v;
        } else {
          gh[(size_t)m * 3 * H + n - H] = v + bhh[n - H];
        }
      });
}

// The input gates of a 64 x 64 tile of (B, H) and the GRU cell on it.
// wctxT (H, 3H) = Wctx^T; gxw, gh (B, 3H) of this step.
__global__ void __launch_bounds__(kGemmThreads)
gates_kernel(const float* __restrict__ ctx, const float* __restrict__ wctxT,
             const float* __restrict__ gxw, const float* __restrict__ gh,
             const float* __restrict__ hprev, float* __restrict__ hout,
             float* __restrict__ hall, int B, int H) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  __shared__ float sx[2][kBM][kBN];  // gx_r, gx_z of the tile
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int H3 = 3 * H;
  const auto la = [&](int m, int k) { return ctx[(size_t)m * H + k]; };
  for (int q = 0; q < 2; ++q) {
    gemm_tile<false>(
        As, Bs, B, H, 0, H, m0, n0, la,
        [&](int k, int n) { return wctxT[(size_t)k * H3 + q * H + n]; },
        [&](int m, int n, float v) {
          sx[q][m - m0][n - n0] = v + gxw[(size_t)m * H3 + q * H + n];
        });
  }
  // each thread reads back only the sx entries it stored (gemm_tile's fixed
  // thread-to-output map), so no barrier is needed before the cell
  gemm_tile<false>(
      As, Bs, B, H, 0, H, m0, n0, la,
      [&](int k, int n) { return wctxT[(size_t)k * H3 + 2 * H + n]; },
      [&](int m, int n, float v) {
        const float* g = gh + (size_t)m * H3;
        const float xn = v + gxw[(size_t)m * H3 + 2 * H + n];
        const float r = sigmoid_f(sx[0][m - m0][n - n0] + g[n]);
        const float z = sigmoid_f(sx[1][m - m0][n - n0] + g[H + n]);
        const float nn = tanhf(xn + r * g[2 * H + n]);
        const size_t o = (size_t)m * H + n;
        const float hp = hprev[o];
        hout[o] = (1.0f - z) * nn + z * hp;
        if (hall != nullptr) hall[o] = hp;
      });
}

}  // namespace

extern "C" {

// gxw (T, B, 3H), cmask (T, B, H), enco, enca (B, R, H), h0 (B, H), wcatT
// (H, 4H) = [Watt^T | Whh^T], w2 (H), wctxT (H, 3H), bhh (3H): fp32,
// contiguous.  Out: hs (T, B, H); hall (T, B, H) and ghall (T, B, 3H) when
// not null (the residuals).  Workspaces, fp32: ws_hq and ws_ctx of B x H,
// ws_gh of B x 3H (used when ghall is null).  1 <= R <= 128, H >= 1.
// 3 T launches on `stream` of CUDA device `device`; returns the first CUDA
// error (cudaGetLastError()) or 0.
int itrx_vsrn_dec_fwd(const void* gxw, const void* cmask, const void* enco, const void* enca,
                      const void* h0, const void* wcatT, const void* w2, const void* wctxT,
                      const void* bhh, void* hs, void* hall, void* ghall, void* ws_hq,
                      void* ws_gh, void* ws_ctx, int T, int B, int R, int H, int device,
                      void* stream) {
  if (T < 1 || B < 1 || R < 1 || R > kMaxR || H < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const size_t bh = (size_t)B * H, bh3 = 3 * bh;
  const dim3 grid_h4((4 * H + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  const dim3 grid_h((H + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? cf(h0) : f(hs) + (t - 1) * bh;
    float* gh = ghall != nullptr ? f(ghall) + t * bh3 : f(ws_gh);
    hproj_kernel<<<grid_h4, kGemmThreads, 0, st>>>(hprev, cf(wcatT), cf(bhh), f(ws_hq), gh, B,
                                                   H);
    attend_kernel<<<(unsigned)B, kThreads, 0, st>>>(cf(enca), cf(enco), f(ws_hq), cf(w2),
                                                    cf(cmask) + t * bh, f(ws_ctx), nullptr, B,
                                                    R, H);
    gates_kernel<<<grid_h, kGemmThreads, 0, st>>>(
        f(ws_ctx), cf(wctxT), cf(gxw) + t * bh3, gh, hprev, f(hs) + t * bh,
        hall != nullptr ? f(hall) + t * bh : nullptr, B, H);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
