// Masked GRU recurrence, forward, for sm_90a.
//
// Replaces itrx/ops/pallas/gru.py::_fwd_kernel (the TPU kernel keeps the
// whole (H, 3H) recurrent weight resident in VMEM and runs one timestep per
// grid step).  Semantics: torch.nn.GRU gate order [r|z|n]; the mask freezes
// the carry past each sequence's length; outputs are zero at padded steps;
// `reverse` runs right to left (packed-bidirectional semantics).
//
// What bounds it here: each step is a (B, H) x (H, 3H) product plus gate
// math, and the steps are sequential.  At H = 1024 the weight is 12 MB in
// fp32 (6 MB in bf16), far beyond one SM's 227 KB of shared memory, so the
// TPU design cannot be copied.  Design: one launch per timestep (the host
// loops over L in `itrx_gru_fwd`); each block owns 32 hidden units j and 32
// batch rows and reads rows j, H+j and 2H+j of W_hh, so the three gates of a
// unit are computed in the same block and the gate math stays local.  The
// weight is re-read every step but stays in the 50 MB L2 across launches.
// The product is a shared-memory tiled FMA loop with fp32 accumulation.
//
// Weight types: fp32 (exact mode) and bf16 (production mode; the carry is
// rounded to bf16 before the product, as the TPU kernel's bf16 dot does).
// The carry itself is always fp32.
//
// Residuals for the backward (csrc/gru_bwd.cu), written only when the
// caller passes the buffers (training): hall[b, t] = h_{t-1}, the fp32
// carry entering step t, and ghall[b, t] = h_{t-1} . W_hh^T + b_hh, as the
// TPU kernel saves them.  Without them the arithmetic and the writes are
// those of the inference path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kUnits = 32;    // hidden units per block (one per lane)
constexpr int kRows = 32;     // batch rows per block
constexpr int kK = 32;        // reduction chunk over the carry
constexpr int kThreads = 256; // 8 warps; warp w owns batch rows 4w .. 4w+3
constexpr int kRowsPerThread = kRows / (kThreads / kUnits);

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename W>
__global__ void __launch_bounds__(kThreads)
gru_step_kernel(const float* __restrict__ gx,      // (B, L, 3H) input gates
                const float* __restrict__ mask,    // (B, L)
                const W* __restrict__ whh,         // (3H, H)
                const float* __restrict__ bhh,     // (3H)
                const float* __restrict__ h_prev,  // (B, H); nullptr = zero carry
                float* __restrict__ h_next,        // (B, H)
                float* __restrict__ out,           // (B, L, H)
                float* __restrict__ hall,          // (B, L, H) or nullptr
                float* __restrict__ ghall,         // (B, L, 3H) or nullptr
                int B, int L, int H, int t) {
  __shared__ float hs[kRows][kK + 1];
  __shared__ float ws[3 * kUnits][kK + 1];

  const int tid = threadIdx.x;
  const int lane = tid % kUnits;
  const int wy = tid / kUnits;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;

  float acc[kRowsPerThread][3];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.0f;

  if (h_prev != nullptr) {
    for (int k0 = 0; k0 < H; k0 += kK) {
      for (int idx = tid; idx < kRows * kK; idx += kThreads) {
        const int r = idx / kK, k = idx % kK;
        const int b = b0 + r, kk = k0 + k;
        float v = (b < B && kk < H) ? h_prev[(size_t)b * H + kk] : 0.0f;
        if constexpr (std::is_same<W, __nv_bfloat16>::value) {
          v = __bfloat162float(__float2bfloat16(v));
        }
        hs[r][k] = v;
      }
      for (int idx = tid; idx < 3 * kUnits * kK; idx += kThreads) {
        const int r = idx / kK, k = idx % kK;
        const int g = r / kUnits, j = j0 + r % kUnits, kk = k0 + k;
        ws[r][k] = (j < H && kk < H) ? to_float(whh[(size_t)(g * H + j) * H + kk]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kK; ++k) {
        const float w_r = ws[lane][k];
        const float w_z = ws[kUnits + lane][k];
        const float w_n = ws[2 * kUnits + lane][k];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float hv = hs[wy * kRowsPerThread + i][k];
          acc[i][0] = fmaf(hv, w_r, acc[i][0]);
          acc[i][1] = fmaf(hv, w_z, acc[i][1]);
          acc[i][2] = fmaf(hv, w_n, acc[i][2]);
        }
      }
      __syncthreads();
    }
  }

  const int j = j0 + lane;
  if (j >= H) return;
  const float bh_r = bhh[j], bh_z = bhh[H + j], bh_n = bhh[2 * H + j];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int b = b0 + wy * kRowsPerThread + i;
    if (b >= B) continue;
    const float* g = gx + ((size_t)b * L + t) * 3 * H;
    const float m = mask[(size_t)b * L + t];
    const float hp = h_prev != nullptr ? h_prev[(size_t)b * H + j] : 0.0f;
    const float gh_r = acc[i][0] + bh_r, gh_z = acc[i][1] + bh_z, gh_n = acc[i][2] + bh_n;
    if (hall != nullptr) {
      const size_t bt = (size_t)b * L + t;
      hall[bt * H + j] = hp;
      ghall[bt * 3 * H + j] = gh_r;
      ghall[bt * 3 * H + H + j] = gh_z;
      ghall[bt * 3 * H + 2 * H + j] = gh_n;
    }
    const float r = sigmoid(g[j] + gh_r);
    const float z = sigmoid(g[H + j] + gh_z);
    const float n = tanhf(g[2 * H + j] + r * gh_n);
    const float h_new = (1.0f - z) * n + z * hp;
    h_next[(size_t)b * H + j] = m * h_new + (1.0f - m) * hp;
    out[((size_t)b * L + t) * H + j] = m * h_new;
  }
}

template <typename W>
int run(const float* gx, const float* mask, const W* whh, const float* bhh,
        float* hbuf, float* out, float* hall, float* ghall, int B, int L, int H,
        int reverse, cudaStream_t stream) {
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  float* h0 = hbuf;
  float* h1 = hbuf + (size_t)B * H;
  for (int step = 0; step < L; ++step) {
    const int t = reverse ? L - 1 - step : step;
    // step s reads buffer (s-1)&1 and writes buffer s&1
    const float* hp = step == 0 ? nullptr : ((step & 1) ? h0 : h1);
    float* hn = (step & 1) ? h1 : h0;
    gru_step_kernel<W><<<grid, kThreads, 0, stream>>>(gx, mask, whh, bhh, hp, hn,
                                                      out, hall, ghall, B, L, H, t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gx (B, L, 3H) fp32; mask (B, L) fp32; whh (3H, H) fp32 or bf16
// (whh_bf16 != 0); bhh (3H) fp32; hbuf (2, B, H) fp32 scratch whose buffer
// (L-1)&1 holds the final carry; out (B, L, H) fp32; hall (B, L, H) and
// ghall (B, L, 3H) fp32, both nullptr or both set (residuals for the
// backward).  L launches on `stream` of CUDA device `device`.  Returns
// cudaGetLastError().
int itrx_gru_fwd(const void* gx, const void* mask, const void* whh, int whh_bf16,
                 const void* bhh, void* hbuf, void* out, void* hall, void* ghall,
                 int B, int L, int H, int reverse, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (whh_bf16) {
    return run<__nv_bfloat16>(static_cast<const float*>(gx), static_cast<const float*>(mask),
                              static_cast<const __nv_bfloat16*>(whh),
                              static_cast<const float*>(bhh), static_cast<float*>(hbuf),
                              static_cast<float*>(out), static_cast<float*>(hall),
                              static_cast<float*>(ghall), B, L, H, reverse, s);
  }
  return run<float>(static_cast<const float*>(gx), static_cast<const float*>(mask),
                    static_cast<const float*>(whh), static_cast<const float*>(bhh),
                    static_cast<float*>(hbuf), static_cast<float*>(out),
                    static_cast<float*>(hall), static_cast<float*>(ghall), B, L, H, reverse, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
