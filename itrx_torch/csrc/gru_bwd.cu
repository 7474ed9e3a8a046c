// Masked GRU adjoint (backward of csrc/gru.cu), for sm_90a.
//
// Replaces itrx/ops/pallas/gru.py::_bwd_kernel.  The TPU kernel walks the
// sequence in the opposite order of the forward, one timestep per grid
// step, with the whole (3H, H) recurrent weight resident in VMEM and the
// carry gradient in a VMEM scratch.  Per step t it recomputes the gates
// from the saved h_{t-1} (hall) and gh = h_{t-1} . W_hh^T + b_hh (ghall),
// emits the gate gradients ggx[t] = [g_prer | g_prez | g_pren] and
// ghn[t] = g_pren * r, and carries
//     g_prev = (1 - m) g_carry + g_hnew z + [g_prer | g_prez | ghn] . W_hh.
// dW_hh, db_hh and the input-side gradients are large matmuls outside the
// kernel (itrx_torch/ops/kernels/gru.py).
//
// What bounds it here: as in the forward, the steps are sequential and each
// carries a (B, 3H) x (3H, H) product whose weight (12 MB fp32 at H = 1024)
// cannot sit in one SM's 227 KB of shared memory.  The product needs the
// gate gradients of all 3H columns, i.e. of every block, so a step cannot
// finish inside one block.  Design: one launch per step, split so that no
// gate value has to cross blocks within a launch.  Each block owns 32
// hidden units k and 32 batch rows.  Launch s
//   1. reduces g_gh[t_{s-1}][b, :] . W_hh[:, k] over 3H (the gate gradients
//      the previous launch wrote, read back from ggx / ghn; column reads of
//      the row-major W_hh, coalesced across k; the weight stays in the
//      50 MB L2 across launches), adds its local terms (gloc) and so holds
//      the carry gradient g_carry[b, k] of step t_s;
//   2. computes the gate gradients of step t_s for its own units k, which
//      need only g_carry[b, k], hall[b, t_s, k], gh[b, t_s, {k, H+k, 2H+k}],
//      gx[b, t_s, ...] and m[b, t_s], all local, and writes them and its new
//      local terms gloc[b, k].
// Launch 0 starts from g_final (or zero) and skips the product; launch L
// only reduces and writes the carry gradient of the initial state (g_h0).
// L + 1 launches in all.  The product is a shared-memory tiled FMA loop
// with fp32 accumulation; everything is fp32 (bf16 W_hh is rejected by the
// wrapper: bf16 training is not ported yet).

#include <cuda_runtime.h>

namespace {

constexpr int kUnits = 32;    // hidden units per block (one per lane)
constexpr int kRows = 32;     // batch rows per block
constexpr int kK = 32;        // reduction chunk over the 3H gate columns
constexpr int kThreads = 256; // 8 warps; warp w owns batch rows 4w .. 4w+3
constexpr int kRowsPerThread = kRows / (kThreads / kUnits);

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// t_prev: the step whose gate gradients feed the product (-1: none, the
// carry gradient starts from g_final).  t: the step whose gate gradients
// this launch emits (-1: none, write the initial-state gradient g_h0).
__global__ void __launch_bounds__(kThreads)
gru_bwd_step_kernel(const float* __restrict__ gx,      // (B, L, 3H) input gates
                    const float* __restrict__ mask,    // (B, L)
                    const float* __restrict__ hall,    // (B, L, H) h_{t-1}
                    const float* __restrict__ ghall,   // (B, L, 3H) gh
                    const float* __restrict__ gout,    // (B, L, H) or nullptr (zero)
                    const float* __restrict__ gfinal,  // (B, H) or nullptr (zero)
                    const float* __restrict__ whh,     // (3H, H)
                    float* __restrict__ ggx,           // (B, L, 3H)
                    float* __restrict__ ghn,           // (B, L, H)
                    float* __restrict__ gloc,          // (B, H) local carry terms
                    float* __restrict__ gh0,           // (B, H) initial-state gradient
                    int B, int L, int H, int t_prev, int t) {
  __shared__ float gs[kRows][kK + 1];
  __shared__ float ws[kK][kUnits + 1];

  const int tid = threadIdx.x;
  const int lane = tid % kUnits;
  const int wy = tid / kUnits;
  const int k0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const int H3 = 3 * H;

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;

  if (t_prev >= 0) {
    for (int j0 = 0; j0 < H3; j0 += kK) {
      for (int idx = tid; idx < kRows * kK; idx += kThreads) {
        const int r = idx / kK, c = idx % kK;
        const int b = b0 + r, j = j0 + c;
        float v = 0.0f;
        if (b < B && j < H3) {
          const size_t bt = (size_t)b * L + t_prev;
          v = j < 2 * H ? ggx[bt * H3 + j] : ghn[bt * H + (j - 2 * H)];
        }
        gs[r][c] = v;
      }
      for (int idx = tid; idx < kK * kUnits; idx += kThreads) {
        const int r = idx / kUnits, c = idx % kUnits;
        const int j = j0 + r, k = k0 + c;
        ws[r][c] = (j < H3 && k < H) ? whh[(size_t)j * H + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kK; ++c) {
        const float w = ws[c][lane];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          acc[i] = fmaf(gs[wy * kRowsPerThread + i][c], w, acc[i]);
        }
      }
      __syncthreads();
    }
  }

  const int k = k0 + lane;
  if (k >= H) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int b = b0 + wy * kRowsPerThread + i;
    if (b >= B) continue;
    const size_t bk = (size_t)b * H + k;
    float g_carry;
    if (t_prev >= 0) {
      g_carry = gloc[bk] + acc[i];
    } else {
      g_carry = gfinal != nullptr ? gfinal[bk] : 0.0f;
    }
    if (t < 0) {
      gh0[bk] = g_carry;
      continue;
    }
    const size_t bt = (size_t)b * L + t;
    const float* g = gx + bt * H3;
    const float* gh = ghall + bt * H3;
    const float hr = gh[k], hz = gh[H + k], hn = gh[2 * H + k];
    const float r = sigmoid(g[k] + hr);
    const float z = sigmoid(g[H + k] + hz);
    const float n = tanhf(g[2 * H + k] + r * hn);
    const float h = hall[bt * H + k];
    const float m = mask[bt];
    const float go = gout != nullptr ? gout[bt * H + k] : 0.0f;

    const float g_hnew = m * (g_carry + go);
    const float g_n = g_hnew * (1.0f - z);
    const float g_z = g_hnew * (h - n);
    const float g_pren = g_n * (1.0f - n * n);
    const float g_hn = g_pren * r;
    const float g_prer = g_pren * hn * r * (1.0f - r);
    const float g_prez = g_z * z * (1.0f - z);
    ggx[bt * H3 + k] = g_prer;
    ggx[bt * H3 + H + k] = g_prez;
    ggx[bt * H3 + 2 * H + k] = g_pren;
    ghn[bt * H + k] = g_hn;
    gloc[bk] = (1.0f - m) * g_carry + g_hnew * z;
  }
}

}  // namespace

extern "C" {

// gx, ghall (B, L, 3H); mask (B, L); hall (B, L, H); gout (B, L, H) or
// nullptr; gfinal (B, H) or nullptr; whh (3H, H); all fp32.  Writes ggx
// (B, L, 3H), ghn (B, L, H) and gh0 (B, H); gloc (B, H) is scratch.  The
// steps run in the opposite order of the forward (`reverse` is the
// forward's direction).  L + 1 launches on `stream` of CUDA device
// `device`.  Returns cudaGetLastError().
int itrx_gru_bwd(const void* gx, const void* mask, const void* hall, const void* ghall,
                 const void* gout, const void* gfinal, const void* whh, void* ggx,
                 void* ghn, void* gloc, void* gh0, int B, int L, int H, int reverse,
                 int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  int t_prev = -1;
  for (int step = 0; step <= L; ++step) {
    const int t = step == L ? -1 : (reverse ? step : L - 1 - step);
    gru_bwd_step_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(gx), static_cast<const float*>(mask),
        static_cast<const float*>(hall), static_cast<const float*>(ghall),
        static_cast<const float*>(gout), static_cast<const float*>(gfinal),
        static_cast<const float*>(whh), static_cast<float*>(ggx), static_cast<float*>(ghn),
        static_cast<float*>(gloc), static_cast<float*>(gh0), B, L, H, t_prev, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    t_prev = t;
  }
  return (int)cudaGetLastError();
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
