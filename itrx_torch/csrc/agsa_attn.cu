// CAMERA's AGSA gated attention, the forward, for sm_90a.
//
// Replaces itrx/ops/pallas/agsa_attn.py::_fwd_kernel.  Per (batch row, head),
// on the head's q, k, v rows (N x d_k) after the q/k/v projections:
//   gq = q Wq^T + bq,  gk = k Wk^T + bk,  gg = rnd(gq * gk)
//   m1 = sig(gg Wg1^T + bg1),  m2 = sig(gg Wg2^T + bg2)
//   qm = rnd(q * m1 * inv),  km = rnd(k * m2)          inv = 1 / sqrt(d_k)
//   p  = softmax_keys(qm km^T),  out = rnd(rnd(p) v)
// where rnd rounds to the inputs' type T (the identity for fp32): the TPU
// kernel's rounding points.  Every sum is fp32.
//
// What bounds it here: at CAMERA's shapes (B 128, 64 heads, N 36 or 32,
// d_k 32) the four gate products and the two attention products are ~230 K
// multiply-adds a head against 3 x N x d_k inputs read and N x d_k written:
// in bf16 the bytes bound it (75 MB, 22.5 us), in fp32 the operations (3.8
// GFLOP at the fp32 peak, 56 us).  Design: one block per (batch row, group
// of G heads), G chosen by the host so that a block's shared memory stays
// near 72 KB (three blocks an SM).  q, k and v are read straight from the
// projections' (B, N, h d_k) rows (the group's heads are G d_k contiguous
// columns) into shared memory as fp32, and only out is written.  The four
// (d_k, d_k) weights go through shared memory two at a time, transposed (Wq
// and Wk for the gate products, then Wg1 and Wg2), so that the largest shape
// the limits allow (N 64, d_k 128, fp32) still fits one block; the biases
// stay there throughout.  The gate products run one output element a thread
// (the weight column across the warp, the input row broadcast), and each
// attention row is one warp: N <= 64 scores two a lane, the softmax by warp
// shuffles, then p v with d_k / 32 columns a lane.  Rows are padded to
// d_k + 1 floats, so a warp reading N key rows hits 32 banks.  fp32 FMAs
// throughout (no tensor cores): simple first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 64;
constexpr int kMaxDk = 128;
constexpr int kSmemTarget = 72 * 1024;
constexpr int kSmemMax = 232448;  // 227 KB, the most a block may use

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round to T and back: the TPU kernel's casts to the compute dtype
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float sigmoid_f(float z) { return 1.0f / (1.0f + expf(-z)); }

// floats of shared memory a block of g heads uses
__host__ __device__ inline size_t smem_floats(int g, int n, int dk) {
  return 2 * (size_t)dk * dk + 4 * (size_t)dk + 3 * (size_t)g * n * (dk + 1);
}

// Two (dk, dk) weights in torch's (out, in) layout -> shared memory
// transposed, wt[e * dk + c] = W[c][e], so that a warp's threads (consecutive
// c) read consecutive words.
template <typename T>
__device__ void stage_weights(const T* __restrict__ wa, const T* __restrict__ wb, float* ta,
                              float* tb, int dk) {
  for (int idx = threadIdx.x; idx < dk * dk; idx += kThreads) {
    const int c = idx / dk, e = idx % dk;
    ta[e * dk + c] = to_f(wa[idx]);
    tb[e * dk + c] = to_f(wb[idx]);
  }
}

// The group's rows of x (B, N, h dk) -> xs[(g * N + i) * ld + e], fp32.
template <typename T>
__device__ void stage_rows(const T* __restrict__ x, float* xs, size_t base, int n, int row,
                           int width, int dk, int ld) {
  for (int idx = threadIdx.x; idx < n * width; idx += kThreads) {
    const int i = idx / width, r = idx % width;
    xs[((r / dk) * n + i) * ld + r % dk] = to_f(x[base + (size_t)i * row + r]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
agsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ wq, const float* __restrict__ bq,
                const T* __restrict__ wk, const float* __restrict__ bk,
                const T* __restrict__ wg1, const float* __restrict__ bg1,
                const T* __restrict__ wg2, const float* __restrict__ bg2,
                T* __restrict__ out, int N, int H, int dk, int G, float inv) {
  extern __shared__ __align__(16) float smem[];
  const int ld = dk + 1;
  float* w0 = smem;             // dk x dk, transposed
  float* w1 = w0 + dk * dk;
  float* bias = w1 + dk * dk;   // bq, bk, bg1, bg2
  float* qs = bias + 4 * dk;    // G x N x ld: q, then qm
  float* ks = qs + G * N * ld;  // k, then km
  float* xs = ks + G * N * ld;  // gg, then v

  const int n_groups = (H + G - 1) / G;
  const int b = blockIdx.x / n_groups;
  const int h0 = (blockIdx.x % n_groups) * G;
  const int gn = min(G, H - h0);
  const int row = H * dk;  // elements of one (batch row, position) of q, k, v, out
  const int width = gn * dk;
  const size_t base = (size_t)b * N * row + (size_t)h0 * dk;
  const int tid = threadIdx.x;

  // 1. Wq^T, Wk^T, the biases, q and k
  stage_weights(wq, wk, w0, w1, dk);
  for (int c = tid; c < dk; c += kThreads) {
    bias[c] = bq[c];
    bias[dk + c] = bk[c];
    bias[2 * dk + c] = bg1[c];
    bias[3 * dk + c] = bg2[c];
  }
  stage_rows(q, qs, base, N, row, width, dk, ld);
  stage_rows(k, ks, base, N, row, width, dk, ld);
  __syncthreads();

  // 2. gg = rnd((q Wq^T + bq) * (k Wk^T + bk)), one element a thread
  const int n_out = gn * N * dk;
  for (int idx = tid; idx < n_out; idx += kThreads) {
    const int c = idx % dk, r = idx / dk;  // r = g * N + i
    const float* qr = qs + r * ld;
    const float* kr = ks + r * ld;
    float a = 0.0f, bb = 0.0f;
    for (int e = 0; e < dk; ++e) {
      a = fmaf(qr[e], w0[e * dk + c], a);
      bb = fmaf(kr[e], w1[e * dk + c], bb);
    }
    xs[r * ld + c] = rnd<T>((a + bias[c]) * (bb + bias[dk + c]));
  }
  __syncthreads();

  // 3. Wg1^T, Wg2^T over Wq^T, Wk^T
  stage_weights(wg1, wg2, w0, w1, dk);
  __syncthreads();

  // 4. the gates and the gated rows, in place: each element of q and k is
  //    read and written by the one thread that owns it
  for (int idx = tid; idx < n_out; idx += kThreads) {
    const int c = idx % dk, r = idx / dk;
    const float* xr = xs + r * ld;
    float z1 = 0.0f, z2 = 0.0f;
    for (int e = 0; e < dk; ++e) {
      z1 = fmaf(xr[e], w0[e * dk + c], z1);
      z2 = fmaf(xr[e], w1[e * dk + c], z2);
    }
    const float m1 = sigmoid_f(z1 + bias[2 * dk + c]);
    const float m2 = sigmoid_f(z2 + bias[3 * dk + c]);
    qs[r * ld + c] = rnd<T>(qs[r * ld + c] * m1 * inv);
    ks[r * ld + c] = rnd<T>(ks[r * ld + c] * m2);
  }
  __syncthreads();

  // 5. v over gg
  stage_rows(v, xs, base, N, row, width, dk, ld);
  __syncthreads();

  // 6. one warp a query row: the scores (keys lane and lane + 32), the
  //    softmax, then out = rnd(p) v with columns lane + 32 t
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < gn * N; r += kWarps) {
    const int g = r / N, i = r % N;
    const float* qr = qs + r * ld;
    const float* kb = ks + g * N * ld;
    const float* vb = xs + g * N * ld;
    float s0 = -INFINITY, s1 = -INFINITY;
    if (lane < N) {
      float a = 0.0f;
      for (int e = 0; e < dk; ++e) a = fmaf(qr[e], kb[lane * ld + e], a);
      s0 = a;
    }
    if (lane + 32 < N) {
      float a = 0.0f;
      for (int e = 0; e < dk; ++e) a = fmaf(qr[e], kb[(lane + 32) * ld + e], a);
      s1 = a;
    }
    float mx = fmaxf(s0, s1);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float e0 = lane < N ? expf(s0 - mx) : 0.0f;
    const float e1 = lane + 32 < N ? expf(s1 - mx) : 0.0f;
    float sum = e0 + e1;
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float p0 = rnd<T>(e0 / sum), p1 = rnd<T>(e1 / sum);
    float acc[kMaxDk / 32];
#pragma unroll
    for (int t = 0; t < kMaxDk / 32; ++t) acc[t] = 0.0f;
    for (int j = 0; j < N; ++j) {
      const float pj = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31);
      const float* vr = vb + j * ld;
#pragma unroll
      for (int t = 0; t < kMaxDk / 32; ++t) {
        const int c = lane + 32 * t;
        if (c < dk) acc[t] = fmaf(pj, vr[c], acc[t]);
      }
    }
    T* o = out + base + (size_t)i * row + g * dk;
#pragma unroll
    for (int t = 0; t < kMaxDk / 32; ++t) {
      const int c = lane + 32 * t;
      if (c < dk) o[c] = from_f<T>(acc[t]);
    }
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* wq, const void* bq,
        const void* wk, const void* bk, const void* wg1, const void* bg1, const void* wg2,
        const void* bg2, void* out, int B, int N, int H, int dk, cudaStream_t stream) {
  // heads a block: as many as keep it near kSmemTarget, at least one
  int G = 1;
  while (G < H && smem_floats(G + 1, N, dk) * sizeof(float) <= (size_t)kSmemTarget) ++G;
  const size_t smem = smem_floats(G, N, dk) * sizeof(float);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const long long n_blocks = (long long)B * ((H + G - 1) / G);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      agsa_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float inv = (float)(1.0 / std::sqrt((double)dk));
  const auto ct = [](const void* p) { return static_cast<const T*>(p); };
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  agsa_fwd_kernel<T><<<(unsigned)n_blocks, kThreads, smem, stream>>>(
      ct(q), ct(k), ct(v), ct(wq), cf(bq), ct(wk), cf(bk), ct(wg1), cf(bg1), ct(wg2),
      cf(bg2), static_cast<T*>(out), N, H, dk, G, inv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out (B, N, H dk) and the weights wq, wk, wg1, wg2 (dk, dk), torch's
// (out, in) layout, all fp32 or all bf16 (bf16 != 0); the biases bq, bk, bg1,
// bg2 (dk) fp32; contiguous.  1 <= N <= 64, 8 <= dk <= 128, dk % 8 == 0.  One
// launch on `stream` of CUDA device `device`; returns cudaGetLastError().
int itrx_agsa_fwd(const void* q, const void* k, const void* v, const void* wq, const void* bq,
                  const void* wk, const void* bk, const void* wg1, const void* bg1,
                  const void* wg2, const void* bg2, void* out, int B, int N, int H, int dk,
                  int bf16, int device, void* stream) {
  if (B < 1 || H < 1 || N < 1 || N > kMaxN || dk < 8 || dk > kMaxDk || dk % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return run<__nv_bfloat16>(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, out, B, N, H, dk, s);
  }
  return run<float>(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, out, B, N, H, dk, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
