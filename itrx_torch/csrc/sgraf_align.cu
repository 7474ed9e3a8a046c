// SGRAF alignment nodes in training, the forward, for sm_90a.
//
// Replaces itrx/ops/pallas/sgraf_align.py::_fwd_kernel.  For caption c and
// image i, the word nodes of sgraf_nodes.cuh,
//   node_l = l2norm(W^T (ctx_l / (|ctx_l| + 1e-8) - cap_cl)^2 + b)   valid words
// written to out (Nc, Ni, L, S) in the embeddings' dtype; the nodes of
// masked words stay as the caller set them (zero).
//
// What bounds it here: fp32 operations, the projection (D x S multiply-adds
// per valid word, about 78% of them at D 1024, S 256), then the A and
// context products (36 x D each).  Design: the eval kernels' tiling and node
// assembly (one block per pair of images and group of whole captions; the A
// tiles, the region softmax written over them, the valid rows listed), the
// rows projected 64 at a time by `project`, each tile's rows normalized and
// stored from registers.  No global rows.  Every step after reading the
// inputs is fp32.
#include "sgraf_nodes.cuh"

namespace {

using namespace itrx_sgraf;

constexpr int kSmemBytes = kNodeFloats * 4;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sgraf_align_kernel(const T* __restrict__ cap,        // (Nc, L, D)
                   const float* __restrict__ mask,   // (Nc, L)
                   const T* __restrict__ img,        // (Ni, 36, D)
                   const float* __restrict__ gram,   // (Ni, 36, 36)
                   const float* __restrict__ wt,     // (D, S) sim_tranloc_w
                   const float* __restrict__ bias,   // (S,)
                   T* __restrict__ out,              // (Nc, Ni, L, S)
                   int Ni, int Nc, int L, int D, int S, int cpb, int n_groups) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float cinv[kImgs * kCols];
  __shared__ int rows[kMaxRows];
  __shared__ int n_rows[2];
  __shared__ float red_sq[4][kTileRows];
  __shared__ float yinv_row[kTileRows];
  const Nodes nd = node_smem(smem, cinv, rows, n_rows);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  int i0, c0;
  block_origin(Ni, cpb, n_groups, &i0, &c0);
  assemble(nd, cap, mask, img, gram, i0, c0, cpb, Ni, Nc, L, D);
  if (tid == 0) n_rows[1] = 0;  // the word rows alone
  __syncthreads();

  const int h = tid / (kThreads / 2), cp = tid % (kThreads / 2);
  const bool col_ok = 2 * cp < S;
  project(nd, cap, img, cap, img, wt, bias, wt, bias, i0, c0, Ni, L, D, S,
          [&](float (&acc)[32][2], int t0, int nrows, bool) {
    // per row |y|^2 over the S columns: 4 warps of 64 columns each
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const float sq = warp_sum(acc[r][0] * acc[r][0] + acc[r][1] * acc[r][1]);
      if (lane == 0) red_sq[warp % 4][32 * h + r] = sq;
    }
    __syncthreads();
    if (tid < nrows) {
      const float sq = ((red_sq[0][tid] + red_sq[1][tid]) + red_sq[2][tid]) + red_sq[3][tid];
      yinv_row[tid] = 1.0f / (sqrtf(fmaxf(sq, 1e-16f)) + kEps);
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int tr = 32 * h + r;
        if (tr < nrows) {
          const int code = rows[t0 + tr];
          const int p = code / kCols, col = code % kCols;
          const size_t o =
              (((size_t)(c0 + col / L) * Ni + i0 + p) * L + col % L) * S + 2 * cp;
          store2(out + o, acc[r][0] * yinv_row[tr], acc[r][1] * yinv_row[tr]);
        }
      }
    }
  });
}

template <typename T>
int run(const void* cap, const void* mask, const void* img, const void* gram, const void* wt,
        const void* b, void* out, int Ni, int Nc, int L, int D, int S, cudaStream_t stream) {
  if (L < 1 || L > kCols || S < 4 || S > kMaxS || S % 4 != 0 || D < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (std::is_same<T, __nv_bfloat16>::value && D % 8 != 0) return (int)cudaErrorInvalidValue;
  const int cpb = caps_per_block(L);
  const int n_groups = (Nc + cpb - 1) / cpb;
  const long long n_blocks = (long long)n_groups * ((Ni + kImgs - 1) / kImgs);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return (int)cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sgraf_align_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  sgraf_align_kernel<T><<<(unsigned)n_blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(cap), f(mask), static_cast<const T*>(img), f(gram), f(wt), f(b),
      static_cast<T*>(out), Ni, Nc, L, D, S, cpb, n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cap (Nc, L, D) and img (Ni, 36, D) both fp32 or both bf16 (bf16 != 0;
// then D % 8 == 0 and both 16-byte aligned); mask (Nc, L), gram (Ni, 36,
// 36), wt (D, S, 16-byte aligned) and b (S,) fp32; out (Nc, Ni, L, S) in
// the embeddings' dtype, written at valid words only.  1 <= L <= 128;
// S % 4 == 0, S <= 256.  One launch on `stream` of CUDA device `device`;
// returns cudaGetLastError().
int itrx_sgraf_align(const void* cap, const void* mask, const void* img, const void* gram,
                     const void* wt, const void* b, void* out, int Ni, int Nc, int L, int D,
                     int S, int bf16, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return run<__nv_bfloat16>(cap, mask, img, gram, wt, b, out, Ni, Nc, L, D, S, s);
  return run<float>(cap, mask, img, gram, wt, b, out, Ni, Nc, L, D, S, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
