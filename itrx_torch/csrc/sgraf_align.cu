// SGRAF alignment nodes in training, the forward, for sm_90a.
//
// Replaces itrx/ops/pallas/sgraf_align.py::_fwd_kernel.  For caption c and
// image i, the word nodes of sgraf_nodes.cuh,
//   node_l = l2norm(W^T (ctx_l / (|ctx_l| + 1e-8) - cap_cl)^2 + b)   valid words
// written to out (Nc, Ni, L, S) in the embeddings' dtype, and zero rows at
// masked words: the kernel writes every row of out.
//
// What bounds it: the projection (D x S multiply-adds per valid word, about
// 78% of the operations at D 1024, S 256), then the A and context products
// (36 x D each).  Design: the eval kernels' tiling and node assembly (one
// block per pair of images and group of whole captions; the A tiles, the
// region softmax written over them, the valid rows listed), then the word
// rows projected in balanced tiles of at most 64 by sgraf_nodes_mma.cuh's
// split-bf16 products (x = hi + lo both bf16, three passes a_hi b_lo + a_lo
// b_hi + a_hi b_hi, fp32 accumulation): the projection on wgmma from
// TMA-staged slabs of the weight split once a call by the wrapper, the
// context on mma.sync (two passes for bf16 images, which are exact).  The A
// product stays as xattn_product.cuh forms it.  Each tile leaves through
// shared memory: a warp per row for its norm, then a thread per column pair
// for the store, coalesced along S.  The block's masked words get their zero
// rows first.  Sums run in a fixed order and nothing is atomic, so two calls
// give identical nodes.
#include "sgraf_nodes.cuh"
#include "sgraf_nodes_mma.cuh"

namespace {

using namespace itrx_sgraf_mma;

constexpr int kSmemBytes = kMmaFloats * 4;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// four zeros at p (S % 4 == 0: 8 bytes of bf16, 16 of fp32, aligned)
__device__ __forceinline__ void zero4(float* p) {
  *reinterpret_cast<float4*>(p) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void zero4(__nv_bfloat16* p) {
  *reinterpret_cast<uint2*>(p) = make_uint2(0u, 0u);
}

// The block's first image and first caption: the blocks of whole caption
// groups first (in block_origin's order, which keeps the images and captions
// in flight few), then those of the last group when it holds fewer than cpb
// captions, so that these shorter blocks fill the grid's last wave.
__device__ __forceinline__ void align_origin(int Ni, int Nc, int cpb, int* i0, int* c0) {
  const int full = Nc / cpb, n_pairs = (Ni + kImgs - 1) / kImgs;
  const int item = blockIdx.x;
  if (item < full * n_pairs) {
    block_origin(item, Ni, cpb, full, i0, c0);
  } else {
    *i0 = (item - full * n_pairs) * kImgs;
    *c0 = full * cpb;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sgraf_align_kernel(const T* __restrict__ cap,        // (Nc, L, D)
                   const float* __restrict__ mask,   // (Nc, L)
                   const T* __restrict__ img,        // (Ni, 36, D)
                   const float* __restrict__ gram,   // (Ni, 36, 36)
                   const uint32_t* __restrict__ wsplit,  // sim_tranloc_w, split
                   const float* __restrict__ bias,   // (S,)
                   T* __restrict__ out,              // (Nc, Ni, L, S)
                   int Ni, int Nc, int L, int D, int Kp, int S, int S8, int cpb) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float cinv[kImgs * kCols];
  __shared__ int rows[kMaxRows];
  __shared__ int n_rows[2];
  __shared__ long long out_at[kMmaRows];
  __shared__ float yinv_row[kMmaRows];
  const Nodes nd = node_smem(smem, cinv, rows, n_rows);
  const Ring rg = ring_smem(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  int i0, c0;
  align_origin(Ni, Nc, cpb, &i0, &c0);

  // the zero rows of the block's masked words: a warp takes 32 (image,
  // word) rows, a lane each to read the mask, then writes the masked ones
  const int ncols = cpb * L;
  for (int q0 = 32 * warp; q0 < kImgs * ncols; q0 += kThreads) {
    const int q = q0 + lane, p = q / ncols, col = q % ncols, c = c0 + col / L;
    const bool masked = q < kImgs * ncols && c < Nc && i0 + p < Ni &&
                        !(mask[(size_t)c * L + col % L] > 0.0f);
    for (unsigned todo = __ballot_sync(0xffffffffu, masked); todo; todo &= todo - 1) {
      const int qz = q0 + __ffs(todo) - 1, pz = qz / ncols, cz = qz % ncols;
      T* o = out + (((size_t)(c0 + cz / L) * Ni + i0 + pz) * L + cz % L) * S;
      for (int v = lane; v < S / 4; v += 32) zero4(o + 4 * v);
    }
  }

  init_weight_bars();
  assemble(nd, cap, mask, img, gram, i0, c0, cpb, Ni, Nc, L, D);
  split_softmax(nd);
  const int n_loc = n_rows[0];
  const int step = tile_step(n_loc);
  const int cp = tid % (kThreads / 2), half = tid / (kThreads / 2);
  for (int t0 = 0; t0 < n_loc; t0 += step) {
    WordRows<T> prod{nd, rg, cap, img, t0, min(step, n_loc - t0), i0, c0, Ni, L, D};
    Acc acc;
    mma_tile(acc, rg, wsplit, Kp, S8, prod.nrows, prod);
    tile_out(acc, rg, prod.nrows, [&](const float* y, int n) {
      // a warp per row: |y + b|^2, the row's inverse norm and its place in out
      for (int i = warp; i < n; i += kThreads / 32) {
        float sq = 0.0f;
        for (int c = lane; c < S; c += 32) {
          const float v = y[i * kLdY + c] + bias[c];
          sq = fmaf(v, v, sq);
        }
        sq = warp_sum(sq);
        if (lane == 0) {
          yinv_row[i] = 1.0f / (sqrtf(fmaxf(sq, 1e-16f)) + kEps);
          const int code = rows[t0 + i], p = code / kCols, col = code % kCols;
          out_at[i] = (((long long)(c0 + col / L) * Ni + i0 + p) * L + col % L) * S;
        }
      }
      __syncthreads();
      // a thread per column pair and half of the rows: the nodes, coalesced
      // along S
      if (2 * cp < S) {
        const float b0 = bias[2 * cp], b1 = bias[2 * cp + 1];
        for (int i = half; i < n; i += 2) {
          const float* yr = y + i * kLdY + 2 * cp;
          store2(out + out_at[i] + 2 * cp, (yr[0] + b0) * yinv_row[i],
                 (yr[1] + b1) * yinv_row[i]);
        }
      }
    });
  }
}

template <typename T>
int run(const void* cap, const void* mask, const void* img, const void* gram,
        const void* wsplit, const void* b, void* out, int Ni, int Nc, int L, int D, int S,
        cudaStream_t stream) {
  if (L < 1 || L > kCols || S < 4 || S > kMaxS || S % 4 != 0 || D < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (std::is_same<T, __nv_bfloat16>::value && D % 8 != 0) return (int)cudaErrorInvalidValue;
  const int Kp = (D + kSlab - 1) / kSlab * kSlab, S8 = (S + 7) / 8 * 8;
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
      static_cast<const T*>(cap), f(mask), static_cast<const T*>(img), f(gram),
      static_cast<const uint32_t*>(wsplit), f(b), static_cast<T*>(out), Ni, Nc, L, D, Kp, S,
      S8, cpb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cap (Nc, L, D) and img (Ni, 36, D) both fp32 or both bf16 (bf16 != 0;
// then D % 8 == 0 and both 16-byte aligned); mask (Nc, L), gram (Ni, 36,
// 36) and b (S,) fp32; wsplit the projection W (S, D) as torch stores it,
// split for the tensor cores (ops/kernels/sgraf_eval.py::split_weight: S8
// rows of Kp 32-bit words, S8 = S rounded up to 8, Kp = D rounded up to 32;
// 16-byte aligned); out (Nc, Ni, L, S) in the embeddings' dtype, every row
// written (zero at masked words).  1 <= L <= 128; S % 4 == 0, S <= 256.
// One launch on `stream` of CUDA device `device`; returns
// cudaGetLastError().
int itrx_sgraf_align(const void* cap, const void* mask, const void* img, const void* gram,
                     const void* wsplit, const void* b, void* out, int Ni, int Nc, int L, int D,
                     int S, int bf16, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return run<__nv_bfloat16>(cap, mask, img, gram, wsplit, b, out, Ni, Nc, L, D, S, s);
  return run<float>(cap, mask, img, gram, wsplit, b, out, Ni, Nc, L, D, S, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
