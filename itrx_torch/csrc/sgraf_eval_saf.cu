// SGRAF-SAF evaluation scores for sm_90a.
//
// Replaces itrx/ops/pallas/sgraf_eval.py::_eval_saf_kernel.  For caption c
// and image i, the nodes of sgraf_nodes.cuh (one per valid word and the
// global node), then
//   a_n      = sigmoid(node_n . awf + abf)      (SAF's gate, eval BatchNorm folded in)
//   saf      = sum_n a_n node_n / (sum_n a_n + 1e-8)
//   score    = sigmoid(ew . saf / (sqrt(max(|saf|^2, 1e-16)) + 1e-8) + eb)
// Only the fp32 score per pair reaches device memory.
//
// What bounds it here: the projection of the word nodes, D x S multiply-adds
// per valid word (about 78% of the operations at D 1024, S 256), then the A
// and context products (36 x D each per word) and the global node (D x S per
// pair).
// Design: one block per (pair of images, group of whole captions), the tiling
// of the SCAN kernels; the nodes are assembled and projected 64 rows at a time
// as sgraf_nodes.cuh sets out (the pairs' global rows last).  Each projected
// tile ends with the row norms, the SAF gates and the pooled sums per pair,
// added in a fixed order (no atomics, so a grid is the same on every run), and
// the block ends with one warp per pair for the epilogue.  Every step after
// reading the inputs is fp32.
#include "sgraf_nodes.cuh"

namespace {

using namespace itrx_sgraf;

// dynamic shared memory, in floats: the node regions, then the pooled sums
// per pair
constexpr int kSafFloats = kMaxPairs * kMaxS;
constexpr int kSmemBytes = (kNodeFloats + kSafFloats) * 4;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sgraf_eval_saf_kernel(const T* __restrict__ cap,        // (Nc, L, D)
                      const float* __restrict__ mask,   // (Nc, L)
                      const T* __restrict__ img,        // (Ni, 36, D)
                      const float* __restrict__ gram,   // (Ni, 36, 36)
                      const T* __restrict__ gloc,       // (Nc, D) caption global embeddings
                      const T* __restrict__ imgglo,     // (Ni, D) image global embeddings
                      const float* __restrict__ wt,     // (D, S) sim_tranloc_w
                      const float* __restrict__ bias,   // (S,)
                      const float* __restrict__ gwt,    // (D, S) sim_tranglo_w
                      const float* __restrict__ gbias,  // (S,)
                      const float* __restrict__ awf,    // (S,) folded SAF gate
                      const float* __restrict__ abf,    // (1,)
                      const float* __restrict__ ew,     // (S,) sim_eval_w
                      const float* __restrict__ eb,     // (1,)
                      float* __restrict__ out,          // (Nc, Ni)
                      int Ni, int Nc, int L, int D, int S, int cpb, int n_groups) {
  extern __shared__ __align__(128) float smem[];
  float* saf_acc = smem + kNodeFloats;       // [kMaxPairs][kMaxS] pooled sums per pair
  __shared__ float cinv[kImgs * kCols];
  __shared__ int rows[kMaxRows];
  __shared__ int n_rows[2];
  __shared__ float red_sq[4][kTileRows];
  __shared__ float red_lg[4][kTileRows];
  __shared__ float a_row[kTileRows];
  __shared__ float yinv_row[kTileRows];
  __shared__ float l1_acc[kMaxPairs];
  const Nodes nd = node_smem(smem, cinv, rows, n_rows);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  int i0, c0;
  block_origin(Ni, cpb, n_groups, &i0, &c0);

  for (int idx = tid; idx < kSafFloats; idx += kThreads) saf_acc[idx] = 0.0f;
  if (tid < kMaxPairs) l1_acc[tid] = 0.0f;
  assemble(nd, cap, mask, img, gram, i0, c0, cpb, Ni, Nc, L, D);

  // each tile: per row |y|^2 and y . awf reduced over the S columns, the row's
  // gate and norm, then the pooled sums per pair, half 0's rows then half
  // 1's, each in row order
  const int h = tid / (kThreads / 2), cp = tid % (kThreads / 2);
  const bool col_ok = 2 * cp < S;
  const float g0 = col_ok ? awf[2 * cp] : 0.0f, g1 = col_ok ? awf[2 * cp + 1] : 0.0f;
  project(nd, cap, img, gloc, imgglo, wt, bias, gwt, gbias, i0, c0, Ni, L, D, S,
          [&](float (&acc)[32][2], int t0, int nrows, bool) {
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const float sq = warp_sum(acc[r][0] * acc[r][0] + acc[r][1] * acc[r][1]);
      const float lg = warp_sum(acc[r][0] * g0 + acc[r][1] * g1);
      if (lane == 0) {
        red_sq[warp % 4][32 * h + r] = sq;
        red_lg[warp % 4][32 * h + r] = lg;
      }
    }
    __syncthreads();
    if (tid < nrows) {
      const float sq = ((red_sq[0][tid] + red_sq[1][tid]) + red_sq[2][tid]) + red_sq[3][tid];
      const float lg = ((red_lg[0][tid] + red_lg[1][tid]) + red_lg[2][tid]) + red_lg[3][tid];
      const float yinv = 1.0f / (sqrtf(fmaxf(sq, 1e-16f)) + kEps);
      a_row[tid] = 1.0f / (1.0f + expf(-(lg * yinv + abf[0])));
      yinv_row[tid] = yinv;
    }
    __syncthreads();
    for (int hh = 0; hh < 2; ++hh) {
      if (h == hh && col_ok) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int tr = 32 * h + r;
          if (tr < nrows) {
            const int pair = pair_of(rows[t0 + tr], L);
            const float coef = a_row[tr] * yinv_row[tr];
            saf_acc[pair * kMaxS + 2 * cp] += coef * acc[r][0];
            saf_acc[pair * kMaxS + 2 * cp + 1] += coef * acc[r][1];
            if (cp == 0) l1_acc[pair] += a_row[tr];
          }
        }
      }
      __syncthreads();
    }
  });

  // per pair: l1 normalization, l2norm, sim_eval_w and the sigmoid
  for (int q = warp; q < kMaxPairs; q += kThreads / 32) {
    const int p = q / kMaxCaps, cc = q % kMaxCaps, c = c0 + cc;
    if (cc >= cpb || c >= Nc || i0 + p >= Ni) continue;
    const float inv_l1 = 1.0f / (l1_acc[q] + kEps);
    float sq = 0.0f, dot = 0.0f;
    for (int col = lane; col < S; col += 32) {
      const float v = saf_acc[q * kMaxS + col] * inv_l1;
      sq = fmaf(v, v, sq);
      dot = fmaf(v, ew[col], dot);
    }
    sq = warp_sum(sq);
    dot = warp_sum(dot);
    if (lane == 0) {
      const float z = dot / (sqrtf(fmaxf(sq, 1e-16f)) + kEps) + eb[0];
      out[(size_t)c * Ni + i0 + p] = 1.0f / (1.0f + expf(-z));
    }
  }
}

template <typename T>
int run(const void* cap, const void* mask, const void* img, const void* gram, const void* gloc,
        const void* imgglo, const void* wt, const void* b, const void* gwt, const void* gb,
        const void* awf, const void* abf, const void* ew, const void* eb, void* out, int Ni,
        int Nc, int L, int D, int S, cudaStream_t stream) {
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
      sgraf_eval_saf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  sgraf_eval_saf_kernel<T><<<(unsigned)n_blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(cap), f(mask), static_cast<const T*>(img), f(gram),
      static_cast<const T*>(gloc), static_cast<const T*>(imgglo), f(wt), f(b), f(gwt), f(gb),
      f(awf), f(abf), f(ew), f(eb), static_cast<float*>(out), Ni, Nc, L, D, S, cpb, n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cap (Nc, L, D), img (Ni, 36, D), gloc (Nc, D) and imgglo (Ni, D) all fp32
// or all bf16 (bf16 != 0; then D % 8 == 0 and cap, img 16-byte aligned);
// mask (Nc, L), gram (Ni, 36, 36), wt and gwt (D, S), b, gb, awf, ew (S,),
// abf, eb (1,) fp32; out (Nc, Ni) fp32.  1 <= L <= 128; S % 4 == 0, S <= 256;
// wt and gwt 16-byte aligned.
// One launch on `stream` of CUDA device `device`; returns cudaGetLastError().
int itrx_sgraf_eval_saf(const void* cap, const void* mask, const void* img, const void* gram,
                        const void* gloc, const void* imgglo, const void* wt, const void* b,
                        const void* gwt, const void* gb, const void* awf, const void* abf,
                        const void* ew, const void* eb, void* out, int Ni, int Nc, int L,
                        int D, int S, int bf16, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return run<__nv_bfloat16>(cap, mask, img, gram, gloc, imgglo, wt, b, gwt, gb, awf, abf, ew,
                              eb, out, Ni, Nc, L, D, S, s);
  }
  return run<float>(cap, mask, img, gram, gloc, imgglo, wt, b, gwt, gb, awf, abf, ew, eb, out,
                    Ni, Nc, L, D, S, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
