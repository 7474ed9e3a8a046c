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
// What bounds it: the projection of the word nodes, D x S multiply-adds per
// valid word (about 78% of the operations at D 1024, S 256), then the A and
// context products (36 x D each per word) and the global node (D x S per
// pair).  The projection and the global node run on wgmma, the context on
// mma.sync, all as three-pass split-bf16 products with fp32 accuracy kept
// (sgraf_nodes_mma.cuh); the A product as xattn_product.cuh has it (wmma
// bf16 for bf16 embeddings, fp32 FMAs for fp32).  With the weight slabs on
// the tensor memory accelerator and the products asynchronous, what is left
// on an NVIDIA H100 80GB HBM3 (700 W) is the operand formation, the per-slab
// barrier, the assembly and the epilogues (PERF.md §6).
// Design: one block per (pair of images, group of whole captions), the tiling
// of the SCAN kernels; the nodes are assembled, then projected in balanced
// tiles of at most 64 rows (the pairs' global rows last).  Each projected
// tile, read back from shared memory, ends with the row
// norms and SAF gates (a warp per row), the gate sums per pair, and the
// pooled sums per pair (a thread per column, row by row; a block takes at
// most 16 captions, so the pooled sums of its 32 pairs stay in shared
// memory).  No atomics, so a grid is the same on every run.  The block ends with one
// warp per pair for the epilogue.  Built with -DITRX_SAF_NO_POOL (the tile epilogues cut) or
// -DITRX_SAF_NO_PROJECT (the projection cut too), it times its own phases.
#include "sgraf_nodes.cuh"
#include "sgraf_nodes_mma.cuh"

namespace {

using namespace itrx_sgraf_mma;

// captions per block at most (the SCAN kernels' tiling takes 32 for L < 4;
// 16 keeps the pooled sums, 32 pairs x S, in shared memory)
constexpr int kSafCaps = 16;
// dynamic shared memory, in floats: the node and product regions, then the
// pooled sums per pair
constexpr int kSafFloats = kImgs * kSafCaps * kMaxS;
constexpr int kSmemBytes = (kMmaFloats + kSafFloats) * 4;

// the pooled sums' slot of pair p * kMaxCaps + cc
__device__ __forceinline__ int saf_slot(int pair) {
  return pair / kMaxCaps * kSafCaps + pair % kMaxCaps;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sgraf_eval_saf_kernel(const T* __restrict__ cap,        // (Nc, L, D)
                      const float* __restrict__ mask,   // (Nc, L)
                      const T* __restrict__ img,        // (Ni, 36, D)
                      const float* __restrict__ gram,   // (Ni, 36, 36)
                      const T* __restrict__ gloc,       // (Nc, D) caption global embeddings
                      const T* __restrict__ imgglo,     // (Ni, D) image global embeddings
                      const uint32_t* __restrict__ wsplit,  // sim_tranloc_w, split
                      const float* __restrict__ bias,   // (S,)
                      const uint32_t* __restrict__ gsplit,  // sim_tranglo_w, split
                      const float* __restrict__ gbias,  // (S,)
                      const float* __restrict__ awf,    // (S,) folded SAF gate
                      const float* __restrict__ abf,    // (1,)
                      const float* __restrict__ ew,     // (S,) sim_eval_w
                      const float* __restrict__ eb,     // (1,)
                      float* __restrict__ out,          // (Nc, Ni)
                      int Ni, int Nc, int L, int D, int Kp, int S, int S8, int cpb,
                      int n_groups) {
  extern __shared__ __align__(128) float smem[];
  float* saf_acc = smem + kMmaFloats;       // [kImgs * kSafCaps][kMaxS] pooled sums per pair
  __shared__ float cinv[kImgs * kCols];
  __shared__ int rows[kMaxRows];
  __shared__ int n_rows[2];
  __shared__ float coef_row[kMmaRows];
  __shared__ float a_row[kMmaRows];
  __shared__ int slot_row[kMmaRows];
  __shared__ float l1_acc[kImgs * kSafCaps];
  const Nodes nd = node_smem(smem, cinv, rows, n_rows);
  const Ring rg = ring_smem(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  int i0, c0;
  block_origin(Ni, cpb, n_groups, &i0, &c0);

  init_weight_bars();
  for (int idx = tid; idx < kSafFloats; idx += kThreads) saf_acc[idx] = 0.0f;

  if (tid < kImgs * kSafCaps) l1_acc[tid] = 0.0f;
  assemble(nd, cap, mask, img, gram, i0, c0, cpb, Ni, Nc, L, D);

#ifndef ITRX_SAF_NO_PROJECT
  project_mma(nd, rg, cap, img, gloc, imgglo, wsplit, bias, gsplit, gbias, i0, c0, Ni, L, D, Kp,
              S8, [&](const float* y, int t, int n, const float* bvec) {
#ifndef ITRX_SAF_NO_POOL
    // a warp per row: |y|^2 and y . awf, the row's norm and gate
    for (int i = warp; i < n; i += kThreads / 32) {
      float sq = 0.0f, lg = 0.0f;
      for (int c = lane; c < S; c += 32) {
        const float v = y[i * kLdY + c] + ld_param(bvec + c);
        sq = fmaf(v, v, sq);
        lg = fmaf(v, ld_param(awf + c), lg);
      }
      sq = warp_sum(sq);
      lg = warp_sum(lg);
      if (lane == 0) {
        const float yinv = 1.0f / (sqrtf(fmaxf(sq, 1e-16f)) + kEps);
        const float a = 1.0f / (1.0f + expf(-(lg * yinv + abf[0])));
        a_row[i] = a;
        coef_row[i] = a * yinv;
        slot_row[i] = saf_slot(pair_of(rows[t + i], L));
      }
    }
    __syncthreads();
    // the gate sums: the first row of each pair among these adds its pair's
    if (tid < n && (tid == 0 || slot_row[tid - 1] != slot_row[tid])) {
      float s = 0.0f;
      for (int i = tid; i < n && slot_row[i] == slot_row[tid]; ++i) s += a_row[i];
      l1_acc[slot_row[tid]] += s;
    }
    // a thread per column: the pooled sums, row by row, in a register over
    // each run of one pair's rows
    if (tid < S) {
      const float b = ld_param(bvec + tid);
      float run = 0.0f;
      for (int i = 0; i < n; ++i) {
        run = fmaf(coef_row[i], y[i * kLdY + tid] + b, run);
        if (i + 1 == n || slot_row[i + 1] != slot_row[i]) {
          saf_acc[slot_row[i] * kMaxS + tid] += run;
          run = 0.0f;
        }
      }
    }
#endif
  });
#endif

  // per pair: l1 normalization, l2norm, sim_eval_w and the sigmoid
  for (int q = warp; q < kImgs * kSafCaps; q += kThreads / 32) {
    const int p = q / kSafCaps, cc = q % kSafCaps, c = c0 + cc;
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
        const void* imgglo, const void* wsplit, const void* b, const void* gsplit, const void* gb,
        const void* awf, const void* abf, const void* ew, const void* eb, void* out, int Ni,
        int Nc, int L, int D, int S, cudaStream_t stream) {
  if (L < 1 || L > kCols || S < 4 || S > kMaxS || S % 4 != 0 || D < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (std::is_same<T, __nv_bfloat16>::value && D % 8 != 0) return (int)cudaErrorInvalidValue;
  const int Kp = (D + kSlab - 1) / kSlab * kSlab, S8 = (S + 7) / 8 * 8;
  const int cpb = min(caps_per_block(L), kSafCaps);
  const int n_groups = (Nc + cpb - 1) / cpb;
  const long long n_blocks = (long long)n_groups * ((Ni + kImgs - 1) / kImgs);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return (int)cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sgraf_eval_saf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  sgraf_eval_saf_kernel<T><<<(unsigned)n_blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(cap), f(mask), static_cast<const T*>(img), f(gram),
      static_cast<const T*>(gloc), static_cast<const T*>(imgglo), u(wsplit), f(b), u(gsplit),
      f(gb), f(awf), f(abf), f(ew), f(eb), static_cast<float*>(out), Ni, Nc, L, D, Kp, S, S8,
      cpb, n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cap (Nc, L, D), img (Ni, 36, D), gloc (Nc, D) and imgglo (Ni, D) all fp32
// or all bf16 (bf16 != 0; then D % 8 == 0 and cap, img 16-byte aligned);
// mask (Nc, L), gram (Ni, 36, 36), b, gb, awf, ew (S,), abf, eb (1,) fp32;
// wsplit and gsplit the projections W (S, D) as torch stores them, split
// for the tensor cores (ops/kernels/sgraf_eval.py::split_weight): S8 rows of
// Kp 32-bit words, S8 = S rounded up to 8, Kp = D rounded up to 32; per row
// and 16 of k, lane t's 16 bytes: bf16 hi of k 2t, 2t + 1, 2t + 8, 2t + 9,
// then their lo; zero padded, 16-byte aligned; out (Nc, Ni) fp32.
// 1 <= L <= 128; S % 4 == 0, S <= 256.
// One launch on `stream` of CUDA device `device`; returns cudaGetLastError().
int itrx_sgraf_eval_saf(const void* cap, const void* mask, const void* img, const void* gram,
                        const void* gloc, const void* imgglo, const void* wsplit, const void* b,
                        const void* gsplit, const void* gb, const void* awf, const void* abf,
                        const void* ew, const void* eb, void* out, int Ni, int Nc, int L,
                        int D, int S, int bf16, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return run<__nv_bfloat16>(cap, mask, img, gram, gloc, imgglo, wsplit, b, gsplit, gb, awf,
                              abf, ew, eb, out, Ni, Nc, L, D, S, s);
  }
  return run<float>(cap, mask, img, gram, gloc, imgglo, wsplit, b, gsplit, gb, awf, abf, ew,
                    eb, out, Ni, Nc, L, D, S, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
