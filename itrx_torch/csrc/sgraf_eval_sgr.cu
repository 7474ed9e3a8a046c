// SGRAF-SGR evaluation scores for sm_90a.
//
// Replaces itrx/ops/pallas/sgraf_eval.py::_eval_kernel.  For caption c and
// image i, the n nodes X of sgraf_nodes.cuh (the global node first, then one
// per valid word), then `steps - 1` full graph-reasoning steps with the q/k
// fold M = Wq^T Wk, v = Wk^T bq of the wrapper:
//   e_ab     = (X_a M + v) . X_b                   over the pair's nodes only
//   ctx_a    = sum_b softmax_b(e_ab) X_b
//   X_a     <- relu(ctx_a Wg + bg)
// then the same step for query node 0 alone and the epilogue
//   score    = sigmoid(ew . relu(ctx_0 Wg + bg) + eb).
// Masked words are never nodes, so the softmax runs over the valid nodes with
// no mask and no padding.  Only the fp32 score per pair reaches device memory.
//
// What bounds it here: the projection of the word nodes (D x S multiply-adds
// per valid word) and the reasoning products X M and ctx Wg (S x S each per
// node and full step), about equal at D 1024, S 256 and three steps; then the
// A and context products (36 x D per word) and the global node.  The edges
// and contexts (n x n x S per pair and step) are a few percent.
// Design: a persistent grid, one block per SM, each looping over the work
// items of the SAF kernel's tiling (a pair of images and a group of whole
// captions).  The block assembles and projects the item's nodes as
// sgraf_nodes.cuh sets out and writes them, l2-normalized, to its own slice
// of a device-memory workspace (at most 320 rows x S, with one more buffer of
// the same size for X M + v and then ctx, about 0.66 MB a block at S 256,
// served mostly from L2; it does not grow with Nc x Ni).  A full step runs X M
// + v over all of the item's rows with the projection's 64-row tile product
// (the operand read from the workspace, M staged in slabs), then the edges:
// as many pairs as fit are staged in shared memory, and each warp takes one
// query row, forming its edge row, the softmax and the context in one pass
// over the pair's keys (an online softmax), and writes ctx over the row's
// X M + v; then ctx Wg + bg with the same tile product, ReLU, over X.  The
// node-0 step runs the products on the item's global rows only (at most 64
// pairs: one tile) and one warp per pair reads the keys from the workspace.
// Every step after reading the inputs is fp32, in a fixed order (no atomics),
// so a grid is the same on every run.
#include "sgraf_nodes.cuh"

namespace {

using namespace itrx_sgraf;

constexpr int kSmemBytes = kNodeFloats * 4;
// the edges' staging buffer lies over the tile region and the weight slabs
constexpr int kStageFloats = kTileRegion + kXFloats;
static_assert(kStageFloats / kMaxS >= kCols + 1, "one pair's nodes fit the staging buffer");

// y (a query row in device memory, S columns) <- sum_b softmax_b(y . key(b)) key(b)
// over the n keys, by one warp: lane l holds columns 4l .. 4l+3 and 128 + 4l ..
// 128 + 4l + 3; one pass over the keys with a running maximum.
template <typename Key>
__device__ __forceinline__ void attend(float* y, int n, int S, Key key) {
  const int lane = threadIdx.x % 32;
  const int ca = 4 * lane, cb = 128 + 4 * lane;
  const bool lo = ca < S, hi = cb < S;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 y0 = lo ? *reinterpret_cast<const float4*>(y + ca) : zero;
  const float4 y1 = hi ? *reinterpret_cast<const float4*>(y + cb) : zero;
  float4 a0 = zero, a1 = zero;
  float m = -3.0e38f, l = 0.0f;
  for (int b = 0; b < n; ++b) {
    const float* kb = key(b);
    const float4 k0 = lo ? *reinterpret_cast<const float4*>(kb + ca) : zero;
    const float4 k1 = hi ? *reinterpret_cast<const float4*>(kb + cb) : zero;
    const float e = warp_sum(((y0.x * k0.x + y0.y * k0.y) + (y0.z * k0.z + y0.w * k0.w)) +
                             ((y1.x * k1.x + y1.y * k1.y) + (y1.z * k1.z + y1.w * k1.w)));
    if (e > m) {
      const float sc = expf(m - e);
      l *= sc;
      a0.x *= sc; a0.y *= sc; a0.z *= sc; a0.w *= sc;
      a1.x *= sc; a1.y *= sc; a1.z *= sc; a1.w *= sc;
      m = e;
    }
    const float p = expf(e - m);
    l += p;
    a0.x = fmaf(p, k0.x, a0.x); a0.y = fmaf(p, k0.y, a0.y);
    a0.z = fmaf(p, k0.z, a0.z); a0.w = fmaf(p, k0.w, a0.w);
    a1.x = fmaf(p, k1.x, a1.x); a1.y = fmaf(p, k1.y, a1.y);
    a1.z = fmaf(p, k1.z, a1.z); a1.w = fmaf(p, k1.w, a1.w);
  }
  const float inv = 1.0f / l;
  if (lo) *reinterpret_cast<float4*>(y + ca) = make_float4(a0.x * inv, a0.y * inv, a0.z * inv,
                                                           a0.w * inv);
  if (hi) *reinterpret_cast<float4*>(y + cb) = make_float4(a1.x * inv, a1.y * inv, a1.z * inv,
                                                           a1.w * inv);
}

// src rows [r_begin, r_end) (S columns, device memory) . wmat (S x S), 64 rows
// a tile; epi(acc, t0, nrows) takes each tile.
template <typename Epi>
__device__ __forceinline__ void rows_product(const Nodes& nd, const float* src, int r_begin,
                                             int r_end, const float* __restrict__ wmat, int S,
                                             Epi epi) {
  const int h = threadIdx.x / (kThreads / 2);
  for (int t0 = r_begin; t0 < r_end; t0 += kTileRows) {
    const int nrows = min(kTileRows, r_end - t0);
    const auto row = [&](int k0, int dk, float (&dv)[8]) {
      const int r = threadIdx.x % kTileRows;
      const float* a = src + (size_t)(t0 + r) * S + k0 + dk;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = r < nrows && k0 + dk + 4 * j < S;
        const float4 v = ok ? *reinterpret_cast<const float4*>(a + 4 * j)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        dv[4 * j] = v.x;
        dv[4 * j + 1] = v.y;
        dv[4 * j + 2] = v.z;
        dv[4 * j + 3] = v.w;
      }
    };
    float acc[32][2];
    tile_product(acc, wmat, S, S, nd, 32 * h < nrows, [](int) {}, row);
    epi(acc, t0, nrows);
  }
}

// dst rows t0 .. t0 + nrows - 1 <- acc + vec (ReLU'd when `relu`)
__device__ __forceinline__ void store_rows(const float (&acc)[32][2], float* dst,
                                           const float* __restrict__ vec, int t0, int nrows,
                                           int S, bool relu) {
  const int h = threadIdx.x / (kThreads / 2), cp = threadIdx.x % (kThreads / 2);
  if (2 * cp >= S) return;
  const float v0 = vec[2 * cp], v1 = vec[2 * cp + 1];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    if (32 * h + r < nrows) {
      float y0 = acc[r][0] + v0, y1 = acc[r][1] + v1;
      if (relu) {
        y0 = fmaxf(y0, 0.0f);
        y1 = fmaxf(y1, 0.0f);
      }
      *reinterpret_cast<float2*>(dst + (size_t)(t0 + 32 * h + r) * S + 2 * cp) =
          make_float2(y0, y1);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sgraf_eval_sgr_kernel(const T* __restrict__ cap,        // (Nc, L, D)
                      const float* __restrict__ mask,   // (Nc, L)
                      const T* __restrict__ img,        // (Ni, 36, D)
                      const float* __restrict__ gram,   // (Ni, 36, 36)
                      const T* __restrict__ gloc,       // (Nc, D) caption global embeddings
                      const T* __restrict__ imgglo,     // (Ni, D) image global embeddings
                      const float* __restrict__ wt,     // (D, S) sim_tranloc_w
                      const float* __restrict__ bias,   // (S,)
                      const float* __restrict__ gwt,    // (D, S) sim_tranglo_w
                      const float* __restrict__ gbias,  // (S,)
                      const float* __restrict__ mm,     // (steps, S, S) Wq^T Wk
                      const float* __restrict__ vv,     // (steps, S) Wk^T bq
                      const float* __restrict__ wgt,    // (steps, S, S) sim_graph_w, (in, out)
                      const float* __restrict__ bg,     // (steps, S)
                      const float* __restrict__ ew,     // (S,) sim_eval_w
                      const float* __restrict__ eb,     // (1,)
                      float* __restrict__ out,          // (Nc, Ni)
                      float* __restrict__ ws,           // (gridDim.x, 2, kMaxRows, S)
                      int Ni, int Nc, int L, int D, int S, int steps, int cpb, int n_groups,
                      int n_items) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float cinv[kImgs * kCols];
  __shared__ int rows[kMaxRows];
  __shared__ int n_rows[2];
  __shared__ float red[4][kTileRows];
  __shared__ float yinv_row[kTileRows];
  // per pair: node count (0 for a pair past Ni or Nc), first word row, global row
  __shared__ int pair_n[kMaxPairs];
  __shared__ int pair_ls[kMaxPairs];
  __shared__ int pair_gs[kMaxPairs];
  // per staged row of the edges: its pair and node
  __shared__ int buf_pair[kMaxRows];
  __shared__ int buf_node[kMaxRows];
  const Nodes nd = node_smem(smem, cinv, rows, n_rows);
  float* const buf = smem;  // [rows][S] staged nodes, over the tile region and the slabs

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int h = tid / (kThreads / 2), cp = tid % (kThreads / 2);
  const bool col_ok = 2 * cp < S;
  const int buf_rows = kStageFloats / S;
  float* const ws_x = ws + (size_t)blockIdx.x * 2 * kMaxRows * S;  // the nodes X
  float* const ws_y = ws_x + (size_t)kMaxRows * S;                 // X M + v, then ctx
  // the workspace row of node j of pair q
  const auto slot = [&](int q, int j) { return j == 0 ? pair_gs[q] : pair_ls[q] + j - 1; };

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    int i0, c0;
    block_origin(item, Ni, cpb, n_groups, &i0, &c0);
    assemble(nd, cap, mask, img, gram, i0, c0, cpb, Ni, Nc, L, D);
    const int n_loc = n_rows[0], n_all = n_rows[0] + n_rows[1];
    if (tid < kMaxPairs) {
      const int cc = tid % kMaxCaps, c = c0 + cc;
      int n = 0;
      if (cc < cpb && c < Nc && i0 + tid / kMaxCaps < Ni) {
        n = 1;
        for (int l = 0; l < L; ++l) n += mask[(size_t)c * L + l] > 0.0f;
      }
      pair_n[tid] = n;
    }
    __syncthreads();
    if (tid == 0) {
      // the rows list holds each pair's words contiguously, and the valid
      // pairs' global rows in pair order after all words
      int ls = 0, gs = n_loc;
      for (int q = 0; q < kMaxPairs; ++q) {
        pair_ls[q] = ls;
        pair_gs[q] = gs;
        if (pair_n[q] > 0) {
          ls += pair_n[q] - 1;
          ++gs;
        }
      }
    }

    // the nodes, l2-normalized, into ws_x at their row of the list
    project(nd, cap, img, gloc, imgglo, wt, bias, gwt, gbias, i0, c0, Ni, L, D, S,
            [&](float (&acc)[32][2], int t0, int nrows, bool) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const float sq = warp_sum(acc[r][0] * acc[r][0] + acc[r][1] * acc[r][1]);
        if (lane == 0) red[warp % 4][32 * h + r] = sq;
      }
      __syncthreads();
      if (tid < nrows) {
        const float sq = ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
        yinv_row[tid] = 1.0f / (sqrtf(fmaxf(sq, 1e-16f)) + kEps);
      }
      __syncthreads();
      if (col_ok) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int tr = 32 * h + r;
          if (tr < nrows) {
            *reinterpret_cast<float2*>(ws_x + (size_t)(t0 + tr) * S + 2 * cp) =
                make_float2(acc[r][0] * yinv_row[tr], acc[r][1] * yinv_row[tr]);
          }
        }
      }
    });

    for (int st = 0; st + 1 < steps; ++st) {
      const float* m_st = mm + (size_t)st * S * S;
      const float* g_st = wgt + (size_t)st * S * S;
      rows_product(nd, ws_x, 0, n_all, m_st, S, [&](float (&acc)[32][2], int t0, int nrows) {
        store_rows(acc, ws_y, vv + (size_t)st * S, t0, nrows, S, false);
      });
      // the edges, pairs [q0, q1) at a time
      for (int q0 = 0; q0 < kMaxPairs;) {
        int q1 = q0, nb = 0;
        while (q1 < kMaxPairs && nb + pair_n[q1] <= buf_rows) nb += pair_n[q1++];
        for (int r = tid; r < nb; r += kThreads) {
          int q = q0, start = 0;
          while (r >= start + pair_n[q]) start += pair_n[q++];
          buf_pair[r] = q;
          buf_node[r] = r - start;
        }
        __syncthreads();  // also: the product's readers of the slabs are done
        const int vecs = S / 4;
        for (int idx = tid; idx < nb * vecs; idx += kThreads) {
          const int r = idx / vecs, v = idx % vecs;
          reinterpret_cast<float4*>(buf + (size_t)r * S)[v] = reinterpret_cast<const float4*>(
              ws_x + (size_t)slot(buf_pair[r], buf_node[r]) * S)[v];
        }
        __syncthreads();
        for (int r = warp; r < nb; r += kThreads / 32) {
          const int q = buf_pair[r], j = buf_node[r];
          const float* keys = buf + (size_t)(r - j) * S;
          attend(ws_y + (size_t)slot(q, j) * S, pair_n[q], S,
                 [&](int b) { return keys + (size_t)b * S; });
        }
        __syncthreads();
        q0 = q1;
      }
      rows_product(nd, ws_y, 0, n_all, g_st, S, [&](float (&acc)[32][2], int t0, int nrows) {
        store_rows(acc, ws_x, bg + (size_t)st * S, t0, nrows, S, true);
      });
    }

    // the node-0 step on the global rows (one tile), then the epilogue
    const int last = steps - 1;
    rows_product(nd, ws_x, n_loc, n_all, mm + (size_t)last * S * S, S,
                 [&](float (&acc)[32][2], int t0, int nrows) {
      store_rows(acc, ws_y, vv + (size_t)last * S, t0, nrows, S, false);
    });
    __syncthreads();
    for (int q = warp; q < kMaxPairs; q += kThreads / 32) {
      if (pair_n[q] == 0) continue;
      attend(ws_y + (size_t)pair_gs[q] * S, pair_n[q], S,
             [&](int b) { return ws_x + (size_t)slot(q, b) * S; });
    }
    const float* bl = bg + (size_t)last * S;
    const float b0 = col_ok ? bl[2 * cp] : 0.0f, b1 = col_ok ? bl[2 * cp + 1] : 0.0f;
    const float e0 = col_ok ? ew[2 * cp] : 0.0f, e1 = col_ok ? ew[2 * cp + 1] : 0.0f;
    rows_product(nd, ws_y, n_loc, n_all, wgt + (size_t)last * S * S, S,
                 [&](float (&acc)[32][2], int t0, int nrows) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const float z = warp_sum(fmaxf(acc[r][0] + b0, 0.0f) * e0 +
                                 fmaxf(acc[r][1] + b1, 0.0f) * e1);
        if (lane == 0) red[warp % 4][32 * h + r] = z;
      }
      __syncthreads();
      if (tid < nrows) {
        const float z = ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid] + eb[0];
        const int q = rows[t0 + tid] - kImgs * kCols;
        out[(size_t)(c0 + q % kMaxCaps) * Ni + i0 + q / kMaxCaps] = 1.0f / (1.0f + expf(-z));
      }
    });
    __syncthreads();  // the next item rewrites the shared state
  }
}

template <typename T>
int run(const void* cap, const void* mask, const void* img, const void* gram, const void* gloc,
        const void* imgglo, const void* wt, const void* b, const void* gwt, const void* gb,
        const void* mm, const void* vv, const void* wgt, const void* bg, const void* ew,
        const void* eb, void* out, void* ws, int Ni, int Nc, int L, int D, int S, int steps,
        int n_ctas, cudaStream_t stream) {
  if (L < 1 || L > kCols || S < 4 || S > kMaxS || S % 4 != 0 || D < 1 || steps < 1 ||
      n_ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (std::is_same<T, __nv_bfloat16>::value && D % 8 != 0) return (int)cudaErrorInvalidValue;
  const int cpb = caps_per_block(L);
  const int n_groups = (Nc + cpb - 1) / cpb;
  const long long n_items = (long long)n_groups * ((Ni + kImgs - 1) / kImgs);
  if (n_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n_items == 0) return (int)cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sgraf_eval_sgr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(n_items < n_ctas ? n_items : n_ctas);
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  sgraf_eval_sgr_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(cap), f(mask), static_cast<const T*>(img), f(gram),
      static_cast<const T*>(gloc), static_cast<const T*>(imgglo), f(wt), f(b), f(gwt), f(gb),
      f(mm), f(vv), f(wgt), f(bg), f(ew), f(eb), static_cast<float*>(out),
      static_cast<float*>(ws), Ni, Nc, L, D, S, steps, cpb, n_groups, (int)n_items);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cap (Nc, L, D), img (Ni, 36, D), gloc (Nc, D) and imgglo (Ni, D) all fp32
// or all bf16 (bf16 != 0; then D % 8 == 0 and cap, img 16-byte aligned);
// mask (Nc, L), gram (Ni, 36, 36), wt and gwt (D, S), b, gb, ew (S,), eb (1,),
// mm and wgt (steps, S, S), vv and bg (steps, S) fp32; out (Nc, Ni) fp32; ws
// an fp32 workspace of n_ctas x 2 x 320 x S, 16-byte aligned.  1 <= L <= 128;
// S % 4 == 0, S <= 256; steps >= 1; wt, gwt, mm and wgt 16-byte aligned.
// One launch of at most n_ctas blocks on `stream` of CUDA device `device`;
// returns cudaGetLastError().
int itrx_sgraf_eval_sgr(const void* cap, const void* mask, const void* img, const void* gram,
                        const void* gloc, const void* imgglo, const void* wt, const void* b,
                        const void* gwt, const void* gb, const void* mm, const void* vv,
                        const void* wgt, const void* bg, const void* ew, const void* eb,
                        void* out, void* ws, int Ni, int Nc, int L, int D, int S, int steps,
                        int bf16, int n_ctas, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return run<__nv_bfloat16>(cap, mask, img, gram, gloc, imgglo, wt, b, gwt, gb, mm, vv, wgt,
                              bg, ew, eb, out, ws, Ni, Nc, L, D, S, steps, n_ctas, s);
  }
  return run<float>(cap, mask, img, gram, gloc, imgglo, wt, b, gwt, gb, mm, vv, wgt, bg, ew,
                    eb, out, ws, Ni, Nc, L, D, S, steps, n_ctas, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
