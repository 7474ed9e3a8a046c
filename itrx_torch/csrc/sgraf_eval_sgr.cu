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
// What bounds it: the projection of the word nodes (D x S multiply-adds
// per valid word) and the reasoning products X M and ctx Wg (S x S each per
// node and full step), about equal at D 1024, S 256 and three steps; then the
// A and context products (36 x D per word) and the global node.  The
// projection, the global node and both reasoning products run on wgmma, the
// context on mma.sync, all as three-pass split-bf16 products with fp32
// accuracy kept (sgraf_nodes_mma.cuh); the A product as xattn_product.cuh
// has it; the edges and contexts (n x n x S per pair and step) stay on fp32
// FMAs, one warp per query row, four keys' dot products at a time.  What is
// left on an NVIDIA H100 80GB HBM3 (700 W): the operand formation, each
// 48-row tile's fixed costs (its first weight slab, its exit through shared
// memory) and the edges (PERF.md §6).
// Design: a persistent grid, one block per SM, each looping over the work
// items of the SAF kernel's tiling (a pair of images and a group of whole
// captions).  The block assembles and projects the item's nodes as
// sgraf_nodes_mma.cuh sets out and writes them, l2-normalized, to its own
// slice of a device-memory workspace (at most 320 rows x S, with one more
// buffer of the same size for X M + v and then ctx, about 0.66 MB a block at
// S 256, served mostly from L2; it does not grow with Nc x Ni).  A full step
// runs X M + v over all of the item's rows in balanced tiles of at most 64
// (the operand read from the workspace a slab ahead, M split by the wrapper),
// then the edges: as many pairs as fit are staged in shared memory, and each
// warp takes one query row, forming its edge row, the softmax and the
// context in one pass over the pair's keys (an online softmax), and writes
// ctx over the row's X M + v; then ctx Wg + bg with the same product, ReLU,
// over X.  The node-0 step runs the products on the item's global rows only
// (at most 64 pairs: one tile) and one warp per pair reads the keys from the
// workspace.  Every sum runs in a fixed order (no atomics), so a grid is the
// same on every run.
#include "sgraf_nodes.cuh"
#include "sgraf_nodes_mma.cuh"

namespace {

using namespace itrx_sgraf_mma;

// the edges' staging buffer lies over the tile region, the rings and past
// them: 134 rows at S 256
constexpr int kStageFloats = kTileRegion + kXFloats;
constexpr int kSmemBytes = (kStageFloats > kMmaFloats ? kStageFloats : kMmaFloats) * 4;
static_assert(kStageFloats / kMaxS >= kCols + 1, "one pair's nodes fit the staging buffer");

// y (a query row in device memory, S columns) <- sum_b softmax_b(y . key(b)) key(b)
// over the n keys, by one warp: lane l holds columns 4l .. 4l+3 and 128 + 4l ..
// 128 + 4l + 3; one pass over the keys with a running maximum, four keys'
// dot products at a time (their warp sums interleave), the softmax updates
// in key order.
template <typename Key>
__device__ __forceinline__ void attend(float* y, int n, int S, Key key) {
  constexpr int kB = 4;
  const int lane = threadIdx.x % 32;
  const int ca = 4 * lane, cb = 128 + 4 * lane;
  const bool lo = ca < S, hi = cb < S;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 y0 = lo ? *reinterpret_cast<const float4*>(y + ca) : zero;
  const float4 y1 = hi ? *reinterpret_cast<const float4*>(y + cb) : zero;
  float4 a0 = zero, a1 = zero;
  float m = -3.0e38f, l = 0.0f;
  for (int b0 = 0; b0 < n; b0 += kB) {
    float4 k0[kB], k1[kB];
    float e[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const float* kb = key(min(b0 + u, n - 1));
      k0[u] = lo ? *reinterpret_cast<const float4*>(kb + ca) : zero;
      k1[u] = hi ? *reinterpret_cast<const float4*>(kb + cb) : zero;
      e[u] = ((y0.x * k0[u].x + y0.y * k0[u].y) + (y0.z * k0[u].z + y0.w * k0[u].w)) +
             ((y1.x * k1[u].x + y1.y * k1[u].y) + (y1.z * k1[u].z + y1.w * k1[u].w));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kB; ++u) e[u] += __shfl_xor_sync(0xffffffffu, e[u], o);
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (b0 + u >= n) break;
      if (e[u] > m) {
        const float sc = expf(m - e[u]);
        l *= sc;
        a0.x *= sc; a0.y *= sc; a0.z *= sc; a0.w *= sc;
        a1.x *= sc; a1.y *= sc; a1.z *= sc; a1.w *= sc;
        m = e[u];
      }
      const float p = expf(e[u] - m);
      l += p;
      a0.x = fmaf(p, k0[u].x, a0.x); a0.y = fmaf(p, k0[u].y, a0.y);
      a0.z = fmaf(p, k0[u].z, a0.z); a0.w = fmaf(p, k0[u].w, a0.w);
      a1.x = fmaf(p, k1[u].x, a1.x); a1.y = fmaf(p, k1[u].y, a1.y);
      a1.z = fmaf(p, k1[u].z, a1.z); a1.w = fmaf(p, k1[u].w, a1.w);
    }
  }
  const float inv = 1.0f / l;
  if (lo) *reinterpret_cast<float4*>(y + ca) = make_float4(a0.x * inv, a0.y * inv, a0.z * inv,
                                                           a0.w * inv);
  if (hi) *reinterpret_cast<float4*>(y + cb) = make_float4(a1.x * inv, a1.y * inv, a1.z * inv,
                                                           a1.w * inv);
}

// src rows [r_begin, r_end) (S columns, device memory) . W, W split by the
// wrapper (S8 rows of Ks words, Ks = S rounded up to 32), in balanced tiles
// of at most 64 rows; epi(y, r, n) takes rows r .. r + n - 1 of the product
// out of shared memory (stride kLdY).
template <typename Epi>
__device__ __forceinline__ void rows_product(const Ring& rg, const float* src, int r_begin,
                                             int r_end, const uint32_t* __restrict__ wsplit,
                                             int S, int Ks, int S8, Epi epi) {
  Acc acc;
  const int step = tile_step(r_end - r_begin);
  for (int t0 = r_begin; t0 < r_end; t0 += step) {
    SrcRows prod{src, t0, min(step, r_end - t0), S};
    mma_tile(acc, rg, wsplit, Ks, S8, prod.nrows, prod);
    tile_out(acc, rg, prod.nrows, [&](const float* y, int n) { epi(y, t0, n); });
  }
}

// dst rows r .. r + n - 1 <- y + vec (ReLU'd when `relu`), a warp per row
__device__ __forceinline__ void store_rows(const float* y, float* dst,
                                           const float* __restrict__ vec, int r, int n, int S,
                                           bool relu) {
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x / 32; i < n; i += kThreads / 32) {
    for (int c = lane; c < S; c += 32) {
      const float v = y[i * kLdY + c] + ld_param(vec + c);
      dst[(size_t)(r + i) * S + c] = relu ? fmaxf(v, 0.0f) : v;
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
                      const uint32_t* __restrict__ wsplit,  // sim_tranloc_w, split
                      const float* __restrict__ bias,   // (S,)
                      const uint32_t* __restrict__ gsplit,  // sim_tranglo_w, split
                      const float* __restrict__ gbias,  // (S,)
                      const uint32_t* __restrict__ msplit,  // steps x M^T = (Wq^T Wk)^T, split
                      const float* __restrict__ vv,     // (steps, S) Wk^T bq
                      const uint32_t* __restrict__ gwsplit,  // steps x sim_graph_w, split
                      const float* __restrict__ bg,     // (steps, S)
                      const float* __restrict__ ew,     // (S,) sim_eval_w
                      const float* __restrict__ eb,     // (1,)
                      float* __restrict__ out,          // (Nc, Ni)
                      float* __restrict__ ws,           // (gridDim.x, 2, kMaxRows, S)
                      int Ni, int Nc, int L, int D, int Kp, int S, int S8, int steps, int cpb,
                      int n_groups, int n_items) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float cinv[kImgs * kCols];
  __shared__ int rows[kMaxRows];
  __shared__ int n_rows[2];
  // per pair: node count (0 for a pair past Ni or Nc), first word row, global row
  __shared__ int pair_n[kMaxPairs];
  __shared__ int pair_ls[kMaxPairs];
  __shared__ int pair_gs[kMaxPairs];
  // per staged row of the edges: its pair and node
  __shared__ int buf_pair[kMaxRows];
  __shared__ int buf_node[kMaxRows];
  const Nodes nd = node_smem(smem, cinv, rows, n_rows);
  const Ring rg = ring_smem(smem);
  float* const buf = smem;  // [rows][S] staged nodes, over the tile region and the rings

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int buf_rows = kStageFloats / S;
  const int Ks = (S + kSlab - 1) / kSlab * kSlab;  // the reasoning products' depth
  const size_t wstep = (size_t)S8 * Ks;
  float* const ws_x = ws + (size_t)blockIdx.x * 2 * kMaxRows * S;  // the nodes X
  float* const ws_y = ws_x + (size_t)kMaxRows * S;                 // X M + v, then ctx
  // the workspace row of node j of pair q
  const auto slot = [&](int q, int j) { return j == 0 ? pair_gs[q] : pair_ls[q] + j - 1; };

  init_weight_bars();
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
    project_mma(nd, rg, cap, img, gloc, imgglo, wsplit, bias, gsplit, gbias, i0, c0, Ni, L, D,
                Kp, S8, [&](const float* y, int r, int n, const float* bvec) {
      for (int i = warp; i < n; i += kThreads / 32) {
        float sq = 0.0f;
        for (int c = lane; c < S; c += 32) {
          const float v = y[i * kLdY + c] + ld_param(bvec + c);
          sq = fmaf(v, v, sq);
        }
        const float yinv = 1.0f / (sqrtf(fmaxf(warp_sum(sq), 1e-16f)) + kEps);
        for (int c = lane; c < S; c += 32) {
          ws_x[(size_t)(r + i) * S + c] = (y[i * kLdY + c] + ld_param(bvec + c)) * yinv;
        }
      }
    });

    for (int st = 0; st + 1 < steps; ++st) {
      const uint32_t* m_st = msplit + st * wstep;
      const uint32_t* g_st = gwsplit + st * wstep;
      rows_product(rg, ws_x, 0, n_all, m_st, S, Ks, S8, [&](const float* y, int r, int n) {
        store_rows(y, ws_y, vv + (size_t)st * S, r, n, S, false);
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
        __syncthreads();  // also: the product's readers of the rings are done
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
      rows_product(rg, ws_y, 0, n_all, g_st, S, Ks, S8, [&](const float* y, int r, int n) {
        store_rows(y, ws_x, bg + (size_t)st * S, r, n, S, true);
      });
    }

    // the node-0 step on the global rows (one tile), then the epilogue
    const int last = steps - 1;
    rows_product(rg, ws_x, n_loc, n_all, msplit + last * wstep, S, Ks, S8,
                 [&](const float* y, int r, int n) {
      store_rows(y, ws_y, vv + (size_t)last * S, r, n, S, false);
    });
    __syncthreads();
    for (int q = warp; q < kMaxPairs; q += kThreads / 32) {
      if (pair_n[q] == 0) continue;
      attend(ws_y + (size_t)pair_gs[q] * S, pair_n[q], S,
             [&](int b) { return ws_x + (size_t)slot(q, b) * S; });
    }
    const float* bl = bg + (size_t)last * S;
    rows_product(rg, ws_y, n_loc, n_all, gwsplit + last * wstep, S, Ks, S8,
                 [&](const float* y, int r, int n) {
      for (int i = warp; i < n; i += kThreads / 32) {
        float z = 0.0f;
        for (int c = lane; c < S; c += 32) {
          z = fmaf(fmaxf(y[i * kLdY + c] + ld_param(bl + c), 0.0f), ld_param(ew + c), z);
        }
        z = warp_sum(z);
        if (lane == 0) {
          const int q = rows[r + i] - kImgs * kCols;
          out[(size_t)(c0 + q % kMaxCaps) * Ni + i0 + q / kMaxCaps] =
              1.0f / (1.0f + expf(-(z + eb[0])));
        }
      }
    });
    __syncthreads();  // the next item rewrites the shared state
  }
}

template <typename T>
int run(const void* cap, const void* mask, const void* img, const void* gram, const void* gloc,
        const void* imgglo, const void* wsplit, const void* b, const void* gsplit, const void* gb,
        const void* msplit, const void* vv, const void* gwsplit, const void* bg, const void* ew,
        const void* eb, void* out, void* ws, int Ni, int Nc, int L, int D, int S, int steps,
        int n_ctas, cudaStream_t stream) {
  if (L < 1 || L > kCols || S < 4 || S > kMaxS || S % 4 != 0 || D < 1 || steps < 1 ||
      n_ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (std::is_same<T, __nv_bfloat16>::value && D % 8 != 0) return (int)cudaErrorInvalidValue;
  const int Kp = (D + kSlab - 1) / kSlab * kSlab, S8 = (S + 7) / 8 * 8;
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
  const auto u = [](const void* v) { return static_cast<const uint32_t*>(v); };
  sgraf_eval_sgr_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(cap), f(mask), static_cast<const T*>(img), f(gram),
      static_cast<const T*>(gloc), static_cast<const T*>(imgglo), u(wsplit), f(b), u(gsplit),
      f(gb), u(msplit), f(vv), u(gwsplit), f(bg), f(ew), f(eb), static_cast<float*>(out),
      static_cast<float*>(ws), Ni, Nc, L, D, Kp, S, S8, steps, cpb, n_groups, (int)n_items);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cap (Nc, L, D), img (Ni, 36, D), gloc (Nc, D) and imgglo (Ni, D) all fp32
// or all bf16 (bf16 != 0; then D % 8 == 0 and cap, img 16-byte aligned);
// mask (Nc, L), gram (Ni, 36, 36), b, gb, ew (S,), eb (1,), vv and bg
// (steps, S) fp32; wsplit and gsplit the projections split as
// sgraf_eval_saf.cu takes them; msplit and gwsplit the steps' products split
// the same way, per step S8 rows of Ks words (Ks = S rounded up to 32), of
// M^T and of sim_graph_w as torch stores it; out (Nc, Ni) fp32; ws an fp32 workspace of n_ctas x 2
// x 320 x S, 16-byte aligned.  1 <= L <= 128; S % 4 == 0, S <= 256;
// steps >= 1.
// One launch of at most n_ctas blocks on `stream` of CUDA device `device`;
// returns cudaGetLastError().
int itrx_sgraf_eval_sgr(const void* cap, const void* mask, const void* img, const void* gram,
                        const void* gloc, const void* imgglo, const void* wsplit, const void* b,
                        const void* gsplit, const void* gb, const void* msplit, const void* vv,
                        const void* gwsplit, const void* bg, const void* ew, const void* eb,
                        void* out, void* ws, int Ni, int Nc, int L, int D, int S, int steps,
                        int bf16, int n_ctas, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return run<__nv_bfloat16>(cap, mask, img, gram, gloc, imgglo, wsplit, b, gsplit, gb, msplit,
                              vv, gwsplit, bg, ew, eb, out, ws, Ni, Nc, L, D, S, steps, n_ctas,
                              s);
  }
  return run<float>(cap, mask, img, gram, gloc, imgglo, wsplit, b, gsplit, gb, msplit, vv,
                    gwsplit, bg, ew, eb, out, ws, Ni, Nc, L, D, S, steps, n_ctas, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
