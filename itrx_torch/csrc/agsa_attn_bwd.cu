// CAMERA's AGSA gated attention, the backward, for sm_90a.
//
// Replaces itrx/ops/pallas/agsa_attn.py::_bwd_kernel.  Per (batch row, head),
// on the head's q, k, v rows (N x d_k) and the output's cotangent go, it
// recomputes the forward (csrc/agsa_attn.cu: gq, gk, gg = rnd(gq * gk),
// m1, m2, qm, km, p) from q, k and v, nothing being saved, then
//   g_v  = rnd(p)^T go                     g_p = go v^T
//   g_s  = p * (g_p - rowsum(g_p * p))     gsb = rnd(g_s)
//   g_qm = gsb km                          g_km = gsb^T qm
//   g_z1 = (g_qm q inv) m1 (1 - m1)        g_q  = g_qm m1 inv
//   g_z2 = (g_km k) m2 (1 - m2)            g_k  = g_km m2
//   g_gg = rnd(g_z1) Wg1 + rnd(g_z2) Wg2   g_gq = g_gg gk,  g_gk = g_gg gq
//   dq = rnd(g_q + rnd(g_gq) Wq),  dk = rnd(g_k + rnd(g_gk) Wk),  dv = rnd(g_v)
// and the weight cotangents over every (batch row, position, head) row,
// torch's (out, in) layout: dWq = rnd(g_gq)^T q, dWk = rnd(g_gk)^T k,
// dWg1 = rnd(g_z1)^T gg, dWg2 = rnd(g_z2)^T gg, and the biases the column
// sums of the unrounded g_gq, g_gk, g_z1, g_z2.  rnd rounds to the inputs'
// type T (the identity for fp32), where the TPU kernel casts (:115-156);
// every sum is fp32.
//
// What bounds it here: at CAMERA's image tower (B 128, 64 heads, N 36, d_k
// 32) the forward recomputed up to the scores and the adjoints are
// 24 N d_k^2 + 10 N^2 d_k operations a head, 10.6 GFLOP, against q, k, v, go
// read once and dq, dk, dv written once (264 MB fp32, 132 MB bf16): in fp32
// the operations bound it (0.16 ms at the fp32 peak), in bf16 the bytes
// (0.04 ms).
//
// Design: three launches, so that the largest shape the forward takes (N 64,
// d_k 128, fp32) fits one block's shared memory in each.
//  1. attention (one block per batch row and group of G heads, the forward's
//     layout): the forward kernel's steps 1-4 give qm and km in shared
//     memory; v and go replace the gate weights; one warp a query row gives
//     p and g_s (kept as rnd(p), rnd(g_s) rows, N x N a head) and g_qm; then
//     one warp a key row gives g_v (written as dv) and g_km.  g_qm and g_km go
//     to an fp32 workspace in q's layout.
//  2. gates (a persistent grid of P blocks over tiles of TR rows of the
//     flattened (B N h, d_k) matrices): it recomputes gq, gk, gg, m1, m2 of
//     its rows, runs the gate adjoints, writes dq and dk, and adds the tile's
//     weight and bias sums (4 d_k^2 + 4 d_k floats) to its block's own slot of
//     the partials, tile after tile in a fixed order: no atomics.  The
//     weights are staged two at a time, padded to d_k + 1 so that both the
//     row-wise products (x W^T) and the column-wise ones (g W) read distinct
//     banks.
//  3. reduce: each output sums the P slots in order, so two calls give the
//     same bits.
// fp32 FMAs throughout (no tensor cores): simple first.
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
constexpr int kMaxTileRows = 64;
constexpr int kMinTileRows = 16;

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// floats of shared memory the attention pass uses for a group of g heads:
// the biases, a region that holds two transposed weights and later go, rnd(p)
// and rnd(g_s), then q (-> qm), k (-> km) and gg (-> v)
__host__ __device__ inline size_t attn_smem_floats(int g, int n, int dk) {
  const size_t rows = (size_t)g * n * (dk + 1);
  const size_t w = 2 * (size_t)dk * dk;
  const size_t later = rows + 2 * (size_t)g * n * n;
  return 4 * (size_t)dk + (w > later ? w : later) + 3 * rows;
}

// floats of shared memory the gate pass uses for tiles of tr rows: the
// biases, two padded weights and nine tr x (dk + 1) arrays
__host__ __device__ inline size_t gate_smem_floats(int tr, int dk) {
  return 4 * (size_t)dk + 2 * (size_t)dk * (dk + 1) + 9 * (size_t)tr * (dk + 1);
}

// Two (dk, dk) weights in torch's (out, in) layout -> shared memory
// transposed with rows of ldw floats, wt[e * ldw + c] = W[c][e].
template <typename T>
__device__ void stage_weights(const T* __restrict__ wa, const T* __restrict__ wb, float* ta,
                              float* tb, int dk, int ldw) {
  for (int idx = threadIdx.x; idx < dk * dk; idx += kThreads) {
    const int c = idx / dk, e = idx % dk;
    ta[e * ldw + c] = to_f(wa[idx]);
    tb[e * ldw + c] = to_f(wb[idx]);
  }
}

__device__ void stage_biases(const float* __restrict__ bq, const float* __restrict__ bk,
                             const float* __restrict__ bg1, const float* __restrict__ bg2,
                             float* bias, int dk) {
  for (int c = threadIdx.x; c < dk; c += kThreads) {
    bias[c] = bq[c];
    bias[dk + c] = bk[c];
    bias[2 * dk + c] = bg1[c];
    bias[3 * dk + c] = bg2[c];
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

// ---- 1. the attention adjoints -------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
agsa_bwd_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ go, const T* __restrict__ wq,
                     const float* __restrict__ bq, const T* __restrict__ wk,
                     const float* __restrict__ bk, const T* __restrict__ wg1,
                     const float* __restrict__ bg1, const T* __restrict__ wg2,
                     const float* __restrict__ bg2, T* __restrict__ dv,
                     float* __restrict__ gqm, float* __restrict__ gkm, int N, int H, int dk,
                     int G, float inv) {
  extern __shared__ __align__(16) float smem[];
  const int ld = dk + 1;
  const size_t rows_f = (size_t)G * N * ld;
  const size_t w_f = 2 * (size_t)dk * dk, later_f = rows_f + 2 * (size_t)G * N * N;
  float* bias = smem;            // bq, bk, bg1, bg2
  float* w0 = bias + 4 * dk;     // dk x dk, transposed
  float* w1 = w0 + dk * dk;
  float* gos = w0;               // after the gates: go rows (G x N x ld)
  float* pp = gos + rows_f;      // rnd(p), G x N x N (query-major)
  float* gs = pp + G * N * N;    // rnd(g_s), likewise
  float* qs = w0 + (w_f > later_f ? w_f : later_f);  // q, then qm
  float* ks = qs + rows_f;       // k, then km
  float* xs = ks + rows_f;       // gg, then v

  const int n_groups = (H + G - 1) / G;
  const int b = blockIdx.x / n_groups;
  const int h0 = (blockIdx.x % n_groups) * G;
  const int gn = min(G, H - h0);
  const int row = H * dk;
  const int width = gn * dk;
  const size_t base = (size_t)b * N * row + (size_t)h0 * dk;
  const int tid = threadIdx.x;
  const int n_out = gn * N * dk;

  // the forward's steps 1-4: qm and km in place of q and k
  stage_weights(wq, wk, w0, w1, dk, dk);
  stage_biases(bq, bk, bg1, bg2, bias, dk);
  stage_rows(q, qs, base, N, row, width, dk, ld);
  stage_rows(k, ks, base, N, row, width, dk, ld);
  __syncthreads();
  for (int idx = tid; idx < n_out; idx += kThreads) {
    const int c = idx % dk, r = idx / dk;
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
  stage_weights(wg1, wg2, w0, w1, dk, dk);
  __syncthreads();
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

  // v over gg, go over the weights
  stage_rows(v, xs, base, N, row, width, dk, ld);
  stage_rows(go, gos, base, N, row, width, dk, ld);
  __syncthreads();

  // 2. one warp a query row: the scores (keys lane and lane + 32), p, g_p, g_s;
  //    rnd(p) and rnd(g_s) kept, then g_qm = rnd(g_s) km, columns lane + 32 t
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < gn * N; r += kWarps) {
    const int g = r / N, i = r % N;
    const float* qr = qs + r * ld;
    const float* gr = gos + r * ld;
    const float* kb = ks + g * N * ld;
    const float* vb = xs + g * N * ld;
    float s0 = -INFINITY, s1 = -INFINITY, gp0 = 0.0f, gp1 = 0.0f;
    if (lane < N) {
      float a = 0.0f, c = 0.0f;
      for (int e = 0; e < dk; ++e) {
        a = fmaf(qr[e], kb[lane * ld + e], a);
        c = fmaf(gr[e], vb[lane * ld + e], c);
      }
      s0 = a;
      gp0 = c;
    }
    if (lane + 32 < N) {
      float a = 0.0f, c = 0.0f;
      for (int e = 0; e < dk; ++e) {
        a = fmaf(qr[e], kb[(lane + 32) * ld + e], a);
        c = fmaf(gr[e], vb[(lane + 32) * ld + e], c);
      }
      s1 = a;
      gp1 = c;
    }
    float mx = fmaxf(s0, s1);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float e0 = lane < N ? expf(s0 - mx) : 0.0f;
    const float e1 = lane + 32 < N ? expf(s1 - mx) : 0.0f;
    const float sum = warp_sum(e0 + e1);
    const float p0 = e0 / sum, p1 = e1 / sum;
    const float dot = warp_sum(gp0 * p0 + gp1 * p1);
    const float gs0 = rnd<T>(p0 * (gp0 - dot)), gs1 = rnd<T>(p1 * (gp1 - dot));
    float* pr = pp + (size_t)r * N;
    float* sr = gs + (size_t)r * N;
    if (lane < N) {
      pr[lane] = rnd<T>(p0);
      sr[lane] = gs0;
    }
    if (lane + 32 < N) {
      pr[lane + 32] = rnd<T>(p1);
      sr[lane + 32] = gs1;
    }
    float acc[kMaxDk / 32];
#pragma unroll
    for (int t = 0; t < kMaxDk / 32; ++t) acc[t] = 0.0f;
    for (int j = 0; j < N; ++j) {
      const float sj = __shfl_sync(0xffffffffu, j < 32 ? gs0 : gs1, j & 31);
      const float* kr = kb + j * ld;
#pragma unroll
      for (int t = 0; t < kMaxDk / 32; ++t) {
        const int c = lane + 32 * t;
        if (c < dk) acc[t] = fmaf(sj, kr[c], acc[t]);
      }
    }
    float* o = gqm + base + (size_t)i * row + g * dk;
#pragma unroll
    for (int t = 0; t < kMaxDk / 32; ++t) {
      const int c = lane + 32 * t;
      if (c < dk) o[c] = acc[t];
    }
  }
  __syncthreads();

  // 3. one warp a key row j: g_v = sum_i rnd(p)[i][j] go_i (written as dv),
  //    g_km = sum_i rnd(g_s)[i][j] qm_i
  for (int r = warp; r < gn * N; r += kWarps) {
    const int g = r / N, j = r % N;
    float av[kMaxDk / 32], ak[kMaxDk / 32];
#pragma unroll
    for (int t = 0; t < kMaxDk / 32; ++t) av[t] = ak[t] = 0.0f;
    for (int i = 0; i < N; ++i) {
      const int ri = g * N + i;
      const float pij = pp[(size_t)ri * N + j], sij = gs[(size_t)ri * N + j];
      const float* gr = gos + ri * ld;
      const float* qr = qs + ri * ld;
#pragma unroll
      for (int t = 0; t < kMaxDk / 32; ++t) {
        const int c = lane + 32 * t;
        if (c < dk) {
          av[t] = fmaf(pij, gr[c], av[t]);
          ak[t] = fmaf(sij, qr[c], ak[t]);
        }
      }
    }
    const size_t off = base + (size_t)j * row + g * dk;
#pragma unroll
    for (int t = 0; t < kMaxDk / 32; ++t) {
      const int c = lane + 32 * t;
      if (c < dk) {
        dv[off + c] = from_f<T>(av[t]);
        gkm[off + c] = ak[t];
      }
    }
  }
}

// ---- 2. the gate adjoints and the weight sums ----------------------------

// slot_w[c * dk + e] (+)= sum_r rnd(g[r][c]) x[r][e] and slot_b[c] (+)= sum_r
// g[r][c] over the tile's tr rows; each element has one owning thread, the
// same in every tile
template <typename T>
__device__ void add_sums(float* __restrict__ slot_w, float* __restrict__ slot_b,
                         const float* g, const float* x, int tr, int dk, int ld, bool first) {
  for (int idx = threadIdx.x; idx < dk * dk; idx += kThreads) {
    const int c = idx / dk, e = idx % dk;
    float acc = 0.0f;
    for (int r = 0; r < tr; ++r) acc = fmaf(rnd<T>(g[r * ld + c]), x[r * ld + e], acc);
    slot_w[idx] = first ? acc : slot_w[idx] + acc;
  }
  for (int c = threadIdx.x; c < dk; c += kThreads) {
    float acc = 0.0f;
    for (int r = 0; r < tr; ++r) acc += g[r * ld + c];
    slot_b[c] = first ? acc : slot_b[c] + acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
agsa_bwd_gate_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const float* __restrict__ gqm, const float* __restrict__ gkm,
                     const T* __restrict__ wq, const float* __restrict__ bq,
                     const T* __restrict__ wk, const float* __restrict__ bk,
                     const T* __restrict__ wg1, const float* __restrict__ bg1,
                     const T* __restrict__ wg2, const float* __restrict__ bg2,
                     T* __restrict__ dq, T* __restrict__ dk_out, float* __restrict__ part,
                     long long R, int dk, int TR, float inv) {
  extern __shared__ __align__(16) float smem[];
  const int ld = dk + 1;
  const size_t tile_f = (size_t)TR * ld;
  float* bias = smem;
  float* wa = bias + 4 * dk;         // dk x ld, transposed: wa[e * ld + c] = W[c][e]
  float* wb = wa + dk * ld;
  float* qs = wb + dk * ld;          // q
  float* ks = qs + tile_f;           // k
  float* gqs = ks + tile_f;          // gq, then g_gq
  float* gks = gqs + tile_f;         // gk, then g_gk
  float* ggs = gks + tile_f;         // rnd(gg)
  float* aq = ggs + tile_f;          // g_qm, then g_q's first term
  float* ak = aq + tile_f;           // g_km, then g_k's first term
  float* z1s = ak + tile_f;          // g_z1
  float* z2s = z1s + tile_f;         // g_z2
  const int sq = dk * dk;
  float* slot = part + (size_t)blockIdx.x * (4 * sq + 4 * dk);
  const long long n_tiles = (R + TR - 1) / TR;
  const int tid = threadIdx.x;

  stage_biases(bq, bk, bg1, bg2, bias, dk);
  bool first = true;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const long long r0 = tile * TR;
    const int tr = (int)(R - r0 < TR ? R - r0 : TR);
    const int n_el = tr * dk;
    __syncthreads();  // the previous tile is done with the weights and rows
    stage_weights(wq, wk, wa, wb, dk, ld);
    for (int idx = tid; idx < n_el; idx += kThreads) {
      const int r = idx / dk, c = idx % dk;
      const size_t off = (size_t)(r0 + r) * dk + c;
      qs[r * ld + c] = to_f(q[off]);
      ks[r * ld + c] = to_f(k[off]);
      aq[r * ld + c] = gqm[off];
      ak[r * ld + c] = gkm[off];
    }
    __syncthreads();

    // gq, gk and rnd(gg)
    for (int idx = tid; idx < n_el; idx += kThreads) {
      const int r = idx / dk, c = idx % dk;
      const float* qr = qs + r * ld;
      const float* kr = ks + r * ld;
      float a = 0.0f, bb = 0.0f;
      for (int e = 0; e < dk; ++e) {
        a = fmaf(qr[e], wa[e * ld + c], a);
        bb = fmaf(kr[e], wb[e * ld + c], bb);
      }
      const float gq = a + bias[c], gk = bb + bias[dk + c];
      gqs[r * ld + c] = gq;
      gks[r * ld + c] = gk;
      ggs[r * ld + c] = rnd<T>(gq * gk);
    }
    __syncthreads();
    stage_weights(wg1, wg2, wa, wb, dk, ld);
    __syncthreads();

    // the gates, g_q's and g_k's first terms, g_z1 and g_z2
    for (int idx = tid; idx < n_el; idx += kThreads) {
      const int r = idx / dk, c = idx % dk, o = r * ld + c;
      const float* xr = ggs + r * ld;
      float z1 = 0.0f, z2 = 0.0f;
      for (int e = 0; e < dk; ++e) {
        z1 = fmaf(xr[e], wa[e * ld + c], z1);
        z2 = fmaf(xr[e], wb[e * ld + c], z2);
      }
      const float m1 = sigmoid_f(z1 + bias[2 * dk + c]);
      const float m2 = sigmoid_f(z2 + bias[3 * dk + c]);
      const float g_qm = aq[o], g_km = ak[o];
      aq[o] = g_qm * m1 * inv;
      ak[o] = g_km * m2;
      z1s[o] = g_qm * qs[o] * inv * m1 * (1.0f - m1);
      z2s[o] = g_km * ks[o] * m2 * (1.0f - m2);
    }
    __syncthreads();

    // fc_g's sums, and g_gg -> g_gq, g_gk in place of gq, gk
    add_sums<T>(slot + 2 * sq, slot + 4 * sq + 2 * dk, z1s, ggs, tr, dk, ld, first);
    add_sums<T>(slot + 3 * sq, slot + 4 * sq + 3 * dk, z2s, ggs, tr, dk, ld, first);
    for (int idx = tid; idx < n_el; idx += kThreads) {
      const int r = idx / dk, e = idx % dk, o = r * ld + e;
      const float* z1r = z1s + r * ld;
      const float* z2r = z2s + r * ld;
      float a1 = 0.0f, a2 = 0.0f;
      for (int c = 0; c < dk; ++c) {
        a1 = fmaf(rnd<T>(z1r[c]), wa[e * ld + c], a1);
        a2 = fmaf(rnd<T>(z2r[c]), wb[e * ld + c], a2);
      }
      const float g_gg = a1 + a2, gq = gqs[o], gk = gks[o];
      gqs[o] = g_gg * gk;
      gks[o] = g_gg * gq;
    }
    __syncthreads();
    stage_weights(wq, wk, wa, wb, dk, ld);
    __syncthreads();

    // fc_q's and fc_k's sums; dq, dk
    add_sums<T>(slot, slot + 4 * sq, gqs, qs, tr, dk, ld, first);
    add_sums<T>(slot + sq, slot + 4 * sq + dk, gks, ks, tr, dk, ld, first);
    for (int idx = tid; idx < n_el; idx += kThreads) {
      const int r = idx / dk, e = idx % dk, o = r * ld + e;
      const float* gqr = gqs + r * ld;
      const float* gkr = gks + r * ld;
      float a = 0.0f, bb = 0.0f;
      for (int c = 0; c < dk; ++c) {
        a = fmaf(rnd<T>(gqr[c]), wa[e * ld + c], a);
        bb = fmaf(rnd<T>(gkr[c]), wb[e * ld + c], bb);
      }
      const size_t off = (size_t)(r0 + r) * dk + e;
      dq[off] = from_f<T>(aq[o] + a);
      dk_out[off] = from_f<T>(ak[o] + bb);
    }
  }
}

// ---- 3. the ordered sum of the partials ----------------------------------

__global__ void agsa_bwd_reduce(const float* __restrict__ part, float* __restrict__ dw,
                                int n_out, int parts) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  float sum = 0.0f;
  for (int z = 0; z < parts; ++z) sum += part[(size_t)z * n_out + idx];
  dw[idx] = sum;
}

// rows a tile of the gate pass: as many as keep a block near kSmemTarget, at
// least kMinTileRows (within kSmemMax), at most kMaxTileRows
int tile_rows(int dk) {
  int tr = kMaxTileRows;
  while (tr > kMinTileRows && gate_smem_floats(tr, dk) * sizeof(float) > (size_t)kSmemTarget) {
    --tr;
  }
  while (tr > 1 && gate_smem_floats(tr, dk) * sizeof(float) > (size_t)kSmemMax) --tr;
  return tr;
}

// blocks of the gate pass (= slots of partials): one wave of resident
// blocks, at most one a tile and at most `slots`; < 0 is minus a CUDA error
template <typename T>
int gate_parts(long long rows, int dk, int slots, int device) {
  const int tr = tile_rows(dk);
  const size_t smem = gate_smem_floats(tr, dk) * sizeof(float);
  if (smem > (size_t)kSmemMax) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      agsa_bwd_gate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, agsa_bwd_gate_kernel<T>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  const long long tiles = (rows + tr - 1) / tr;
  long long parts = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (tiles < parts) parts = tiles;
  return (int)(slots < parts ? slots : parts);
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* go, const void* wq,
        const void* bq, const void* wk, const void* bk, const void* wg1, const void* bg1,
        const void* wg2, const void* bg2, void* dq, void* dk_out, void* dv, float* dw,
        float* gqm, float* gkm, float* part, int B, int N, int H, int dk, int slots,
        int device, cudaStream_t stream) {
  const auto ct = [](const void* p) { return static_cast<const T*>(p); };
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const float inv = (float)(1.0 / std::sqrt((double)dk));
  const long long rows = (long long)B * N * H;
  const int parts = gate_parts<T>(rows, dk, slots, device);
  if (parts < 1) return parts < 0 ? -parts : (int)cudaErrorInvalidValue;

  // 1. heads a block: as many as keep it near kSmemTarget, at least one
  int G = 1;
  while (G < H && attn_smem_floats(G + 1, N, dk) * sizeof(float) <= (size_t)kSmemTarget) ++G;
  const size_t smem1 = attn_smem_floats(G, N, dk) * sizeof(float);
  if (smem1 > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const long long n_blocks = (long long)B * ((H + G - 1) / G);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      agsa_bwd_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  agsa_bwd_attn_kernel<T><<<(unsigned)n_blocks, kThreads, smem1, stream>>>(
      ct(q), ct(k), ct(v), ct(go), ct(wq), cf(bq), ct(wk), cf(bk), ct(wg1), cf(bg1), ct(wg2),
      cf(bg2), static_cast<T*>(dv), gqm, gkm, N, H, dk, G, inv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 2. (gate_parts set the gate kernel's shared-memory attribute)
  const int tr = tile_rows(dk);
  const size_t smem2 = gate_smem_floats(tr, dk) * sizeof(float);
  agsa_bwd_gate_kernel<T><<<(unsigned)parts, kThreads, smem2, stream>>>(
      ct(q), ct(k), gqm, gkm, ct(wq), cf(bq), ct(wk), cf(bk), ct(wg1), cf(bg1), ct(wg2),
      cf(bg2), static_cast<T*>(dq), static_cast<T*>(dk_out), part, rows, dk, tr, inv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 3.
  const int n_out = 4 * dk * dk + 4 * dk;
  agsa_bwd_reduce<<<(n_out + 255) / 256, 256, 0, stream>>>(part, dw, n_out, parts);
  return (int)cudaGetLastError();
}

bool valid(int B, int N, int H, int dk) {
  return B >= 1 && H >= 1 && N >= 1 && N <= kMaxN && dk >= 8 && dk <= kMaxDk && dk % 8 == 0;
}

}  // namespace

extern "C" {

// The backward of itrx_agsa_fwd.  q, k, v, go (the output's cotangent) and
// dq, dk, dv (B, N, H dk) and the weights wq, wk, wg1, wg2 (dk, dk), torch's
// (out, in) layout, all fp32 or all bf16 (bf16 != 0); the biases bq, bk, bg1,
// bg2 (dk) fp32; contiguous.  dw (4 dk^2 + 4 dk) fp32 out: dWq, dWk, dWg1,
// dWg2 (dk, dk), then dbq, dbk, dbg1, dbg2.  Workspaces, fp32: gqm and gkm of
// B x N x H dk, part of slots x (4 dk^2 + 4 dk); the gate pass runs one block
// a slot, as many as are resident at once, so `slots` >= the SMs x 8 (the
// most 256-thread blocks an SM holds) never limits it.  1 <= N <= 64,
// 8 <= dk <= 128, dk % 8 == 0.  Three
// launches on `stream` of CUDA device `device`; returns the first CUDA error
// (cudaGetLastError()) or 0.
int itrx_agsa_bwd(const void* q, const void* k, const void* v, const void* go, const void* wq,
                  const void* bq, const void* wk, const void* bk, const void* wg1,
                  const void* bg1, const void* wg2, const void* bg2, void* dq, void* dk_out,
                  void* dv, void* dw, void* gqm, void* gkm, void* part, int B, int N, int H,
                  int dk, int slots, int bf16, int device, void* stream) {
  if (!valid(B, N, H, dk) || slots < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  if (bf16) {
    return run<__nv_bfloat16>(q, k, v, go, wq, bq, wk, bk, wg1, bg1, wg2, bg2, dq, dk_out, dv,
                              f(dw), f(gqm), f(gkm), f(part), B, N, H, dk, slots, device, s);
  }
  return run<float>(q, k, v, go, wq, bq, wk, bk, wg1, bg1, wg2, bg2, dq, dk_out, dv, f(dw),
                    f(gqm), f(gkm), f(part), B, N, H, dk, slots, device, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
