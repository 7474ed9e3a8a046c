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
// fp32, the mode of every CAMERA training step, runs on the tensor cores;
// bf16 keeps the PR 12 design (three launches of fp32 FMAs, summed as
// cuBLAS's fp32 products sum, with an fp32 g_qm / g_km workspace), as the
// forward (csrc/agsa_attn.cu) keeps its PR 11 design in both dtypes.  Their
// checks on the card presume sums in the plain version's order: a bf16
// output is held to agsa_attention_plain within 2^-8 of the output's scale,
// and one rounded a bf16 step apart is 2^-8 / max|out| of scale when it is
// among the largest (max|out| ~0.9 at CAMERA's shapes), which tensor-core
// sums, even exact ones, put a few of 9.4 M outputs at in a third of random
// draws; and CAMERA's training witness holds the card's step with these
// kernels to the same step with the plain pair within 1e-4 of each
// gradient's scale, which a forward ~1e-6 off the plain one misses (ReLU
// decisions after it flip; 3.3e-3 on a summarization conv).  The fp32
// backward's output feeds no ReLU decision of its step (PERF.md, PR 22).
//
// What bounds the fp32 kernels here: at CAMERA's image tower (B 128, 64
// heads, N 36, d_k 32) the bytes: q, k, v, go read once and dq, dk, dv
// written once, 264 MB (79 us), against 10.6 GFLOP of products (24 N d_k^2 +
// 10 N^2 d_k a head; 21 us at the TF32 peak).
//
// fp32 design (the products and layouts in csrc/agsa_tile.cuh): two
// launches.
//  1. One pass over the heads: a persistent grid of blocks of ceil(N / 16)
//     warps, one head at a time a block, its q, k, v and go rows staged by
//     16-byte cp.async (the next head's during this one where two stages fit
//     as many blocks an SM as one).  Warp w owns rows 16w .. 16w + 15, as
//     query rows and as key rows:
//     a. the gate chain in registers, qm and km back over its q and k rows;
//     b. its query rows: the scores and softmax, g_p = go v^T, g_s, rnd(p)
//        and gsb to shared memory, g_qm = gsb km kept in registers;
//     c. its key rows: g_v = rnd(p)^T go (written as dv) and g_km = gsb^T qm,
//        in registers;
//     d. its rows again: q and k re-read from global memory (L2), the gate
//        chain recomputed, the gate adjoints in the accumulator layout, dq
//        and dk written; rnd(g_gq), rnd(g_gk), rnd(g_z1), rnd(g_z2), gg, q
//        and k staged over the head's dead arrays, the bias sums of its rows;
//     e. the block's weight sums: the four (d_k x rows) (rows x d_k)
//        products of the head on the tensor cores (the staged arrays read
//        transposed from shared memory), added into the block's own slot of
//        partials, each element by one owning thread, head after head in a
//        fixed order: no atomics.  The slot lives in shared memory for d_k <=
//        32 and is written out at the end; past that in its slot of `part`.
//     No g_qm / g_km workspace: both stay in registers from (b) and (c) to
//     (d).  Five barriers a head.
//  2. reduce: each output sums the slots in order, so two calls give the
//     same bits.
// Every product is three TF32 passes.
//
// ITRX_AGSA_BWD_CUT (tools/agsa_phases.py; wrong results by design): 1
// stops each fp32 head after (a), 2 after (c), each writing what it has, 3
// after (d).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "agsa_tile.cuh"

namespace {

using namespace agsa;

template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* go;
  Gates<T> w;
  T* dq;
  T* dk_out;
  T* dv;
  float* part;
  int B, N, H, dk, stages;
  float inv;
};

// the weight sums read q and k from shared memory (staged again in (d)) up
// to this width; past it from global memory (L2), which keeps the block of
// the widest class within shared memory
template <int DK>
__host__ __device__ constexpr bool stage_qk() { return DK <= 32; }

// the weight sums' slot (4 dk^2 + 4 dk floats) fits shared memory
template <int DK>
__host__ __device__ constexpr bool slot_in_smem() { return DK <= 32; }

// shared bytes of a block of `tiles` warps: the weight fragments, the stages
// (q, k, v, go), the scores region (rnd(p) and gsb, later gg, q and k), the
// bias partials, the slot
template <typename T, int DK>
size_t bwd_smem(int tiles, int stages, int dk) {
  const size_t frags = frags_in_smem<DK>()
      ? 4 * (size_t)frags_per_weight<T, DK>() * sizeof(typename Packed<T>::type) : 0;
  const size_t rows = 16 * (size_t)tiles;
  const size_t arr = rows * row_ld<T, DK>();
  const size_t sc = 2 * rows * score_ld<T>((int)rows);
  const size_t qk = stage_qk<DK>() ? 3 * arr : arr;
  const size_t region = sc > qk ? sc : qk;
  size_t bytes = frags + ((size_t)stages * 4 * arr + region) * sizeof(T);
  bytes += (size_t)tiles * 4 * DK * sizeof(float);
  if (slot_in_smem<DK>()) bytes += (4 * (size_t)dk * dk + 4 * (size_t)dk) * sizeof(float);
  return bytes;
}

// column sums of a tile's 16 rows, added to out[0 .. dk) by the lanes of row
// group 0 (every lane takes part in the shuffles)
template <int NT>
__device__ __forceinline__ void column_sums(const float (&x)[NT][4], float* out, int dk) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
AGSA_UNROLL_COLS
  for (int n = 0; n < NT; ++n) {
    float s0 = x[n][0] + x[n][2], s1 = x[n][1] + x[n][3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    const int c = 8 * n + 2 * t;
    if (g == 0 && c < dk) out[c] = s0, out[c + 1] = s1;
  }
}

// q, k, v and go of head `item` into s, s + arr, s + 2 arr, s + 3 arr: one
// commit group
template <typename T, int DK>
__device__ __forceinline__ void stage_head(const T* q, const T* k, const T* v, const T* go,
                                           int n, int h, int dk, T* s, size_t arr,
                                           long long item, int rows) {
  const size_t stride = (size_t)h * dk, base = head_base(item, n, h, dk);
  stage_rows<T, DK>(s, q, base, stride, n, rows, dk);
  stage_rows<T, DK>(s + arr, k, base, stride, n, rows, dk);
  stage_rows<T, DK>(s + 2 * arr, v, base, stride, n, rows, dk);
  stage_rows<T, DK>(s + 3 * arr, go, base, stride, n, rows, dk);
  cp_async_commit();
}

template <typename T, int DK>
__global__ void __launch_bounds__(32 * kMaxTiles, 2)
agsa_bwd_kernel(const BwdArgs<T> a) {
  using M = Mma<T>;
  constexpr int NT = DK / 8;
  constexpr int LD = row_ld<T, DK>();
  // the gate weights' W^T fragments in shared memory for the recomputed gates
  // (the g W products read W from global memory)
  constexpr bool kFrag = frags_in_smem<DK>(), kStageQK = stage_qk<DK>();
  using P = typename Packed<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* frag = reinterpret_cast<P*>(smem_raw);
  Gates<T> w = a.w;
  if (kFrag) {
    stage_gate_frags<T, DK>(frag, w, a.dk);  // read after the loop's first barrier
    w.frag = frag;
  }
  const int tiles = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int rows = 16 * tiles, r0 = 16 * warp;
  const int dk = a.dk;
  const size_t arr = (size_t)rows * LD;
  const int sld = score_ld<T>(rows);
  const size_t sc = 2 * (size_t)rows * sld;
  T* stage = reinterpret_cast<T*>(frag + (kFrag ? 4 * frags_per_weight<T, DK>() : 0));
  T* ps = stage + (size_t)a.stages * 4 * arr;  // rnd(p), then gg
  T* gs = ps + (size_t)rows * sld;             // gsb, then q at ps + arr, k at ps + 2 arr
  const size_t region = sc > (kStageQK ? 3 : 1) * arr ? sc : (kStageQK ? 3 : 1) * arr;
  float* bias_part = reinterpret_cast<float*>(ps + region);  // tiles x 4 x DK
  const int slot_n = 4 * dk * dk + 4 * dk;
  float* slot = slot_in_smem<DK>() ? bias_part + tiles * 4 * DK
                                   : a.part + (size_t)blockIdx.x * slot_n;
  const long long heads = (long long)a.B * a.H;
  const size_t stride = (size_t)a.H * dk;
  for (int i = threadIdx.x; i < slot_n; i += blockDim.x) slot[i] = 0.0f;
  if (a.stages == 2 && blockIdx.x < heads) {
    stage_head<T, DK>(a.q, a.k, a.v, a.go, a.N, a.H, dk, stage, arr, blockIdx.x, rows);
  }
  int it = 0;
  for (long long item = blockIdx.x; item < heads; item += gridDim.x, ++it) {
    const int buf = a.stages == 2 ? (it & 1) : 0;
    if (a.stages == 1) {
      stage_head<T, DK>(a.q, a.k, a.v, a.go, a.N, a.H, dk, stage, arr, item, rows);
    }
    cp_async_wait_all();
    __syncthreads();  // this head's rows are in; every warp is done with the last head
    if (a.stages == 2 && item + gridDim.x < heads) {
      stage_head<T, DK>(a.q, a.k, a.v, a.go, a.N, a.H, dk, stage + (size_t)(buf ^ 1) * 4 * arr,
                        arr, item + gridDim.x, rows);
    }
    const size_t base = head_base(item, a.N, a.H, dk);
    T* qs = stage + (size_t)buf * 4 * arr;  // q, then qm, then rnd(g_z1)
    T* ks = qs + arr;                       // k, then km, then rnd(g_z2)
    T* vs = ks + arr;                       // v, then rnd(g_gq)
    T* gos = vs + arr;                      // go, then rnd(g_gk)

    do {
      // (a) the gate chain of this warp's rows: qm and km
      float qm[NT][4];
      {
        float q[NT][4], k[NT][4], gq[NT][4], gk[NT][4], gg[NT][4], m[NT][4];
        load_tile<T>(q, qs, LD, r0);
        load_tile<T>(k, ks, LD, r0);
        gate_inputs<T, kFrag>(q, k, w, dk, gq, gk, gg);
        gate<T, kFrag>(gg, w, 1, dk, m);
AGSA_UNROLL_COLS
        for (int n = 0; n < NT; ++n)
          for (int i = 0; i < 4; ++i) qm[n][i] = rnd<T>(q[n][i] * m[n][i] * a.inv);
        gate<T, kFrag>(gg, w, 2, dk, m);
AGSA_UNROLL_COLS
        for (int n = 0; n < NT; ++n)
          for (int i = 0; i < 4; ++i) k[n][i] = rnd<T>(k[n][i] * m[n][i]);
        store_tile<T>(qs, LD, r0, qm);
        store_tile<T>(ks, LD, r0, k);
#if defined(ITRX_AGSA_BWD_CUT) && ITRX_AGSA_BWD_CUT == 1
        store_rows<T>(a.dq, base, stride, a.N, dk, r0, qm);
        store_rows<T>(a.dk_out, base, stride, a.N, dk, r0, k);
        break;
#endif
      }
      __syncthreads();  // every row of qm and km is in

      // (b) this warp's query rows
      float gqm[NT][4];
      {
        float p[kKeyTiles][4], gp[kKeyTiles][4];
        softmax_rows<T>(qm, ks, LD, rows, a.N, dk, p);
        zero(gp);
AGSA_UNROLL_COLS
        for (int s = 0; s < NT * 8 / M::kK; ++s) {
          if (s * M::kK >= dk) continue;
          const typename M::A ga = a_rows<T>(gos, LD, r0, s * M::kK);
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j) {
            if (8 * j < rows) M::mma(gp[j], ga, b_nmajor<T>(vs, LD, 8 * j, s * M::kK));
          }
        }
        float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          d0 += gp[j][0] * p[j][0] + gp[j][1] * p[j][1];
          d1 += gp[j][2] * p[j][2] + gp[j][3] * p[j][3];
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          d0 += __shfl_xor_sync(0xffffffffu, d0, o);
          d1 += __shfl_xor_sync(0xffffffffu, d1, o);
        }
        const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          gp[j][0] = rnd<T>(p[j][0] * (gp[j][0] - d0));
          gp[j][1] = rnd<T>(p[j][1] * (gp[j][1] - d0));
          gp[j][2] = rnd<T>(p[j][2] * (gp[j][2] - d1));
          gp[j][3] = rnd<T>(p[j][3] * (gp[j][3] - d1));
          if (8 * j < rows) {
            const int c = 8 * j + 2 * t;
            store_pair<T>(ps + (r0 + g) * sld + c, p[j][0], p[j][1]);
            store_pair<T>(ps + (r0 + g + 8) * sld + c, p[j][2], p[j][3]);
            store_pair<T>(gs + (r0 + g) * sld + c, gp[j][0], gp[j][1]);
            store_pair<T>(gs + (r0 + g + 8) * sld + c, gp[j][2], gp[j][3]);
          }
        }
        zero(gqm);
        prod_keys<T>(gqm, gp, ks, LD, rows, dk);
      }
      __syncthreads();  // every row of rnd(p) and gsb is in

      // (c) this warp's key rows: g_v and g_km over the head's query rows
      float gkm[NT][4];
      {
        float gv[NT][4];
        zero(gv);
        zero(gkm);
        for (int s = 0; s * M::kK < rows; ++s) {
          const typename M::A pa = a_cols<T>(ps, sld, r0, s * M::kK);
          const typename M::A sa = a_cols<T>(gs, sld, r0, s * M::kK);
AGSA_UNROLL_COLS
          for (int n = 0; n < NT; ++n) {
            if (8 * n < dk) {
              M::mma(gv[n], pa, b_kmajor<T>(gos, LD, 8 * n, s * M::kK));
              M::mma(gkm[n], sa, b_kmajor<T>(qs, LD, 8 * n, s * M::kK));
            }
          }
        }
        store_rows<T>(a.dv, base, stride, a.N, dk, r0, gv);
      }
#if defined(ITRX_AGSA_BWD_CUT) && ITRX_AGSA_BWD_CUT == 2
      store_rows<T>(a.dq, base, stride, a.N, dk, r0, gqm);
      store_rows<T>(a.dk_out, base, stride, a.N, dk, r0, gkm);
      break;
#endif
      __syncthreads();  // the head's arrays are read: (d) stages over them

      // (d) this warp's rows: the gate adjoints
      {
        float q[NT][4], k[NT][4], gq[NT][4], gk[NT][4], gg[NT][4], m[NT][4];
        float g_q[NT][4], g_z[NT][4], g_k[NT][4], g_gg[NT][4];
        float* bias = bias_part + warp * 4 * DK;  // sums of g_gq, g_gk, g_z1, g_z2
        load_tile_global<T>(q, a.q, base, stride, a.N, dk, r0);
        load_tile_global<T>(k, a.k, base, stride, a.N, dk, r0);
        if (kStageQK) {  // the weight sums' inputs
          store_tile<T>(ps + arr, LD, r0, q);
          store_tile<T>(ps + 2 * arr, LD, r0, k);
        }
        gate_inputs<T, kFrag>(q, k, w, dk, gq, gk, gg);
        store_tile<T>(ps, LD, r0, gg);
        zero(g_gg);
        gate<T, kFrag>(gg, w, 1, dk, m);
AGSA_UNROLL_COLS
        for (int n = 0; n < NT; ++n) {
          for (int i = 0; i < 4; ++i) {
            g_q[n][i] = gqm[n][i] * m[n][i] * a.inv;
            g_z[n][i] = gqm[n][i] * q[n][i] * a.inv * m[n][i] * (1.0f - m[n][i]);
          }
        }
        column_sums(g_z, bias + 2 * DK, dk);
        store_tile<T>(qs, LD, r0, g_z);
        prod_w<T>(g_gg, g_z, a.w.wg1, dk);
        gate<T, kFrag>(gg, w, 2, dk, m);
AGSA_UNROLL_COLS
        for (int n = 0; n < NT; ++n) {
          for (int i = 0; i < 4; ++i) {
            g_k[n][i] = gkm[n][i] * m[n][i];
            g_z[n][i] = gkm[n][i] * k[n][i] * m[n][i] * (1.0f - m[n][i]);
          }
        }
        column_sums(g_z, bias + 3 * DK, dk);
        store_tile<T>(ks, LD, r0, g_z);
        prod_w<T>(g_gg, g_z, a.w.wg2, dk);
        // g_gq over gq's registers' use: g_gq = g_gg gk, g_gk = g_gg gq
AGSA_UNROLL_COLS
        for (int n = 0; n < NT; ++n) {
          for (int i = 0; i < 4; ++i) {
            const float x = g_gg[n][i];
            g_gg[n][i] = x * gk[n][i];  // g_gq
            gk[n][i] = x * gq[n][i];    // g_gk
          }
        }
        column_sums(g_gg, bias, dk);
        column_sums(gk, bias + DK, dk);
        store_tile<T>(vs, LD, r0, g_gg);
        store_tile<T>(gos, LD, r0, gk);
        prod_w<T>(g_q, g_gg, a.w.wq, dk);
        prod_w<T>(g_k, gk, a.w.wk, dk);
        store_rows<T>(a.dq, base, stride, a.N, dk, r0, g_q);
        store_rows<T>(a.dk_out, base, stride, a.N, dk, r0, g_k);
      }
      __syncthreads();  // every staged row and bias partial is in

      // (e) the weight sums of this head: the four (dk, dk) sums in 16-row
      //     strips (a weight's 16 output rows x all dk columns), dealt over
      //     the warps; a strip's A fragment serves its NT column tiles, and
      //     each element is added into the slot by its owning lane
#if defined(ITRX_AGSA_BWD_CUT) && ITRX_AGSA_BWD_CUT == 3
      break;
#endif
      {
        constexpr int MT = DK / 16;
        const int lane = lane_id(), g = lane >> 2, t = lane & 3;
        for (int strip = warp; strip < 4 * MT; strip += tiles) {
          const int wi = strip / MT, m0 = 16 * (strip % MT);
          if (m0 >= dk) continue;
          const T* gsrc = wi == 0 ? vs : wi == 1 ? gos : wi == 2 ? qs : ks;
          const T* xsrc = wi == 0 ? ps + arr : wi == 1 ? ps + 2 * arr : ps;
          float acc[NT][4];
          zero(acc);
          for (int s = 0; s * M::kK < rows; ++s) {
            const typename M::A ga = a_cols<T>(gsrc, LD, m0, s * M::kK);
AGSA_UNROLL_COLS
            for (int n = 0; n < NT; ++n) {
              if (8 * n >= dk) continue;
              const typename M::B xb =
                  kStageQK || wi >= 2
                      ? b_kmajor<T>(xsrc, LD, 8 * n, s * M::kK)
                      : b_kmajor_global<T>(wi == 0 ? a.q : a.k, base, stride, a.N, dk, 8 * n,
                                           s * M::kK);
              M::mma(acc[n], ga, xb);
            }
          }
          float* out = slot + (size_t)wi * dk * dk;
          const int c0 = m0 + g, c1 = m0 + g + 8;
AGSA_UNROLL_COLS
          for (int n = 0; n < NT; ++n) {
            const int e = 8 * n + 2 * t;
            if (e >= dk) continue;
            if (c0 < dk) out[c0 * dk + e] += acc[n][0], out[c0 * dk + e + 1] += acc[n][1];
            if (c1 < dk) out[c1 * dk + e] += acc[n][2], out[c1 * dk + e + 1] += acc[n][3];
          }
        }
        float* bias_slot = slot + 4 * dk * dk;
        for (int x = threadIdx.x; x < 4 * dk; x += blockDim.x) {
          const int wb = x / dk, c = x % dk;
          float sum = bias_slot[x];
          for (int w = 0; w < tiles; ++w) sum += bias_part[(w * 4 + wb) * DK + c];
          bias_slot[x] = sum;
        }
      }
    } while (false);
    if (a.stages == 1) __syncthreads();  // the stage is free for the next head
  }
  if (slot_in_smem<DK>()) {
    __syncthreads();
    float* dst = a.part + (size_t)blockIdx.x * slot_n;
    for (int i = threadIdx.x; i < slot_n; i += blockDim.x) dst[i] = slot[i];
  }
}

// dw[i] = the sum over the `parts` slots of part[z][i], in order of z
__global__ void agsa_bwd_reduce(const float* __restrict__ part, float* __restrict__ dw,
                                int n_out, int parts) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  float sum = 0.0f;
#pragma unroll 8
  for (int z = 0; z < parts; ++z) sum += part[(size_t)z * n_out + idx];
  dw[idx] = sum;
}

// The launch plan of the head pass: blocks of ceil(N / 16) warps, as many an
// SM as fit, one or two stages (two where they fit as many blocks), at most
// `slots` blocks; < 0 is minus a CUDA error.  out = {grid, stages, blocks an
// SM, shared bytes}
template <typename T, int DK>
int plan(int B, int N, int H, int dk, int slots, int device, int (&out)[4]) {
  static PlanCache cache;
  const long long key[7] = {B, N, H, dk, slots, device, 1};
  if (cache.find(key, out)) return 0;
  const int tiles = (N + 15) / 16;
  const int threads = 32 * tiles;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  // the most any plan asks; each launch passes its own size
  err = cudaFuncSetAttribute(agsa_bwd_kernel<T, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err != cudaSuccess) return -(int)err;
  int best_blocks = 0, best_stages = 1;
  for (int stages = 1; stages <= 2; ++stages) {
    const size_t smem = bwd_smem<T, DK>(tiles, stages, dk);
    if (smem > (size_t)kSmemMax) continue;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, agsa_bwd_kernel<T, DK>,
                                                        threads, smem);
    if (err != cudaSuccess) return -(int)err;
    if (per_sm >= best_blocks && per_sm > 0) best_blocks = per_sm, best_stages = stages;
  }
  if (best_blocks < 1) return -(int)cudaErrorInvalidValue;
  const long long heads = (long long)B * H;
  long long grid = (long long)sms * best_blocks;
  if (heads < grid) grid = heads;
  if (slots < grid) grid = slots;
  out[0] = (int)grid;
  out[1] = best_stages;
  out[2] = best_blocks;
  out[3] = (int)bwd_smem<T, DK>(tiles, best_stages, dk);
  cache.put(key, out);
  return 0;
}

template <typename T, int DK>
int run(const BwdArgs<T>& args0, float* dw, int slots, int device, cudaStream_t stream) {
  int p[4];
  const int code = plan<T, DK>(args0.B, args0.N, args0.H, args0.dk, slots, device, p);
  if (code < 0) return -code;
  BwdArgs<T> args = args0;
  args.stages = p[1];
  const int threads = 32 * ((args.N + 15) / 16);
  agsa_bwd_kernel<T, DK><<<p[0], threads, p[3], stream>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = 4 * args.dk * args.dk + 4 * args.dk;
  agsa_bwd_reduce<<<(n_out + 255) / 256, 256, 0, stream>>>(args.part, dw, n_out, p[0]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const BwdArgs<T>& args, float* dw, int slots, int device, cudaStream_t stream) {
  return args.dk <= 32 ? run<T, 32>(args, dw, slots, device, stream)
                       : run<T, 128>(args, dw, slots, device, stream);
}

template <typename T>
int dispatch_plan(int B, int N, int H, int dk, int slots, int device, int (&out)[4]) {
  return dk <= 32 ? plan<T, 32>(B, N, H, dk, slots, device, out)
                  : plan<T, 128>(B, N, H, dk, slots, device, out);
}

// ---- bf16: the PR 12 design ---------------------------------------------
//
// Three launches, so that the largest shape the forward takes (N 64, d_k
// 128) fits one block's shared memory in each.
//  1. attention (one block per batch row and group of G heads, the bf16
//     forward's layout): the forward's gates give qm and km in shared memory;
//     v and go replace the gate weights; one warp a query row gives p and g_s
//     (kept as rnd(p), rnd(g_s) rows, N x N a head) and g_qm; then one warp a
//     key row gives g_v (written as dv) and g_km.  g_qm and g_km go to an
//     fp32 workspace in q's layout.
//  2. gates (a persistent grid of P blocks over tiles of TR rows of the
//     flattened (B N h, d_k) matrices): it recomputes gq, gk, gg, m1, m2 of
//     its rows, runs the gate adjoints, writes dq and dk, and adds the tile's
//     weight and bias sums to its block's own slot of the partials, tile after
//     tile in a fixed order.  The weights are staged two at a time, padded to
//     d_k + 1 so that both the row-wise products (x W^T) and the column-wise
//     ones (g W) read distinct banks.
//  3. agsa_bwd_reduce over the P slots.
// Every sum a sequential fp32 FMA chain.
namespace fma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemTarget = 72 * 1024;
constexpr int kMaxTileRows = 64;
constexpr int kMinTileRows = 16;

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
int run_fma(const void* q, const void* k, const void* v, const void* go, const void* wq,
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

}  // namespace fma

bool valid(int B, int N, int H, int dk) {
  return B >= 1 && H >= 1 && N >= 1 && N <= kMaxN && dk >= 8 && dk <= kMaxDk && dk % 8 == 0;
}

template <typename T>
BwdArgs<T> make_args(const void* q, const void* k, const void* v, const void* go,
                     const void* wq, const void* bq, const void* wk, const void* bk,
                     const void* wg1, const void* bg1, const void* wg2, const void* bg2,
                     void* dq, void* dk_out, void* dv, void* part, int B, int N, int H, int dk) {
  const auto ct = [](const void* p) { return static_cast<const T*>(p); };
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  BwdArgs<T> a;
  a.q = ct(q), a.k = ct(k), a.v = ct(v), a.go = ct(go);
  a.w = Gates<T>{ct(wq), cf(bq), ct(wk), cf(bk), ct(wg1), cf(bg1), ct(wg2), cf(bg2)};
  a.dq = static_cast<T*>(dq), a.dk_out = static_cast<T*>(dk_out), a.dv = static_cast<T*>(dv);
  a.part = static_cast<float*>(part);
  a.B = B, a.N = N, a.H = H, a.dk = dk, a.stages = 1;
  a.inv = (float)(1.0 / std::sqrt((double)dk));
  return a;
}

}  // namespace

extern "C" {

// The backward of itrx_agsa_fwd.  q, k, v, go (the output's cotangent) and
// dq, dk, dv (B, N, H dk) and the weights wq, wk, wg1, wg2 (dk, dk), torch's
// (out, in) layout, all fp32 or all bf16 (bf16 != 0); the biases bq, bk, bg1,
// bg2 (dk) fp32; contiguous, 16-byte aligned.  dw (4 dk^2 + 4 dk) fp32 out:
// dWq, dWk, dWg1, dWg2 (dk, dk), then dbq, dbk, dbg1, dbg2.  part, fp32, holds
// `slots` x (4 dk^2 + 4 dk) partials, one a block: fp32 runs at most `slots`
// blocks (itrx_agsa_bwd_plan's grid); bf16 runs one wave of its gate pass
// within `slots` (the SMs x 8, the most 256-thread blocks an SM holds, never
// limit it) and needs gqm and gkm, fp32 workspaces of B x N x H dk each
// (fp32 passes null).  1 <= N <= 64, 8 <= dk <= 128, dk % 8 == 0.  Two
// launches (fp32) or three (bf16) on `stream` of CUDA device `device`;
// returns the first CUDA error (cudaGetLastError()) or 0.
int itrx_agsa_bwd(const void* q, const void* k, const void* v, const void* go, const void* wq,
                  const void* bq, const void* wk, const void* bk, const void* wg1,
                  const void* bg1, const void* wg2, const void* bg2, void* dq, void* dk_out,
                  void* dv, void* dw, void* part, void* gqm, void* gkm, int B, int N, int H,
                  int dk, int slots, int bf16, int device, void* stream) {
  if (!valid(B, N, H, dk) || slots < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dwf = static_cast<float*>(dw);
  if (bf16) {
    const auto f = [](void* p) { return static_cast<float*>(p); };
    return fma::run_fma<__nv_bfloat16>(q, k, v, go, wq, bq, wk, bk, wg1, bg1, wg2, bg2, dq,
                                       dk_out, dv, dwf, f(gqm), f(gkm), f(part), B, N, H, dk,
                                       slots, device, s);
  }
  return dispatch(make_args<float>(q, k, v, go, wq, bq, wk, bk, wg1, bg1, wg2, bg2, dq, dk_out,
                                   dv, part, B, N, H, dk),
                  dwf, slots, device, s);
}

// The head pass itrx_agsa_bwd launches in fp32 for these sizes: out = {grid,
// stages, blocks an SM, shared bytes a block}; returns a CUDA error or 0.
int itrx_agsa_bwd_plan(int B, int N, int H, int dk, int slots, int device, int* out) {
  if (!valid(B, N, H, dk) || slots < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int p[4];
  const int code = dispatch_plan<float>(B, N, H, dk, slots, device, p);
  if (code < 0) return -code;
  for (int i = 0; i < 4; ++i) out[i] = p[i];
  return 0;
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
