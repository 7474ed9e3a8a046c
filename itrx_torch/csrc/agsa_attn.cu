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
// The order of operations of every output element is fixed, and is that of
// agsa_attention_plain on the card, so that the two agree bit for bit
// (cuBLAS's fp32 products sum each element as one ascending chain of FMAs
// from 0; torch's warp softmax sums a row as below).  Two checks on the card
// presume it (PERF.md §6): bf16 outputs held to the plain ones within
// one bf16 step of scale, and CAMERA's training step with this kernel held
// to the step with the plain pair, whose ReLU decisions a forward ~1e-6 off
// flips.  Per element:
//   gq, gk:  a = fmaf(x[e], W[c][e], a) for e = 0 .. d_k - 1 from 0.0f, then
//            gg = rnd((a_q + bq[c]) * (a_k + bk[c]))
//   z1, z2:  the same chains over gg;  m = 1.0f / (1.0f + expf(-(z + b[c])))
//   qm = rnd((q * m1) * inv),  km = rnd(k * m2)
//   s[i][j]: the chain over e of qm[i][e] km[j][e];  mx = the row's max
//   e_j = expf(s_j - mx);  the row's sum: lane l adds e[l] + e[l + 32] (0
//            past N), then an xor butterfly over offsets 16, 8, 4, 2, 1
//   p = rnd(e_j / sum), a true division;  out = rnd(the chain over j
//            ascending of p_j v[j][c], from 0.0f)
// Every product is an explicit fmaf and no other product meets an add, so
// nvcc contracts nothing; no tensor cores, no fast-math intrinsics or flags.
// Only the movement of data and the split of the work are free.
//
// What bounds it here: at CAMERA's shapes (B 128, 64 heads, N 36 or 32,
// d_k 32) the four gate products and the two attention products are ~230 K
// multiply-adds a head, 3.8 GFLOP a call, on the fp32 FMA pipes (56 us at
// their 67 TFLOP/s), against 113 MB of fp32 q, k, v read and out written
// (34 us; bf16 half).  Every operand of an FMA comes from shared memory,
// which hands an SM's threads 128 bytes a clock, a quarter of what its FMA
// pipes take: an FMA design is paced by how often a thread reuses what it
// loads, and beside the FMAs every element pays two sigmoids and every
// score row an expf a key, a division and ten shuffles.
//
// Design: a persistent grid (as many blocks an SM as fit: two at CAMERA's
// shapes) walks units of G heads of one batch row, G from the host's plan
// (4 at CAMERA's shapes: 144 or 128 rows); a block has a warp a strip of 16
// of the unit's rows (9 or 8 warps).  The
// four weights are staged once a block into shared memory as fp32 rows
// (d_k <= 32; wider classes read them from global memory through L1), the
// biases beside them.  A unit's q and k, then v, come by 16-byte cp.async
// (csrc/agsa_tile.cuh's stage_rows) in the input type, as two commit groups
// (the gates wait for q and k alone), the next unit's landing during this
// one where two stages fit as many blocks an SM as one; bf16 is converted
// exactly at use.  Every product is a register tile of 4 x 4 outputs a lane
// whose operands are read four values a load along the chain (8 loads feed
// 64 FMAs; the two gate products over gg share their gg loads), rows laid
// out so that a warp's loads hit distinct banks or broadcast:
//  1. Gates: a lane takes rows 4 i + its row group of its warp's strip and
//     columns its column group + 8 j: gq and gk, gg to the warp's scratch,
//     then z1 and z2 over gg, m1, m2, and qm, km written over q and k.
//  2. Scores: a lane takes a quad (4 consecutive query rows of a head) and
//     keys its column group + 8 j (j < 4, 5 or 8 as N needs), S to the
//     block's scratch; a barrier.
//  3. Softmax: a warp takes rows of S, a lane keys lane and lane + 32, the
//     max by an integer warp reduction (order-free), the sum's tree as above;
//     p over S in place; a barrier.
//  4. p v: a lane takes a quad and 4 consecutive columns, the output written
//     from the tile (16 or 8 bytes a row).
// Four barriers a unit: its q and k land, the gates, the scores, the softmax.
//
// ITRX_AGSA_FWD_CUT (tools/agsa_phases.py; wrong results by design): 1
// stops each unit after its rows land, 2 after the gates, each writing
// what it has (v, then qm) in place of the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "agsa_tile.cuh"

namespace {

using namespace agsa;

constexpr int kMaxWarps = 9;    // warps a block: a strip each, up to 9 (144 rows)
constexpr int kStrip = 16;      // rows of a warp's gate strip: 4 row groups x 4 rows
constexpr int kUnitRows = 128;  // rows a unit aims at: 8 or more strips

// the weights in shared memory as fp32 rows up to this class; past it read
// from global memory (L1), which keeps the widest class's block within
// shared memory
template <int DK>
__host__ __device__ constexpr bool w_in_smem() { return DK <= 32; }
// floats of an fp32 row of a staged weight or of gg
template <int DK>
__host__ __device__ constexpr int f_ld() { return DK + 4; }
// the unrolling of the loops over e (four values a step) of the gate tiles
// and the scores: 4 in fp32, 2 in bf16 (whose conversions take registers),
// a plain loop past d_k 32
template <typename T, int DK>
__host__ __device__ constexpr int unroll_e() {
  return DK > 32 ? 1 : std::is_same<T, float>::value ? 4 : 2;
}

// rows of a unit's arrays: G N rounded up to whole strips
__host__ __device__ inline int unit_rows(int g, int n) {
  return (g * n + kStrip - 1) / kStrip * kStrip;
}

// warps a block: one a strip of a unit, at most kMaxWarps
inline int unit_warps(int g, int n) {
  const int strips = unit_rows(g, n) / kStrip;
  return strips < kMaxWarps ? strips : kMaxWarps;
}

// floats of a row of the unit's score array
__host__ __device__ inline int s_ld(int n) { return (n + 3) / 4 * 4; }

// floats of the block's scratch: each warp's gg of a strip during the gates,
// then the unit's scores and p (G N rows of s_ld)
template <int DK>
__host__ __device__ inline int scratch_floats(int g, int n, int warps) {
  const int gg = warps * kStrip * f_ld<DK>(), sp = g * n * s_ld(n);
  return gg > sp ? gg : sp;
}

// shared bytes of a block: the biases, the weights (narrow class), the warps'
// scratch, then the stages (q, k, v of a unit each, in T)
template <typename T, int DK>
size_t fwd_smem(int g, int n, int stages) {
  size_t floats = 4 * (size_t)DK + scratch_floats<DK>(g, n, unit_warps(g, n));
  if (w_in_smem<DK>()) floats += 4 * (size_t)DK * f_ld<DK>();
  return floats * sizeof(float) +
         (size_t)stages * 3 * unit_rows(g, n) * row_ld<T, DK>() * sizeof(T);
}

template <typename T>
struct FwdArgs {
  const T* q;
  const T* k;
  const T* v;
  Gates<T> w;
  T* out;
  int B, N, H, dk, G, stages;
  float inv;
};

// cp.async groups still in flight: at most N
template <int N_>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_) : "memory");
}

// four consecutive values as fp32, exactly: 16 bytes of fp32, 8 of bf16
__device__ __forceinline__ float4 bf16x4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  return bf16x4(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  return bf16x4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// four values to consecutive elements, rounded to T: 16 bytes of fp32, 8 of
// bf16
__device__ __forceinline__ void store4(float* o, const float (&x)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float (&x)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(o) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

template <int I>
__device__ __forceinline__ float at(const float4& v) {
  return I == 0 ? v.x : I == 1 ? v.y : I == 2 ? v.z : v.w;
}

// a float as an int whose order is the floats' (an involution), so that a
// row's max is one integer warp reduction; the max is exact in any order
__device__ __forceinline__ int ordered(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int b) {
  return __int_as_float(b >= 0 ? b : b ^ 0x7fffffff);
}

// acc[i][j] = fmaf(x[i][e], w[j][e], acc[i][j]) for the e of one load (E)
template <int E>
__device__ __forceinline__ void chain_step(float (&acc)[4][4], const float4 (&x)[4],
                                           const float4 (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(at<E>(x[i]), at<E>(w[j]), acc[i][j]);
  }
}

// the four e of a load, ascending
__device__ __forceinline__ void chain4(float (&acc)[4][4], const float4 (&x)[4],
                                       const float4 (&w)[4]) {
  chain_step<0>(acc, x, w);
  chain_step<1>(acc, x, w);
  chain_step<2>(acc, x, w);
  chain_step<3>(acc, x, w);
}

template <int N_, int M_>
__device__ __forceinline__ void clear(float (&x)[N_][M_]) {
#pragma unroll
  for (int i = 0; i < N_; ++i) {
#pragma unroll
    for (int j = 0; j < M_; ++j) x[i][j] = 0.0f;
  }
}

// Rows of one (dk, dk) weight W, torch's (out, in) layout: W[c][e .. e + 3]
// from shared memory (fp32 rows of f_ld) or from global memory (T)
template <typename T, int DK>
struct WRows {
  const float* s;
  const T* g;
  __device__ __forceinline__ float4 row4(int c, int e, int dk) const {
    if constexpr (w_in_smem<DK>()) {
      return ld4(s + c * f_ld<DK>() + e);
    } else {
      return ldg4(g + (size_t)c * dk + e);
    }
  }
};

// acc[i][j] += x[row i] . W[col j] over e ascending: the lane's rows at x +
// 4 i ld, its columns cl[j] (clamped to the weights' rows); with W2, acc2
// the same over W2 from the same loads of x
template <typename X, typename T, int DK, bool kTwo>
__device__ __forceinline__ void tile(float (&acc)[4][4], float (&acc2)[4][4], const X* x, int ld,
                                     const WRows<T, DK>& w, const WRows<T, DK>& w2,
                                     const int (&cl)[4], int dk) {
AGSA_PRAGMA(unroll(unroll_e<T, DK>()))
  for (int e = 0; e < dk; e += 4) {
    float4 xr[4], wr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xr[i] = ld4(x + 4 * i * ld + e);
#pragma unroll
    for (int j = 0; j < 4; ++j) wr[j] = w.row4(cl[j], e, dk);
    chain4(acc, xr, wr);
    if constexpr (kTwo) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wr[j] = w2.row4(cl[j], e, dk);
      chain4(acc2, xr, wr);
    }
  }
}

// q and k of unit u (batch row u / groups, heads from (u % groups) G), then
// v, into dst, dst + arr, dst + 2 arr (head g's rows from row g N): two
// commit groups, so that the gates wait for q and k alone
template <typename T, int DK>
__device__ __forceinline__ void stage_unit(const FwdArgs<T>& a, T* dst, size_t arr,
                                           long long u, int groups) {
  const long long item = u / groups * a.H + (u % groups) * a.G;
  const int gn = min(a.G, a.H - (int)(u % groups) * a.G);
  const size_t stride = (size_t)a.H * a.dk, head = (size_t)a.N * row_ld<T, DK>();
  const size_t base = head_base(item, a.N, a.H, a.dk);
  for (int g = 0; g < gn; ++g) {
    stage_rows<T, DK>(dst + g * head, a.q, base + (size_t)g * a.dk, stride, a.N, a.N, a.dk);
    stage_rows<T, DK>(dst + arr + g * head, a.k, base + (size_t)g * a.dk, stride, a.N, a.N,
                      a.dk);
  }
  cp_async_commit();
  for (int g = 0; g < gn; ++g) {
    stage_rows<T, DK>(dst + 2 * arr + g * head, a.v, base + (size_t)g * a.dk, stride, a.N, a.N,
                      a.dk);
  }
  cp_async_commit();
}

#if defined(ITRX_AGSA_FWD_CUT)
// a unit's staged rows x written where its output goes (the cuts' stand-in)
template <typename T, int DK>
__device__ void write_rows(const FwdArgs<T>& a, const T* x, T* out, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += blockDim.x >> 5) {
    T* o = out + (size_t)(r % a.N) * a.H * a.dk + (size_t)(r / a.N) * a.dk;
    for (int c = lane; c < a.dk; c += 32) o[c] = x[r * row_ld<T, DK>() + c];
  }
}
#endif

// The attention reads whole quads: 4 consecutive query rows of one head (rows
// past N read row N - 1, and are not written); a warp takes 4 quads at a
// time, one a row group of lanes.  Quad t of the unit: head t / nq, rows
// 4 (t % nq) ..

// Scores S = qm km^T of a lane's quad x keys cg + 8 j (j < J), each an
// ascending chain over e from 0; S[row][key] to the unit's score array
template <typename T, int DK, int J>
__device__ __forceinline__ void scores(const T* qs, const T* ks, float* S, int gn, int N,
                                       int dk) {
  constexpr int LDT = row_ld<T, DK>();
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const int nq = (N + 3) / 4, quads = gn * nq, sld = s_ld(N);
  for (int t = 4 * warp + rg; t - rg < quads; t += 4 * warps) {
    if (t >= quads) continue;
    const int g = t / nq, i0 = 4 * (t % nq);
    const T* qb = qs + g * N * LDT;
    const T* kb = ks + g * N * LDT;
    float acc[4][J];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = 0.0f;
    }
AGSA_PRAGMA(unroll(unroll_e<T, DK>()))
    for (int e = 0; e < dk; e += 4) {
      float4 x[4], y[J];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = ld4(qb + min(i0 + i, N - 1) * LDT + e);
#pragma unroll
      for (int j = 0; j < J; ++j) y[j] = ld4(kb + min(cg + 8 * j, N - 1) * LDT + e);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
          acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
          acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
          acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
        }
      }
    }
    float* s = S + (g * N + i0) * sld;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i0 + i >= N) break;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (cg + 8 * j < N) s[i * sld + cg + 8 * j] = acc[i][j];
      }
    }
  }
}

// The softmax of each row of S in place, to rnd(p): a warp a row, keys
// lane and lane + 32; the max is order-free, the sum the tree of lane l's
// e[l] + e[l + 32] then an xor butterfly, p a true division
template <typename T>
__device__ __forceinline__ void softmax_rows(float* S, int rows, int N) {
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sld = s_ld(N), X = N > 32 ? N - 32 : 0;
  constexpr int kRows = 4;  // rows at once, for independent chains
  for (int r0 = warp * kRows; r0 < rows; r0 += warps * kRows) {
    float v0[kRows], v1[kRows], mx[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float* s = S + min(r0 + i, rows - 1) * sld;
      v0[i] = lane < N ? s[lane] : -INFINITY;
      v1[i] = lane < X ? s[32 + lane] : -INFINITY;
      mx[i] = unordered(__reduce_max_sync(0xffffffffu, max(ordered(v0[i]), ordered(v1[i]))));
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float e0 = lane < N ? expf(v0[i] - mx[i]) : 0.0f;
      float e1 = 0.0f;
      if (lane < X) e1 = expf(v1[i] - mx[i]);
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (r0 + i < rows) {
        float* s = S + (r0 + i) * sld;
        if (lane < N) s[lane] = rnd<T>(e0 / sum);
        if (lane < X) s[32 + lane] = rnd<T>(e1 / sum);
      }
    }
  }
}

// out = P v of a lane's quad x columns 4 cg .. 4 cg + 3 (+ 32 c), each an
// ascending chain over the keys from 0; written to the unit's output rows
template <typename T, int DK>
__device__ __forceinline__ void pv(const float* S, const T* vs, T* out, int gn, int N, int dk,
                                   size_t row) {
  constexpr int LDT = row_ld<T, DK>();
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const int nq = (N + 3) / 4, quads = gn * nq, sld = s_ld(N);
  for (int t = 4 * warp + rg; t - rg < quads; t += 4 * warps) {
    if (t >= quads) continue;
    const int g = t / nq, i0 = 4 * (t % nq);
    const float* p = S + g * N * sld;
    const T* vb = vs + g * N * LDT;
    for (int c0 = 4 * cg; c0 < dk; c0 += 32) {
      float acc[4][4];
      clear(acc);
      int j = 0;
      for (; j + 4 <= N; j += 4) {
        float4 x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = ld4(p + min(i0 + i, N - 1) * sld + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) y[jj] = ld4(vb + (j + jj) * LDT + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(x[i].x, y[0].x, acc[i][0]);
          acc[i][1] = fmaf(x[i].x, y[0].y, acc[i][1]);
          acc[i][2] = fmaf(x[i].x, y[0].z, acc[i][2]);
          acc[i][3] = fmaf(x[i].x, y[0].w, acc[i][3]);
          acc[i][0] = fmaf(x[i].y, y[1].x, acc[i][0]);
          acc[i][1] = fmaf(x[i].y, y[1].y, acc[i][1]);
          acc[i][2] = fmaf(x[i].y, y[1].z, acc[i][2]);
          acc[i][3] = fmaf(x[i].y, y[1].w, acc[i][3]);
          acc[i][0] = fmaf(x[i].z, y[2].x, acc[i][0]);
          acc[i][1] = fmaf(x[i].z, y[2].y, acc[i][1]);
          acc[i][2] = fmaf(x[i].z, y[2].z, acc[i][2]);
          acc[i][3] = fmaf(x[i].z, y[2].w, acc[i][3]);
          acc[i][0] = fmaf(x[i].w, y[3].x, acc[i][0]);
          acc[i][1] = fmaf(x[i].w, y[3].y, acc[i][1]);
          acc[i][2] = fmaf(x[i].w, y[3].z, acc[i][2]);
          acc[i][3] = fmaf(x[i].w, y[3].w, acc[i][3]);
        }
      }
      for (; j < N; ++j) {
        const float4 y = ld4(vb + j * LDT + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = p[min(i0 + i, N - 1) * sld + j];
          acc[i][0] = fmaf(x, y.x, acc[i][0]);
          acc[i][1] = fmaf(x, y.y, acc[i][1]);
          acc[i][2] = fmaf(x, y.z, acc[i][2]);
          acc[i][3] = fmaf(x, y.w, acc[i][3]);
        }
      }
      T* o = out + (size_t)g * dk + c0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i0 + i >= N) break;
        store4(o + (i0 + i) * row, acc[i]);
      }
    }
  }
}

// W: the most warps a block, which bounds the registers (two blocks of up to
// 8 warps an SM hold 128 a thread, of 9 warps 96)
template <typename T, int DK, int W>
__global__ void __launch_bounds__(32 * W, 2) agsa_fwd_kernel(const FwdArgs<T> a) {
  constexpr int LDT = row_ld<T, DK>(), LDF = f_ld<DK>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bias = reinterpret_cast<float*>(smem_raw);  // bq, bk, bg1, bg2 at DK apart
  float* wsm = bias + 4 * DK;                        // Wq, Wk, Wg1, Wg2 (narrow class)
  float* scratch = wsm + (w_in_smem<DK>() ? 4 * DK * LDF : 0);
  const int warps = blockDim.x >> 5;
  T* stage = reinterpret_cast<T*>(scratch + scratch_floats<DK>(a.G, a.N, warps));
  const int dk = a.dk, N = a.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, cg = lane & 7;  // a lane's row and column groups
  const size_t arr = (size_t)unit_rows(a.G, N) * LDT;
  const int groups = (a.H + a.G - 1) / a.G;
  const long long units = (long long)a.B * groups;
  const size_t row = (size_t)a.H * dk;                  // elements of a position's row
  float* mine = scratch + warp * kStrip * LDF;  // gg of a strip

  for (int c = threadIdx.x; c < dk; c += blockDim.x) {
    bias[c] = a.w.bq[c];
    bias[DK + c] = a.w.bk[c];
    bias[2 * DK + c] = a.w.bg1[c];
    bias[3 * DK + c] = a.w.bg2[c];
  }
  if constexpr (w_in_smem<DK>()) {  // read after the loop's first barrier
    for (int idx = threadIdx.x; idx < 4 * dk * dk; idx += blockDim.x) {
      const int wi = idx / (dk * dk), r = idx % (dk * dk);
      const T* src = wi == 0 ? a.w.wq : wi == 1 ? a.w.wk : wi == 2 ? a.w.wg1 : a.w.wg2;
      wsm[(wi * DK + r / dk) * LDF + r % dk] = to_f(src[r]);
    }
  }
  const WRows<T, DK> wq{wsm, a.w.wq}, wk{wsm + DK * LDF, a.w.wk},
      wg1{wsm + 2 * DK * LDF, a.w.wg1}, wg2{wsm + 3 * DK * LDF, a.w.wg2};
  if (a.stages == 2 && blockIdx.x < units) stage_unit<T, DK>(a, stage, arr, blockIdx.x, groups);

  int it = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x, ++it) {
    T* qs = stage + (a.stages == 2 ? (size_t)(it & 1) * 3 * arr : 0);  // q, then qm
    T* ks = qs + arr;                                                   // k, then km
    const T* vs = ks + arr;
    if (a.stages == 1) stage_unit<T, DK>(a, qs, arr, u, groups);
    cp_async_wait<1>();  // q and k (v may still be in flight)
    __syncthreads();     // this unit's q, k are in; every warp is done with the last unit
    const bool ahead = a.stages == 2 && u + gridDim.x < units;
    if (ahead) {
      stage_unit<T, DK>(a, stage + (size_t)((it & 1) ^ 1) * 3 * arr, arr, u + gridDim.x, groups);
    }
    const int h0 = (int)(u % groups) * a.G;
    const int gn = min(a.G, a.H - h0);
    const int rows = gn * N;
    T* out = a.out + head_base(u / groups * a.H + h0, N, a.H, dk);  // the unit's first head
    do {
#if defined(ITRX_AGSA_FWD_CUT) && ITRX_AGSA_FWD_CUT == 1
      if (ahead) cp_async_wait<2>(); else cp_async_wait<0>();
      __syncthreads();
      write_rows<T, DK>(a, vs, out, rows);
      break;
#endif
      // 1. the gates, a strip of 16 rows at a time
      for (int s = warp; s * kStrip < rows; s += warps) {
        const int r0 = s * kStrip + rg;  // the lane's rows: r0 + 4 i
        for (int c0 = 0; c0 < dk; c0 += 32) {
          int cl[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) cl[j] = min(c0 + cg + 8 * j, dk - 1);
          float ga[4][4], gb[4][4];
          clear(ga);
          clear(gb);
          tile<T, T, DK, false>(ga, ga, qs + r0 * LDT, LDT, wq, wq, cl, dk);
          tile<T, T, DK, false>(gb, gb, ks + r0 * LDT, LDT, wk, wk, cl, dk);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + cg + 8 * j;
            if (c >= dk) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              mine[(rg + 4 * i) * LDF + c] =
                  rnd<T>((ga[i][j] + bias[c]) * (gb[i][j] + bias[DK + c]));
            }
          }
        }
        __syncwarp();  // the strip's gg rows are in
        for (int c0 = 0; c0 < dk; c0 += 32) {
          int cl[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) cl[j] = min(c0 + cg + 8 * j, dk - 1);
          float z1[4][4], z2[4][4];
          clear(z1);
          clear(z2);
          tile<float, T, DK, true>(z1, z2, mine + rg * LDF, LDF, wg1, wg2, cl, dk);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + cg + 8 * j;
            if (c >= dk) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = r0 + 4 * i;
              if (r >= rows) continue;
              const float m1 = sigmoid_f(z1[i][j] + bias[2 * DK + c]);
              const float m2 = sigmoid_f(z2[i][j] + bias[3 * DK + c]);
              T* qp = qs + r * LDT + c;
              T* kp = ks + r * LDT + c;
              *qp = from_f<T>((to_f(*qp) * m1) * a.inv);
              *kp = from_f<T>(to_f(*kp) * m2);
            }
          }
        }
        __syncwarp();  // the strip's gg rows are read
      }
      __syncthreads();  // every row of qm and km is in
#if defined(ITRX_AGSA_FWD_CUT) && ITRX_AGSA_FWD_CUT == 2
      write_rows<T, DK>(a, qs, out, rows);
      break;
#endif
      // 2. the attention: the scores, their softmax in place, then p v
      if (N <= 32) {
        scores<T, DK, 4>(qs, ks, scratch, gn, N, dk);
      } else if (N <= 40) {
        scores<T, DK, 5>(qs, ks, scratch, gn, N, dk);
      } else {
        scores<T, DK, 8>(qs, ks, scratch, gn, N, dk);
      }
      __syncthreads();  // every score is in
      softmax_rows<T>(scratch, rows, N);
      if (ahead) cp_async_wait<2>(); else cp_async_wait<0>();  // v
      __syncthreads();  // every p and row of v is in
      pv<T, DK>(scratch, vs, out, gn, N, dk, row);
    } while (false);
    if (a.stages == 1) __syncthreads();  // the stage is free for the next unit
  }
}

// heads a unit: the fewest whose rows fill kUnitRows in whole strips, else
// the fewest that fill them, else all H
int unit_heads(int n, int h) {
  for (int g = 1; g <= h; ++g) {
    if (g * n >= kUnitRows && g * n % kStrip == 0) return g;
  }
  for (int g = 1; g <= h; ++g) {
    if (g * n >= kUnitRows) return g;
  }
  return h;
}

// The launch plan: G heads a unit (fewer where its block would not fit),
// a warp a strip of the unit's rows, one or two stages (two where they fit
// as many blocks an SM), as many blocks an SM as fit, a grid of at most that
// many per SM; < 0 is minus a CUDA error.  out = {grid, G, stages, blocks an
// SM, shared bytes, warps a block}
// the kernel for blocks of `warps`
template <typename T, int DK>
auto kernel_for(int warps) {
  return warps <= 8 ? agsa_fwd_kernel<T, DK, 8> : agsa_fwd_kernel<T, DK, kMaxWarps>;
}

template <typename T, int DK>
int plan(int B, int N, int H, int dk, int device, int (&out)[6]) {
  static PlanCache cache;
  const long long key[7] = {B, N, H, dk, device, 0, 0};
  int p[4];
  if (!cache.find(key, p)) {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -(int)err;
    // the most any plan asks; each launch passes its own size
    int g = unit_heads(N, H);
    while (g > 1 && fwd_smem<T, DK>(g, N, 1) > (size_t)kSmemMax) --g;
    const auto kernel = kernel_for<T, DK>(unit_warps(g, N));
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return -(int)err;
    int best_blocks = 0, best_stages = 1;
    for (int stages = 1; stages <= 2; ++stages) {
      const size_t smem = fwd_smem<T, DK>(g, N, stages);
      if (smem > (size_t)kSmemMax) continue;
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * unit_warps(g, N),
                                                          smem);
      if (err != cudaSuccess) return -(int)err;
      if (per_sm >= best_blocks && per_sm > 0) best_blocks = per_sm, best_stages = stages;
    }
    if (best_blocks < 1) return -(int)cudaErrorInvalidValue;
    const long long units = (long long)B * ((H + g - 1) / g);
    long long grid = (long long)sms * best_blocks;
    if (units < grid) grid = units;
    p[0] = (int)grid, p[1] = g, p[2] = best_stages, p[3] = best_blocks;
    cache.put(key, p);
  }
  for (int i = 0; i < 4; ++i) out[i] = p[i];
  out[4] = (int)fwd_smem<T, DK>(p[1], N, p[2]);
  out[5] = unit_warps(p[1], N);
  return 0;
}

template <typename T, int DK>
int run(const void* q, const void* k, const void* v, const void* wq, const void* bq,
        const void* wk, const void* bk, const void* wg1, const void* bg1, const void* wg2,
        const void* bg2, void* out, int B, int N, int H, int dk, int device,
        cudaStream_t stream) {
  int p[6];
  const int code = plan<T, DK>(B, N, H, dk, device, p);
  if (code < 0) return -code;
  const auto ct = [](const void* x) { return static_cast<const T*>(x); };
  const auto cf = [](const void* x) { return static_cast<const float*>(x); };
  FwdArgs<T> a;
  a.q = ct(q), a.k = ct(k), a.v = ct(v);
  a.w = Gates<T>{ct(wq), cf(bq), ct(wk), cf(bk), ct(wg1), cf(bg1), ct(wg2), cf(bg2)};
  a.out = static_cast<T*>(out);
  a.B = B, a.N = N, a.H = H, a.dk = dk, a.G = p[1], a.stages = p[2];
  a.inv = (float)(1.0 / std::sqrt((double)dk));
  kernel_for<T, DK>(p[5])<<<p[0], 32 * p[5], p[4], stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_plan(int B, int N, int H, int dk, int device, int (&out)[6]) {
  return dk <= 32 ? plan<T, 32>(B, N, H, dk, device, out)
                  : plan<T, 128>(B, N, H, dk, device, out);
}

bool valid(int B, int N, int H, int dk) {
  return B >= 1 && H >= 1 && N >= 1 && N <= kMaxN && dk >= 8 && dk <= kMaxDk && dk % 8 == 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// q, k, v, out (B, N, H dk) and the weights wq, wk, wg1, wg2 (dk, dk), torch's
// (out, in) layout, all fp32 or all bf16 (bf16 != 0); the biases bq, bk, bg1,
// bg2 (dk) fp32; contiguous, q, k, v and the weights 16-byte aligned.  1 <= N
// <= 64, 8 <= dk <= 128, dk % 8 == 0.  One launch on `stream` of CUDA device
// `device`; returns cudaGetLastError().
int itrx_agsa_fwd(const void* q, const void* k, const void* v, const void* wq, const void* bq,
                  const void* wk, const void* bk, const void* wg1, const void* bg1,
                  const void* wg2, const void* bg2, void* out, int B, int N, int H, int dk,
                  int bf16, int device, void* stream) {
  if (!valid(B, N, H, dk)) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, wq, wk, wg1, wg2}) {
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dk <= 32 ? run<__nv_bfloat16, 32>(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, out,
                                             B, N, H, dk, device, s)
                    : run<__nv_bfloat16, 128>(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, out,
                                              B, N, H, dk, device, s);
  }
  return dk <= 32 ? run<float, 32>(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, out, B, N, H,
                                   dk, device, s)
                  : run<float, 128>(q, k, v, wq, bq, wk, bk, wg1, bg1, wg2, bg2, out, B, N, H,
                                    dk, device, s);
}

// The launch itrx_agsa_fwd makes for these sizes: out = {grid, G (heads a
// unit), stages, blocks an SM, shared bytes a block, warps a block}; returns
// a CUDA error or 0.
int itrx_agsa_fwd_plan(int B, int N, int H, int dk, int bf16, int device, int* out) {
  if (!valid(B, N, H, dk)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int p[6];
  const int code = bf16 ? dispatch_plan<__nv_bfloat16>(B, N, H, dk, device, p)
                        : dispatch_plan<float>(B, N, H, dk, device, p);
  if (code < 0) return -code;
  for (int i = 0; i < 6; ++i) out[i] = p[i];
  return 0;
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
