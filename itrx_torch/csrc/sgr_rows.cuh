// Shared by the SGR training kernels, sgr.cu (forward) and sgr_bwd.cu
// (backward): the node layout and the per-warp row helpers of the edge
// passes; and the forward's S x S product over the listed rows (the
// backward runs its products on the tensor cores, sgraf_nodes_mma.cuh).
//
// Nodes lie as the caller holds them, (B, N, S) with row p * N + j for node j
// of pair p; a row is valid where the node mask is > 0.  The wrapper lists the
// valid rows (int32, in order), and every S x S product runs over that list
// only: `rows_kernel` takes 64 listed rows a block through the 64-row fp32
// tile product of sgraf_nodes.cuh (the weight staged by cp.async in slabs of
// 32, the operand transposed in shared memory, a 32 x 2 corner of the 64 x S
// tile a thread), so masked rows cost nothing and are never written.  The
// edge passes run one warp a node row: lane l holds columns 4l .. 4l+3 and
// 128 + 4l .. 128 + 4l + 3 of a row (S <= 256).

#pragma once

#include "sgraf_nodes.cuh"

namespace itrx_sgr {

using namespace itrx_sgraf;

constexpr int kMaxN = 129;                  // nodes a pair: 128 words + the global node
constexpr int kWarps = kThreads / 32;
// the tile product's dynamic shared memory: two weight slabs, the operand slab
constexpr int kRowsSmemBytes = (kXFloats + kDiffFloats) * 4;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// A row's two column groups in this lane (zero past S).
struct Row8 {
  float4 a, b;
};

template <typename T>
__device__ __forceinline__ Row8 load_row(const T* row, int S) {
  const int ca = 4 * (threadIdx.x % 32), cb = 128 + ca;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return Row8{ca < S ? load4(row + ca) : z, cb < S ? load4(row + cb) : z};
}

__device__ __forceinline__ void store_row(float* row, const Row8& r, int S) {
  const int ca = 4 * (threadIdx.x % 32), cb = 128 + ca;
  if (ca < S) *reinterpret_cast<float4*>(row + ca) = r.a;
  if (cb < S) *reinterpret_cast<float4*>(row + cb) = r.b;
}

// the whole warp's dot product of two rows
__device__ __forceinline__ float row_dot(const Row8& x, const Row8& y) {
  return warp_sum(((x.a.x * y.a.x + x.a.y * y.a.y) + (x.a.z * y.a.z + x.a.w * y.a.w)) +
                  ((x.b.x * y.b.x + x.b.y * y.b.y) + (x.b.z * y.b.z + x.b.w * y.b.w)));
}

// acc += c * x
__device__ __forceinline__ void row_fma(Row8& acc, float c, const Row8& x) {
  acc.a.x = fmaf(c, x.a.x, acc.a.x); acc.a.y = fmaf(c, x.a.y, acc.a.y);
  acc.a.z = fmaf(c, x.a.z, acc.a.z); acc.a.w = fmaf(c, x.a.w, acc.a.w);
  acc.b.x = fmaf(c, x.b.x, acc.b.x); acc.b.y = fmaf(c, x.b.y, acc.b.y);
  acc.b.z = fmaf(c, x.b.z, acc.b.z); acc.b.w = fmaf(c, x.b.w, acc.b.w);
}

__device__ __forceinline__ Row8 row_zero() {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return Row8{z, z};
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The valid nodes of one pair (mask row m of N entries) into vidx[0 .. n), in
// order, by warp 0; returns n to every thread.  Ends synchronized.
__device__ __forceinline__ int list_nodes(const float* __restrict__ m, int N, int* vidx,
                                          int* n_s) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int j = 0; j < N; j += 32) {
      const bool ok = j + lane < N && m[j + lane] > 0.0f;
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) vidx[n + __popc(bal & ((1u << lane) - 1u))] = j + lane;
      n += __popc(bal);
    }
    if (lane == 0) *n_s = n;
  }
  __syncthreads();
  return *n_s;
}

// dst[r] = epi(src'[r] . W + bias + add[r]) for the listed rows r, where
// src'[r] is src[r], or src[r] where gate[r] > 0 and 0 elsewhere (the ReLU's
// adjoint) when `gate` is given; W (S x S, (in, out), 16-byte aligned); bias
// and add may be null; epi is the ReLU when `relu`.  64 listed rows a block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ src, const float* __restrict__ gate,
            const int* __restrict__ rows, int n_rows, const float* __restrict__ wmat,
            const float* __restrict__ bias, const float* __restrict__ add,
            float* __restrict__ dst, int S, int relu) {
  extern __shared__ __align__(128) float smem[];
  Nodes nd{};
  nd.xbuf = smem;
  nd.diff_t = smem + kXFloats;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTileRows;
  const int nrows = min(kTileRows, n_rows - t0);
  const int h = tid / (kThreads / 2), cp = tid % (kThreads / 2);
  const int r = tid % kTileRows;
  const size_t src_row = r < nrows ? (size_t)rows[t0 + r] * S : 0;
  const auto row = [&](int k0, int dk, float (&dv)[8]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + dk + 4 * j;
      const bool ok = r < nrows && k < S;
      float4 v = ok ? load4(src + src_row + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gate != nullptr && ok) {
        const float4 g = load4(gate + src_row + k);
        v.x = g.x > 0.0f ? v.x : 0.0f;
        v.y = g.y > 0.0f ? v.y : 0.0f;
        v.z = g.z > 0.0f ? v.z : 0.0f;
        v.w = g.w > 0.0f ? v.w : 0.0f;
      }
      dv[4 * j] = v.x;
      dv[4 * j + 1] = v.y;
      dv[4 * j + 2] = v.z;
      dv[4 * j + 3] = v.w;
    }
  };
  float acc[32][2];
  tile_product(acc, wmat, S, S, nd, 32 * h < nrows, [](int) {}, row);
  if (2 * cp >= S) return;
  const float b0 = bias != nullptr ? bias[2 * cp] : 0.0f;
  const float b1 = bias != nullptr ? bias[2 * cp + 1] : 0.0f;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int tr = 32 * h + q;
    if (tr < nrows) {
      const size_t o = (size_t)rows[t0 + tr] * S + 2 * cp;
      float y0 = acc[q][0] + b0, y1 = acc[q][1] + b1;
      if (add != nullptr) {
        const float2 a = *reinterpret_cast<const float2*>(add + o);
        y0 += a.x;
        y1 += a.y;
      }
      if (relu) {
        y0 = fmaxf(y0, 0.0f);
        y1 = fmaxf(y1, 0.0f);
      }
      *reinterpret_cast<float2*>(dst + o) = make_float2(y0, y1);
    }
  }
}

// One launch of rows_kernel; returns cudaGetLastError().
template <typename T>
int rows_product(const T* src, const float* gate, const int* rows, int n_rows,
                 const float* wmat, const float* bias, const float* add, float* dst, int S,
                 bool relu, cudaStream_t stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowsSmemBytes);
  if (err != cudaSuccess) return (int)err;
  rows_kernel<T><<<(unsigned)((n_rows + kTileRows - 1) / kTileRows), kThreads, kRowsSmemBytes,
                   stream>>>(src, gate, rows, n_rows, wmat, bias, add, dst, S, (int)relu);
  return (int)cudaGetLastError();
}

}  // namespace itrx_sgr
