// Shared by the SGR training kernels, sgr.cu (forward) and sgr_bwd.cu
// (backward): the node layout, the S x S products over listed rows, the
// per-warp row helpers of the edge passes and the plan kernels that list
// the rows.
//
// Nodes lie as the caller holds them, (B, N, S) with row p * N + j for node j
// of pair p; a row is valid where the node mask is > 0.  The plan kernels
// list the rows on the card (the valid rows in order, then the masked ones,
// and each pair's first row in that list; their plain version is
// ops/kernels/sgr.py::row_list), and every S x S product runs over the
// valid part of the list only: `row_tile`
// takes 64 listed rows a block through sgraf_nodes_mma.cuh's split-bf16
// `wgmma` tile product (the weight split once a call and staged by TMA), so
// masked rows cost nothing.  The edge passes run one warp a node row: lane l
// holds columns 4l .. 4l+3 and 128 + 4l .. 128 + 4l + 3 of a row (S <= 256).

#pragma once

#include "sgraf_nodes.cuh"
#include "sgraf_nodes_mma.cuh"

namespace itrx_sgr {

using namespace itrx_sgraf;
using namespace itrx_sgraf_mma;

constexpr int kMaxN = 129;                  // nodes a pair: 128 words + the global node
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// four elements of a row (16 bytes fp32, 8 bytes bf16) by cp.async, zeros
// where !ok
__device__ __forceinline__ void cp_async_4(float* smem, const float* gmem, bool ok) {
  cp_async16(smem, gmem, ok);
}
__device__ __forceinline__ void cp_async_4(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                           bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(ok ? 8 : 0));
}

// ---------------------------------------------------------------- rows
// the row products' shared memory: the weight ring (a finished tile's rows
// go there) and the two operand buffers, 112 KB: two blocks an SM
constexpr int kRowsBytes = (kWStages * kWStage + 2 * kAStage) * 4;

// Rows t0 .. t0 + nrows - 1 of the list as mma_tile's operand: src (B N, S)
// gathered at the listed rows, zero where `gate` is not > 0 (kGate; the
// gated rows are written to gated, for the weight sums).  src is not
// __restrict__: the forward's second product writes its output over it.
template <typename T, bool kGate>
struct ListRows {
  const T* src;
  const float* __restrict__ gate;
  float* __restrict__ gated;
  const int* __restrict__ rows;
  int* row_at;  // [kMmaRows] the tile's rows (shared memory)
  int t0, nrows, S;
  float2 pre[4];

  __device__ __forceinline__ void prepare() {
    if ((int)threadIdx.x < nrows) row_at[threadIdx.x] = rows[t0 + threadIdx.x];
  }
  __device__ __forceinline__ void stage(int) {}

  __device__ __forceinline__ void load(int s) {
    const Part pt(s);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // S % 4 == 0: k and k + 1 both below S or neither
        const int r = pt.r0 + 8 * h, k = pt.k(2 * i);
        float2 v = make_float2(0.0f, 0.0f);
        if (r < nrows && k < S) {
          const size_t o = (size_t)row_at[r] * S + k;
          v = load2(src + o);
          if constexpr (kGate) {
            const float2 gt = load2(gate + o);
            v.x = gt.x > 0.0f ? v.x : 0.0f;
            v.y = gt.y > 0.0f ? v.y : 0.0f;
            *reinterpret_cast<float2*>(gated + o) = v;
          }
        }
        pre[2 * h + i] = v;
      }
  }

  __device__ __forceinline__ void make(int, float (&v)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = pre[i].x;
      v[2 * i + 1] = pre[i].y;
    }
  }
};

// dst[r] = epi(src'[r] . W + bias + add[r]) for the listed rows r of tile
// blockIdx.x, epi the ReLU where `relu`, W split (S8 rows of Ks words);
// bias (S,) and add (B N, S) may be null; kALo false where src is bf16
// (exact in its hi part).  dst may be src: every operand row is read before
// the tile's rows are written, and no other block reads them.  After
// init_weight_bars.
template <bool kALo, typename T, bool kGate>
__device__ __forceinline__ void row_tile(const T* src, const float* __restrict__ gate,
                                         float* __restrict__ gated,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ add, bool relu, float* dst,
                                         const int* __restrict__ rows, int n_rows, int* row_at,
                                         const uint32_t* __restrict__ wsplit, int S, int Ks,
                                         int S8) {
  extern __shared__ __align__(128) float smem[];
  uint32_t* const u = reinterpret_cast<uint32_t*>(smem);
  const Ring rg{u + kWStages * kWStage, u, smem};
  const int t0 = blockIdx.x * kMmaRows;
  ListRows<T, kGate> prod{src, gate, gated, rows, row_at, t0, min(kMmaRows, n_rows - t0), S,
                          {}};
  Acc acc;
  mma_tile<kALo>(acc, rg, wsplit, Ks, S8, prod.nrows, prod);
  tile_out(acc, rg, prod.nrows, [&](const float* y, int n) {
    // a warp per row, four columns a lane
    const int lane = threadIdx.x % 32;
    for (int i = threadIdx.x / 32; i < n; i += kWarps) {
      const size_t o = (size_t)row_at[i] * S;
      for (int c = 4 * lane; c < S; c += 128) {
        float4 v = *reinterpret_cast<const float4*>(y + i * kLdY + c);
        if (bias != nullptr) {
          const float4 b = load4(bias + c);
          v.x += b.x;
          v.y += b.y;
          v.z += b.z;
          v.w += b.w;
        }
        if (add != nullptr) {
          const float4 a = load4(add + o + c);
          v.x += a.x;
          v.y += a.y;
          v.z += a.z;
          v.w += a.w;
        }
        if (relu) {
          v.x = fmaxf(v.x, 0.0f);
          v.y = fmaxf(v.y, 0.0f);
          v.z = fmaxf(v.z, 0.0f);
          v.w = fmaxf(v.w, 0.0f);
        }
        *reinterpret_cast<float4*>(dst + o + c) = v;
      }
    }
  });
}

// ---------------------------------------------------------------- edges
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

// the lane's share of a row dot product (row_dot before its warp sum)
__device__ __forceinline__ float row_part(const Row8& x, const Row8& y) {
  return ((x.a.x * y.a.x + x.a.y * y.a.y) + (x.a.z * y.a.z + x.a.w * y.a.w)) +
         ((x.b.x * y.b.x + x.b.y * y.b.y) + (x.b.z * y.b.z + x.b.w * y.b.w));
}

// the whole warp's dot product of two rows
__device__ __forceinline__ float row_dot(const Row8& x, const Row8& y) {
  return warp_sum(row_part(x, y));
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

// One halving level of warp_sums and the levels after it: lanes whose bit
// O is set keep the upper H of the live shares and send the lower H to
// their partner (H and O compile-time, so p stays in registers).
template <int H, int O>
__device__ __forceinline__ void halve(float (&p)[32], int lane) {
  if constexpr (H >= 1) {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? p[i] : p[H + i];
      p[i] = (up ? p[H + i] : p[i]) + __shfl_xor_sync(0xffffffffu, send, O);
    }
    halve<H / 2, O / 2>(p, lane);
  }
}

// 32 lane shares p[0 .. 32) summed over the warp by recursive halving (31
// shuffles, not 160): lane l ends with the sum of value l, in a fixed order
__device__ __forceinline__ float warp_sums(float (&p)[32]) {
  halve<16, 16>(p, threadIdx.x % 32);
  return p[0];
}

// the rows of one operand of a pair: staged in shared memory (node b of the
// pair at p + b S) or in device memory (at p + vidx[b] S)
template <typename T, bool kStaged>
struct PairRows {
  const T* p;
  const int* vidx;
  int S;
  __device__ __forceinline__ Row8 operator()(int b) const {
    return load_row(p + (size_t)(kStaged ? b : vidx[b]) * S, S);
  }
};

// ---------------------------------------------------------------- batches
// The edge passes (edge_kernel of sgr.cu and of sgr_bwd.cu) stage whole
// pairs in batches: block b takes pairs bounds[b] .. bounds[b + 1] - 1 of
// the plan in order, a batch as many whole pairs as fit its cap rows (their
// rows are contiguous in the list, pair q at pstart[q]), and runs one warp
// a unit of two rows of a pair.  Each pass's staged operands and unit work
// are its own; the batch cut, the row tables and the unit list are these.
constexpr int kEdgeBytes = 110 * 1024;  // a batch's staged rows and tables: two blocks an SM

struct Batch {
  int q1;  // the pair after the batch
  int r0;  // its first row in the list
  int R;   // its rows
};

// The batch from pair q0 of a range that ends before p1 (at least one pair),
// and for each of its rows the row's pair's first row (kst) and rows (kn),
// batch-relative.  Every thread; a barrier before the tables are read.
__device__ __forceinline__ Batch next_batch(int q0, int p1, const int* __restrict__ pstart,
                                            int cap, int* kst, int* kn) {
  const int r0 = pstart[q0];
  int q1 = q0 + 1;
  while (q1 < p1 && pstart[q1 + 1] - r0 <= cap) ++q1;
  for (int q = q0 + (int)threadIdx.x; q < q1; q += kThreads) {
    const int a = pstart[q] - r0, n = pstart[q + 1] - pstart[q];
    for (int j = 0; j < n; ++j) {
      kst[a + j] = a;
      kn[a + j] = n;
    }
  }
  return Batch{q1, r0, pstart[q1] - r0};
}

// The units of a batch of R rows, rows 0, 2, 4, .. of each pair in order,
// into units, and their count into *n_units.  Warp 0, after the barrier
// that follows next_batch; a barrier before they are read.
__device__ __forceinline__ void pair_units(const int* kst, int R, int* units, int* n_units) {
  const int lane = threadIdx.x % 32;
  int nu = 0;
  for (int rb = 0; rb < R; rb += 32) {
    const int r = rb + lane;
    const bool lead = r < R && (r - kst[r]) % 2 == 0;
    const unsigned bal = __ballot_sync(0xffffffffu, lead);
    if (lead) units[nu + __popc(bal & ((1u << lane) - 1u))] = r;
    nu += __popc(bal);
  }
  if (lane == 0) *n_units = nu;
}

// ---------------------------------------------------------------- the list
// The row list, each pair's first row in it and the edge pass's pair ranges,
// exactly as ops/kernels/sgr.py::row_list and edge_bounds (their plain
// versions) form them with some thirty small torch operations, whose host
// time exceeded the forward kernels' own (PERF.md §6).  Two launches:
// plan_kernel, one block over the pairs in chunks of kPlanThreads (each
// chunk's mask flags staged in shared memory by 16-byte loads, kPlanThreads
// x N bytes), scans their valid counts n and edge costs n (n + 4) with a
// running carry into pstart and the cost prefix, then gives each edge block
// its first pair, the first whose cost before it reaches b / blocks of the
// total; plan_rows_kernel, a warp a pair over the whole card, writes the
// pair's valid rows at its start and its masked rows after the count, in
// row order, ranked by ballot (a warp's stores land together: from one
// block, the scattered stores of the rows took ~0.1 ms).  The plan
// workspace (int32): prefix (B + 1 int64), rows (B N), pstart (B + 1),
// bounds (blocks + 1).
constexpr int kPlanThreads = 1024;
constexpr int kPlanRowWarps = 8;  // pairs a block of plan_rows_kernel

struct Plan {
  long long* prefix;
  int *rows, *pstart, *bounds;
};

__host__ __device__ inline Plan plan_of(void* plan, int B, int N) {
  long long* prefix = static_cast<long long*>(plan);
  int* rows = reinterpret_cast<int*>(prefix + B + 1);
  int* pstart = rows + (size_t)B * N;
  return Plan{prefix, rows, pstart, pstart + B + 1};
}

// inclusive scan over the block's 32 warps of (n, c); each warp's inclusive
// total is left in wn / wc
__device__ __forceinline__ void plan_scan(int& n, long long& c, int* wn, long long* wc) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int yn = __shfl_up_sync(0xffffffffu, n, o);
    const long long yc = __shfl_up_sync(0xffffffffu, c, o);
    if (lane >= o) {
      n += yn;
      c += yc;
    }
  }
  if (lane == 31) {
    wn[warp] = n;
    wc[warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    int xn = wn[lane];
    long long xc = wc[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int yn = __shfl_up_sync(0xffffffffu, xn, o);
      const long long yc = __shfl_up_sync(0xffffffffu, xc, o);
      if (lane >= o) {
        xn += yn;
        xc += yc;
      }
    }
    wn[lane] = xn;
    wc[lane] = xc;
  }
  __syncthreads();
  if (warp > 0) {
    n += wn[warp - 1];
    c += wc[warp - 1];
  }
}

// the flags of pairs p0 .. p0 + kPlanThreads - 1 (fewer at the end) into
// flag, between barriers; 16-byte loads where the chunk is aligned (p0 N is
// a multiple of 4)
__device__ __forceinline__ void plan_flags(const float* __restrict__ mask, int p0, int B, int N,
                                           unsigned char* flag) {
  __syncthreads();
  const float* m = mask + (size_t)p0 * N;
  const int ne = min(kPlanThreads, B - p0) * N;
  const int n4 = reinterpret_cast<uintptr_t>(m) % 16 == 0 ? ne / 4 : 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < n4; i += kPlanThreads) {
    const float4 v = reinterpret_cast<const float4*>(m)[i];
    *reinterpret_cast<unsigned*>(flag + 4 * i) =
        (v.x > 0.0f ? 1u : 0u) | (v.y > 0.0f ? 1u << 8 : 0u) | (v.z > 0.0f ? 1u << 16 : 0u) |
        (v.w > 0.0f ? 1u << 24 : 0u);
  }
  for (int e = 4 * n4 + threadIdx.x; e < ne; e += kPlanThreads) flag[e] = m[e] > 0.0f ? 1 : 0;
  __syncthreads();
}

__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const float* __restrict__ mask, int B, int N, int blocks, void* plan) {
  extern __shared__ __align__(16) unsigned char flag[];  // [kPlanThreads][N]
  __shared__ int wn[32];
  __shared__ long long wc[32];
  const Plan pl = plan_of(plan, B, N);
  const int tid = threadIdx.x;
  int carry_n = 0;
  long long carry_c = 0;
  for (int p0 = 0; p0 < B; p0 += kPlanThreads) {
    plan_flags(mask, p0, B, N, flag);
    const int p = p0 + tid;
    int n0 = 0;
    if (p < B) {
      for (int j = 0; j < N; ++j) n0 += flag[tid * N + j];
    }
    const long long c0 = (long long)n0 * (n0 + 4);
    int n = n0;
    long long c = c0;
    plan_scan(n, c, wn, wc);
    if (p < B) {
      pl.pstart[p] = carry_n + n - n0;
      pl.prefix[p] = carry_c + c - c0;
    }
    carry_n += wn[31];
    carry_c += wc[31];
  }
  if (tid == 0) {
    pl.pstart[B] = carry_n;
    pl.prefix[B] = carry_c;
  }
  __syncthreads();  // the prefix is written
  for (int b = tid; b <= blocks; b += kPlanThreads) {
    int lo = 0, hi = B;
    if (b == blocks) {
      lo = B;
    } else {
      // the first i with prefix[i] >= b total / blocks (prefix[B] is the total)
      const long long t = (long long)b * carry_c / blocks;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (pl.prefix[mid] >= t) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
    }
    pl.bounds[b] = lo;
  }
}

// pair blockIdx.x kPlanRowWarps + warp's rows into the list (after
// plan_kernel)
__global__ void __launch_bounds__(kPlanRowWarps * 32)
plan_rows_kernel(const float* __restrict__ mask, int B, int N, void* plan) {
  const Plan pl = plan_of(plan, B, N);
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * kPlanRowWarps + threadIdx.x / 32;
  if (p >= B) return;
  int v = pl.pstart[p];                // the pair's next valid row's place
  int m = pl.pstart[B] + p * N - v;    // and its next masked row's
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int j = j0 + lane, r = p * N + j;
    const bool in = j < N;
    const bool ok = in && mask[r] > 0.0f;
    const unsigned bv = __ballot_sync(0xffffffffu, ok), bm = __ballot_sync(0xffffffffu, in && !ok);
    if (ok) {
      pl.rows[v + __popc(bv & below)] = r;
    } else if (in) {
      pl.rows[m + __popc(bm & below)] = r;
    }
    v += __popc(bv);
    m += __popc(bm);
  }
}

// The two launches of the plan; returns the first CUDA error or 0.
inline int launch_plan(const float* mask, int B, int N, int blocks, void* plan,
                       cudaStream_t stream) {
  const int smem = kPlanThreads * N;
  cudaError_t err =
      cudaFuncSetAttribute(plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  plan_kernel<<<1, kPlanThreads, smem, stream>>>(mask, B, N, blocks, plan);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  plan_rows_kernel<<<(unsigned)((B + kPlanRowWarps - 1) / kPlanRowWarps), kPlanRowWarps * 32, 0,
                     stream>>>(mask, B, N, plan);
  return (int)cudaGetLastError();
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

}  // namespace itrx_sgr
