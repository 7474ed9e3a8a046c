// The split-bf16 tensor-core products of the two SGRAF evaluation kernels,
// sgraf_eval_saf.cu (SAF) and sgraf_eval_sgr.cu (SGR), of the training
// alignment forward (sgraf_align.cu: the word nodes' projection, WordRows
// through mma_tile and tile_out) and backward (sgraf_align_bwd.cu: the same
// projection, with e kept through WordRows' sink, and mma_tile for ge), of
// the training reasoning backward (sgr_bwd.cu: mma_tile over listed node
// rows, and wgmma_m64n256 for its weight sums) and of the VSRN decoder
// kernels (vsrn_dec_loop.cuh's split; vsrn_dec_bwd.cu's mma_tile), over the node
// assembly of sgraf_nodes.cuh (`assemble`: the A tiles, the region softmax,
// the inverse context norms and the row list):
//   the word nodes   y = (ctx_l / |ctx_l| - cap_l)^2 . W + b,  ctx_l = sum_r s[l, r] img_r
//   the global node  y = (img_glo - cap_glo)^2 . Wg + bg
//   SGR's steps      X M + v  and  ctx Wg + bg  over the item's node rows
//
// What bounds them: these products, D x S multiply-adds per word row and
// S x S per node and step, which scalar fp32 FMAs ran at ~15 TFLOP/s.  The
// scores are held to the fp32 chain within 1e-5, so a one-pass TF32 or bf16
// product (11 or 8 bits) is not enough.  Each product here is three bf16
// passes on the tensor cores, a_hi b_lo + a_lo b_hi + a_hi b_hi, with x =
// hi + lo both bf16 rounded to nearest (about 16 bits kept; fp32
// accumulation; the scores land ~50x inside 1e-5).  A 3xTF32 split (21 bits)
// was built first: its hi/lo weight is 8 bytes an element against 4, and it
// needs twice the mma for the same work (PERF.md §6).
//
// The projection of a tile of at most 64 rows x S columns runs on
// wgmma.mma_async m64n128k16, one warpgroup per 128 columns, both operands in
// shared memory as K-major 8-row x 16-byte core matrices without swizzle
// (descriptors: 128 bytes between core matrices along k, 256 along the
// rows).  The depth runs in slabs of 32 (two k16 steps).  The wrapper splits
// the weight once a call into that layout, slab by slab, so a slab is one
// contiguous 32 KB bulk copy by the tensor memory accelerator, started by one
// thread and completed on the stage's mbarrier, through a 3-stage ring (with
// per-thread cp.async the copy's 2048 instructions an SM a slab had been a
// third of an iteration).  The operand slab (two buffers) is formed one slab
// ahead while the slab's wgmma run: warp w takes m-tile w % 4 and k16 step
// w / 4, its global inputs loaded into registers a slab before they are
// used; for a word row the context comes from its own small
// mma.sync.m16n8k16 (softmax weights, split once an item, x the image slab,
// staged by cp.async with rows padded against bank conflicts), whose
// accumulator fragment holds exactly the k the operand needs.  Rows are tiled
// in balanced tiles (130 rows: 48 + 48 + 34).  A finished tile leaves the
// registers through shared memory into the then idle weight ring, and the
// kernels' epilogues read it from there.  Sums run in a fixed order and
// nothing is atomic, so a launch is bit-identical to the last.

#pragma once

#include <cstdint>

#include "sgraf_nodes.cuh"

namespace itrx_sgraf_mma {

using namespace itrx_sgraf;

constexpr int kMmaRows = 64;                    // rows of one product tile
constexpr int kSlab = 32;                       // depth of one slab: two k16 steps
constexpr int kWStages = 3;                     // weight slabs in the ring
// one split slab row is kSlab 32-bit words (hi and lo bf16 of 32 k)
constexpr int kWStage = kMaxS * kSlab;          // one weight slab, S8 <= 256 rows (words)
constexpr int kAStage = kMmaRows * kSlab;       // one operand slab (words)
// one image slab: 72 rows of 32 elements, each row padded by 16 bytes so
// that the context's fragment loads (rows 2t apart) meet no bank conflict
template <typename T>
__host__ __device__ constexpr int img_row() { return kSlab + 16 / (int)sizeof(T); }
constexpr int kImgStage = kImgs * kR * (kSlab + 4);  // in floats (the fp32 size)
constexpr int kLdY = kMaxS + 8;                 // output row stride: fragment stores conflict-free
// shared memory, in 32-bit words: the softmax tiles at the front of the
// tile region and the image ring (2 stages) behind them; the weight ring,
// where assemble keeps its chain scratch and a finished tile's rows go; the
// two operand buffers
constexpr int kImgRing = kTileFloats;
constexpr int kWRing = kTileRegion;
constexpr int kA0 = kWRing + kWStages * kWStage;
constexpr int kMmaFloats = kA0 + 2 * kAStage;
static_assert(kImgRing + 2 * kImgStage <= kTileRegion, "the image ring fits behind the softmax");
static_assert(kImgs * kR * kR + kImgs * kR * kMaxCaps <= kWStages * kWStage, "chain scratch");
static_assert(kMmaRows * kLdY <= kWStages * kWStage + 2 * kAStage, "output rows fit the rings");
static_assert(kThreads == 256 && kMaxS == 256, "two warpgroups of 128 columns");

struct Ring {
  uint32_t* a;     // [2][kAStage] (one base: the compiler keeps it a shared address)
  uint32_t* w;     // [kWStages][kWStage]; after a tile, its rows [kMmaRows][kLdY] fp32
  float* img;      // [2][kImgs][kR][img_row<T>()] elements of the embedding type
};

__device__ __forceinline__ Ring ring_smem(float* smem) {
  uint32_t* u = reinterpret_cast<uint32_t*>(smem);
  return Ring{u + kA0, u + kWRing, smem + kImgRing};
}

// a per-column parameter, read where it is used: a volatile load, so that
// the compiler keeps no copy in registers across the tiles and items
__device__ __forceinline__ float ld_param(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// per tile row: what the operand producers need, set once a tile
struct RowTable {
  long long off0[kMmaRows];  // word: cap row; global: cap_glo row (elements)
  long long off1[kMmaRows];  // word: its image p; global: img_glo row
  float ci[kMmaRows];        // word: inverse context norm
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + lo, each a bf16 pair (x0 in the low half), rounded to nearest
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// d += a . b, one m16n8k16 bf16 product, fp32 accumulation
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A . B on the tensor cores, one warpgroup: m64n128k16, bf16 operands in
// shared memory (descriptors), fp32 accumulators d[i][q] at row
// 16 (warp % 4) + 8 (q / 2) + lane / 4, column 8i + 2 (lane % 4) + q % 2
__device__ __forceinline__ void wgmma_m64n128(float (&d)[16][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

// d += A . B on the tensor cores, one warpgroup: m64n256k16, bf16 operands in
// shared memory (descriptors), fp32 accumulators d[i][q] at row
// 16 (warp % 4) + 8 (q / 2) + lane / 4, column 8i + 2 (lane % 4) + q % 2
__device__ __forceinline__ void wgmma_m64n256(float (&d)[32][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(a), "l"(b), "r"(1));
}

// a descriptor of a K-major bf16 matrix in shared memory without swizzle:
// 8-row x 16-byte core matrices, `kstep` bytes apart along K and `rstep`
// bytes apart along the rows
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t kstep, uint32_t rstep) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)((kstep >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((rstep >> 4) & 0x3FFF) << 32);
}

// a split slab in shared memory: for k16 step st and part (0 hi, 1 lo) a
// K-major matrix of 8-row x 16-byte core matrices, [row / 8][k / 8][row % 8]
// [k % 8]: word offset of (row, k pair 2t..2t+1 of core column kg)
constexpr int kCoreWords = 8 * 16 / 4;          // one core matrix
__device__ __forceinline__ int core_word(int row, int kg, int t) {
  return (row / 8) * 2 * kCoreWords + kg * kCoreWords + (row % 8) * 4 + t;
}

// The softmax weights of the item's word rows, split once an item into the
// context product's operand fragments, in place over the softmax tiles:
// row i of the list at nd.tile + kSFragWords i, for 16-region step j and lane
// t the words (hi of regions 16j + 2t, +1; hi of 16j + 2t + 8, +9; their lo).
// Called by every thread after assemble; ends synchronized.
constexpr int kSFragWords = 3 * 4 * 4;
static_assert(kImgs * kCols * kSFragWords <= kTileFloats, "the fragments fit the softmax tiles");

__device__ __forceinline__ void split_softmax(const Nodes& nd) {
  const int i = threadIdx.x, n_loc = nd.n_rows[0];
  float sv[kR];
  if (i < n_loc) {
    const int code = nd.rows[i];
    const float* col = nd.tile + code / kCols * kRPad * kLdA + code % kCols;
#pragma unroll
    for (int r = 0; r < kR; ++r) sv[r] = col[r * kLdA];
  }
  __syncthreads();
  if (i < n_loc) {
    uint32_t* out = reinterpret_cast<uint32_t*>(nd.tile) + i * kSFragWords;
    const auto at = [&](int r) { return r < kR ? sv[r] : 0.0f; };
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int ra = 16 * j + 2 * t, rb = ra + 8;
        uint32_t ha, la, hb, lb;
        split2(at(ra), at(ra + 1), ha, la);
        split2(at(rb), at(rb + 1), hb, lb);
        *reinterpret_cast<uint4*>(out + 16 * j + 4 * t) = make_uint4(ha, hb, la, lb);
      }
  }
  __syncthreads();
}

__device__ __forceinline__ RowTable& row_table() {
  __shared__ RowTable table;
  return table;
}

// the rows of each tile when n rows are cut into balanced tiles
__device__ __forceinline__ int tile_step(int n) {
  const int tiles = max((n + kMmaRows - 1) / kMmaRows, 1);
  const int per = (n + tiles - 1) / tiles;
  return max(16, (per + 15) / 16 * 16);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0));
}

// The weight ring's completion barriers: one mbarrier per stage, which the
// bulk copy of a slab completes, and the parity of its next completion.
struct WeightBars {
  uint64_t bar[kWStages];
  uint32_t parity[kWStages];
};

__device__ __forceinline__ WeightBars& weight_bars() {
  __shared__ __align__(8) WeightBars bars;
  return bars;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// once a block, before any tile: every thread, ends synchronized
__device__ __forceinline__ void init_weight_bars() {
  WeightBars& wb = weight_bars();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWStages; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&wb.bar[i])));
      wb.parity[i] = 0;
    }
  }
  __syncthreads();
}

// weight slab `s` of wsplit into its ring stage by the tensor memory
// accelerator, started by thread 0: the slab is 4 matrices (step, part) of
// S8 rows x 32 bytes, contiguous in device memory, each landing at a
// stride of kMaxS rows (one copy when S8 == kMaxS)
__device__ __forceinline__ void stage_weight(const Ring& rg, const uint32_t* __restrict__ wsplit,
                                             int s, int S8) {
  if (threadIdx.x != 0) return;
  const int slot = s % kWStages;
  const uint32_t bar = smem_addr(&weight_bars().bar[slot]);
  const uint32_t bytes = 4 * S8 * 32;
  const char* src = reinterpret_cast<const char*>(wsplit + (size_t)s * S8 * kSlab);
  const uint32_t dst = smem_addr(rg.w + slot * kWStage);
  // the stage's last readers (generic loads of a tile's output rows, or the
  // products) are done: order their accesses before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
  const int pieces = S8 == kMaxS ? 1 : 4;
  const uint32_t piece = bytes / pieces;
  for (int m = 0; m < pieces; ++m) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst + m * kMaxS * 32),
        "l"(src + (size_t)m * piece), "r"(piece), "r"(bar) : "memory");
  }
}

// every thread: until weight slab `s` has landed (a bounded wait: a lost
// completion traps rather than hangs)
__device__ __forceinline__ void wait_weight(int s) {
  WeightBars& wb = weight_bars();
  const int slot = s % kWStages;
  const uint32_t bar = smem_addr(&wb.bar[slot]), parity = wb.parity[slot];
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) break;
    if (spins > (1u << 26)) __trap();
  }
}

// thread 0, after the barrier that follows every thread's wait_weight(s)
__device__ __forceinline__ void next_parity(int s) {
  if (threadIdx.x == 0) weight_bars().parity[s % kWStages] ^= 1u;
}

// this thread's place in a tile's accumulator: warpgroup wg takes columns
// 128 wg .. 128 wg + 127, warp w of it rows 16w .. 16w + 15
struct Frag {
  int wg, w, g, t;
  __device__ __forceinline__ Frag()
      : wg(threadIdx.x / 128), w(threadIdx.x / 32 % 4), g(threadIdx.x % 32 / 4),
        t(threadIdx.x % 4) {}
  __device__ __forceinline__ int row(int h) const { return 16 * w + 8 * h + g; }
  __device__ __forceinline__ int col(int i, int e) const { return 128 * wg + 8 * i + 2 * t + e; }
};

using Acc = float[16][4];

// keeps the compiler from moving accesses to the accumulators across this
// point (an asynchronous product owns them between its start and its wait)
template <int I>
__device__ __forceinline__ void fence_acc(float (&acc)[I][4]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+f"(acc[i][q])::"memory");
}

// acc (nrows x S8 of the tile) = operand (nrows x Kp) . W, W given split in
// the slab layout (S8 rows of Kp words).  prod supplies the operand:
//   prod.prepare()     every thread: the tile's row table
//   prod.stage(s)      every thread: cp.async of what slab s needs in shared
//                      memory (two stages), a slab before the operand is formed
//   prod.load(s)       warp w: global loads of its part of slab s into registers
//   prod.make(s, v)    warp w: its part of slab s, rows 16u + g and
//                      16u + g + 8 (u = w % 4), k 16st + 2t, 16st + 2t + 1,
//                      16st + 2t + 8, 16st + 2t + 9 (st = w / 4):
//                      v[4h + i] = row 16u + 8h + g, the i-th of those k
//                      (0 past the tile's rows or the depth)
// Starts and ends with a barrier.  kALo false: the operand is exact in its
// hi part (bf16 values), so its lo part is neither written nor multiplied
// (two passes); or the operand is to be rounded to bf16 (a bf16 product).
// kBLo false: W's lo part is zero (bf16 weights) and is not multiplied.
// (init_weight_bars first, once a block)
template <bool kALo = true, bool kBLo = true, typename Prod>
__device__ __forceinline__ void mma_tile(Acc& acc, const Ring& rg,
                                         const uint32_t* __restrict__ wsplit, int Kp, int S8,
                                         int nrows, Prod& prod) {
  const Frag f;
  const int warp = threadIdx.x / 32;
  const bool unit = 16 * (warp % 4) < nrows;
  const int nslab = Kp / kSlab;
  // this warpgroup's columns hold some of the S8 outputs
  const bool cols = 128 * f.wg < S8;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  fence_acc(acc);

  // operand slab s: warp w's part (m-tile w % 4, step w / 4), written split
  const auto fill = [&](int s) {
    float v[8];
    prod.make(s, v);
    const int u = warp % 4, st = warp / 4;
    uint32_t* a = rg.a + (s & 1) * kAStage + st * 2 * (kMmaRows * 8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * u + 8 * h + f.g;
      uint32_t hi0, lo0, hi1, lo1;
      split2(v[4 * h], v[4 * h + 1], hi0, lo0);
      split2(v[4 * h + 2], v[4 * h + 3], hi1, lo1);
      a[core_word(r, 0, f.t)] = hi0;
      a[core_word(r, 1, f.t)] = hi1;
      if constexpr (kALo) {
        a[kMmaRows * 8 + core_word(r, 0, f.t)] = lo0;
        a[kMmaRows * 8 + core_word(r, 1, f.t)] = lo1;
      }
    }
    if (s + 1 < nslab) prod.load(s + 1);
  };
  // acc += operand slab s . weight slab s: this warpgroup's 128 columns,
  // three passes per k16 step, started without waiting
  const auto product = [&](int s) {
    const uint32_t* as = rg.a + (s & 1) * kAStage;
    const uint32_t* ws = rg.w + (s % kWStages) * kWStage + f.wg * 16 * 2 * kCoreWords;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const uint64_t ah = smem_desc(as + (2 * st) * (kMmaRows * 8), 128, 256);
      const uint64_t al = smem_desc(as + (2 * st + 1) * (kMmaRows * 8), 128, 256);
      const uint64_t bh = smem_desc(ws + (2 * st) * (kMaxS * 8), 128, 256);
      const uint64_t bl = smem_desc(ws + (2 * st + 1) * (kMaxS * 8), 128, 256);
      if constexpr (kBLo) wgmma_m64n128(acc, ah, bl);
      if constexpr (kALo) wgmma_m64n128(acc, al, bh);
      wgmma_m64n128(acc, ah, bh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  __syncthreads();  // the previous tile's readers of the rings and the table are done
  prod.prepare();
  __syncthreads();  // the row table is set
  // the weight slabs come by bulk copies on the stages' mbarriers, slabs
  // 0 .. kWStages - 2 now, slab s + kWStages - 1 at iteration s; what the
  // rows stage (cp.async) comes in commit groups {slab 0}, {slab 1}, then
  // {slab s + 2} at iteration s, waited for a slab ahead
  for (int s = 0; s + 1 < kWStages && s < nslab; ++s) stage_weight(rg, wsplit, s, S8);
  prod.stage(0);
  asm volatile("cp.async.commit_group;\n" ::);
  if (1 < nslab) prod.stage(1);
  asm volatile("cp.async.commit_group;\n" ::);
  if (unit) prod.load(0);
  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();
  if (unit) fill(0);

  for (int s = 0; s < nslab; ++s) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    wait_weight(s);
    // weight slab s and slab s + 1's staging have landed, operand slab s is
    // written and made visible to the tensor cores' reads; every warp is
    // done with slab s - 1
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    next_parity(s);
    if (s + 2 < nslab) prod.stage(s + 2);
    asm volatile("cp.async.commit_group;\n" ::);
    if (s + kWStages - 1 < nslab) stage_weight(rg, wsplit, s + kWStages - 1, S8);
    // the products of slab s run while the warps form slab s + 1
    if (cols) product(s);
    if (unit && s + 1 < nslab) fill(s + 1);
    // unconditional (nothing pending is a no-op), so every path to the
    // accumulators passes a wait
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }
  __syncthreads();
}

// The tile's rows out of the registers into y = rg.w, [kMmaRows][kLdY] fp32:
// epi(y, n) takes rows 0 .. n - 1 of the tile (S8 columns), between barriers.
template <typename Epi>
__device__ __forceinline__ void tile_out(const Acc& acc, const Ring& rg, int nrows, Epi epi) {
  const Frag f;
  float* y = reinterpret_cast<float*>(rg.w);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (f.row(h) >= nrows) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      *reinterpret_cast<float2*>(y + f.row(h) * kLdY + f.col(i, 0)) =
          make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
    }
  }
  __syncthreads();
  epi(static_cast<const float*>(y), nrows);
  __syncthreads();
}

// warp w's rows and k of a slab: rows 16u + g (+ 8), u = w % 4; k16 step
// w / 4, k 2t, 2t + 1, 2t + 8, 2t + 9 of it
struct Part {
  int r0, k0, g, t;
  __device__ __forceinline__ Part(int s)
      : r0(16 * (threadIdx.x / 32 % 4) + threadIdx.x % 32 / 4),
        k0(kSlab * s + 16 * (threadIdx.x / 128) + 2 * (threadIdx.x % 4)),
        g(threadIdx.x % 32 / 4), t(threadIdx.x % 4) {}
  // the i-th k of the lane (0..3)
  __device__ __forceinline__ int k(int i) const { return k0 + (i & 1) + 8 * (i >> 1); }
};

// What becomes of e = ctx / |ctx| - cap as the word rows' operand is formed:
// nothing in the evaluation kernels and the training forward; the training
// backward keeps it
// (sgraf_align_bwd.cu).  sink(tile row, k, in range, e).
struct NoSink {
  __device__ __forceinline__ void operator()(int, int, bool, float) const {}
};

// Word rows t0 .. t0 + nrows - 1 of the list: the context slab from the
// softmax weights (nd.tile) and the image slab on the tensor cores, then
// (ctx / |ctx| - cap)^2.
template <typename T, typename Sink = NoSink>
struct WordRows {
  const Nodes& nd;
  const Ring& rg;
  const T* __restrict__ cap;
  const T* __restrict__ img;
  int t0, nrows, i0, c0, Ni, L, D;
  T pre[8];  // cap at the next slab's k of this lane, rows r0 and r0 + 8
  Sink sink;

  __device__ __forceinline__ void prepare() {
    RowTable& tb = row_table();
    const int r = threadIdx.x;
    if (r < nrows) {
      const int code = nd.rows[t0 + r], p = code / kCols, col = code % kCols;
      tb.off0[r] = ((long long)(c0 + col / L) * L + col % L) * D;
      tb.off1[r] = p;
      tb.ci[r] = nd.cinv[code];
    }
  }

  __device__ __forceinline__ void stage(int s) {
    const int k0 = kSlab * s;
    if (k0 >= D) return;
    T* dst = reinterpret_cast<T*>(rg.img + (s & 1) * kImgStage);
    constexpr int kRow = img_row<T>();
    if (sizeof(T) == 2 || D % 4 == 0) {
      constexpr int kVec = 16 / sizeof(T), kPerRow = kSlab / kVec;
      for (int idx = threadIdx.x; idx < kImgs * kR * kPerRow; idx += kThreads) {
        const int pr = idx / kPerRow, v = idx % kPerRow, p = pr / kR;
        const bool ok = i0 + p < Ni && k0 + kVec * v < D;
        cp_async16(dst + pr * kRow + kVec * v,
                   ok ? img + ((size_t)i0 * kR + pr) * D + k0 + kVec * v : img, ok);
      }
    } else {
      for (int idx = threadIdx.x; idx < kImgs * kR * kSlab; idx += kThreads) {
        const int pr = idx / kSlab, k = idx % kSlab, p = pr / kR;
        const bool ok = i0 + p < Ni && k0 + k < D;
        cp_async4(dst + pr * kRow + k, ok ? img + ((size_t)i0 * kR + pr) * D + k0 + k : img,
                  ok);
      }
    }
  }

  __device__ __forceinline__ void load(int s) {
    const RowTable& tb = row_table();
    const Part pt(s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = pt.r0 + 8 * h;
      const bool ok = r < nrows;
      const T* row = cap + (ok ? tb.off0[r] : 0);
      if constexpr (sizeof(T) == 2) {
        // D % 8 == 0: both k of a pair below D or neither, and 4-byte aligned
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const bool in = ok && pt.k(i) < D;
          const __nv_bfloat162 v = in ? *reinterpret_cast<const __nv_bfloat162*>(row + pt.k(i))
                                      : __floats2bfloat162_rn(0.0f, 0.0f);
          pre[4 * h + i] = v.x;
          pre[4 * h + i + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pre[4 * h + i] = (ok && pt.k(i) < D) ? row[pt.k(i)] : T(0.0f);
        }
      }
    }
  }

  __device__ __forceinline__ void make(int s, float (&v)[8]) {
    const RowTable& tb = row_table();
    const Part pt(s);
    const int r0 = pt.r0, r1 = r0 + 8, u = r0 / 16;
    const bool ok0 = r0 < nrows, ok1 = r1 < nrows;
    const int p0 = ok0 ? (int)tb.off1[r0] : -1, p1 = ok1 ? (int)tb.off1[r1] : -1;
    // the rows' softmax fragments (split_softmax), lane t's words
    const uint32_t* f0 = reinterpret_cast<const uint32_t*>(nd.tile) +
                         (t0 + (ok0 ? r0 : 0)) * kSFragWords + 4 * pt.t;
    const uint32_t* f1 = reinterpret_cast<const uint32_t*>(nd.tile) +
                         (t0 + (ok1 ? r1 : 0)) * kSFragWords + 4 * pt.t;
    // the images of the m-tile's rows, first to last (the list is in image order)
    const int p_first = (int)tb.off1[16 * u];
    const int p_last = (int)tb.off1[min(16 * u + 15, nrows - 1)];
    // this step's 16 columns of the image slab: n8 blocks 2st, 2st + 1
    constexpr int kRow = img_row<T>();
    const T* im = reinterpret_cast<const T*>(rg.img + (s & 1) * kImgStage) +
                  (pt.k0 - kSlab * s - 2 * pt.t) + pt.g;
    // the context per n8 block, its lo and hi passes in separate chains
    float clo[2][4] = {}, chi[2][4] = {};
    for (int p = p_first; p <= p_last; ++p) {
      const bool in0 = p0 == p, in1 = p1 == p;
      const T* ip = im + p * kR * kRow;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        // regions 16j + 2t, +1, +8, +9 of rows r0, r1 (past 35: zero), rows
        // of another image zero
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        const uint4 u0 = in0 ? *reinterpret_cast<const uint4*>(f0 + 16 * j) : z;
        const uint4 u1 = in1 ? *reinterpret_cast<const uint4*>(f1 + 16 * j) : z;
        const uint32_t ah[4] = {u0.x, u1.x, u0.y, u1.y}, al[4] = {u0.z, u1.z, u0.w, u1.w};
        const int ra = 16 * j + 2 * pt.t, rb = ra + 8;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const auto iv = [&](int r) { return r < kR ? to_f(ip[r * kRow + 8 * nb]) : 0.0f; };
          if constexpr (sizeof(T) == 2) {
            // bf16 values pack as they are: no lo part
            const auto pair = [&](int r) {
              const __nv_bfloat16 zero = __float2bfloat16(0.0f);
              return bits(__halves2bfloat162(r < kR ? ip[r * kRow + 8 * nb] : zero,
                                             r + 1 < kR ? ip[(r + 1) * kRow + 8 * nb] : zero));
            };
            const uint32_t b0 = pair(ra), b1 = pair(rb);
            mma16(clo[nb], al, b0, b1);
            mma16(chi[nb], ah, b0, b1);
          } else {
            uint32_t bh0, bl0, bh1, bl1;
            split2(iv(ra), iv(ra + 1), bh0, bl0);
            split2(iv(rb), iv(rb + 1), bh1, bl1);
            mma16(clo[nb], ah, bl0, bl1);
            mma16(clo[nb], al, bh0, bh1);
            mma16(chi[nb], ah, bh0, bh1);
          }
        }
      }
    }
    // clo[nb] + chi[nb] = ctx at (g, 8nb + 2t), (g, 8nb + 2t + 1), (g+8, ...)
    const float ci0 = ok0 ? tb.ci[r0] : 0.0f, ci1 = ok1 ? tb.ci[r1] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = (h ? ok1 : ok0) && pt.k(i) < D;
        const int nb = i >> 1, q = 2 * h + (i & 1);
        const float e = (clo[nb][q] + chi[nb][q]) * (h ? ci1 : ci0) - to_f(pre[4 * h + i]);
        v[4 * h + i] = ok ? e * e : 0.0f;
        sink(h ? r1 : r0, pt.k(i), ok, e);
      }
  }
};

// Global rows t0 .. t0 + nrows - 1 of the list (one per pair):
// (img_glo - cap_glo)^2.
template <typename T>
struct GlobalRows {
  const Nodes& nd;
  const T* __restrict__ gloc;
  const T* __restrict__ imgglo;
  int t0, nrows, i0, c0, D;
  T pre_i[8], pre_c[8];

  __device__ __forceinline__ void prepare() {
    RowTable& tb = row_table();
    const int r = threadIdx.x;
    if (r < nrows) {
      const int q = nd.rows[t0 + r] - kImgs * kCols;
      tb.off0[r] = (long long)(c0 + q % kMaxCaps) * D;
      tb.off1[r] = (long long)(i0 + q / kMaxCaps) * D;
    }
  }

  __device__ __forceinline__ void stage(int) {}

  __device__ __forceinline__ void load(int s) {
    const RowTable& tb = row_table();
    const Part pt(s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = pt.r0 + 8 * h;
      const bool ok = r < nrows;
      const T* cg = gloc + (ok ? tb.off0[r] : 0);
      const T* ig = imgglo + (ok ? tb.off1[r] : 0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = ok && pt.k(i) < D;
        pre_i[4 * h + i] = in ? ig[pt.k(i)] : T(0.0f);
        pre_c[4 * h + i] = in ? cg[pt.k(i)] : T(0.0f);
      }
    }
  }

  __device__ __forceinline__ void make(int, float (&v)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = to_f(pre_i[i]) - to_f(pre_c[i]);
      v[i] = e * e;
    }
  }
};

// Rows t0 .. t0 + nrows - 1 of an fp32 (rows, S) matrix in device memory
struct SrcRows {
  const float* src;
  int t0, nrows, S;
  float2 pre[4];

  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ void stage(int) {}

  __device__ __forceinline__ void load(int s) {
    const Part pt(s);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // S % 4 == 0: k and k + 1 both below S or neither
        const int r = pt.r0 + 8 * h, k = pt.k(2 * i);
        pre[2 * h + i] = (r < nrows && k < S)
                             ? *reinterpret_cast<const float2*>(src + (size_t)(t0 + r) * S + k)
                             : make_float2(0.0f, 0.0f);
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

// The node projections of an item: the word rows with (wsplit, bias), then
// the global rows with (gsplit, gbias), both split (S8 rows of Kp words).
// Each tile goes out through tile_out: epi(y, t, n, bias) takes rows t ..
// t + n - 1 of nd.rows, y = their products without the bias (S8 columns,
// stride kLdY).
template <typename T, typename Epi>
__device__ __forceinline__ void project_mma(const Nodes& nd, const Ring& rg,
                                            const T* __restrict__ cap,
                                            const T* __restrict__ img,
                                            const T* __restrict__ gloc,
                                            const T* __restrict__ imgglo,
                                            const uint32_t* __restrict__ wsplit,
                                            const float* __restrict__ bias,
                                            const uint32_t* __restrict__ gsplit,
                                            const float* __restrict__ gbias, int i0, int c0,
                                            int Ni, int L, int D, int Kp, int S8, Epi epi) {
  const int n_loc = nd.n_rows[0], n_all = nd.n_rows[0] + nd.n_rows[1];
  split_softmax(nd);
  Acc acc;
  if (n_loc > 0) {
    const int step = tile_step(n_loc);
    for (int t0 = 0; t0 < n_loc; t0 += step) {
      WordRows<T> prod{nd, rg, cap, img, t0, min(step, n_loc - t0), i0, c0, Ni, L, D};
      mma_tile(acc, rg, wsplit, Kp, S8, prod.nrows, prod);
      tile_out(acc, rg, prod.nrows, [&](const float* y, int n) { epi(y, t0, n, bias); });
    }
  }
  if (n_all > n_loc) {
    const int step = tile_step(n_all - n_loc);
    for (int t0 = n_loc; t0 < n_all; t0 += step) {
      GlobalRows<T> prod{nd, gloc, imgglo, t0, min(step, n_all - t0), i0, c0, D};
      mma_tile(acc, rg, gsplit, Kp, S8, prod.nrows, prod);
      tile_out(acc, rg, prod.nrows, [&](const float* y, int n) { epi(y, t0, n, gbias); });
    }
  }
}

}  // namespace itrx_sgraf_mma
