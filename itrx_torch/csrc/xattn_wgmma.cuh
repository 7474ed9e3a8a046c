// The A product of the two SCAN score-grid kernels, xattn.cu (t2i) and
// xattn_i2t.cu (i2t), from a TMA ring on Hopper's tensor cores (wgmma for
// bf16, fp64 mma.sync for fp32), and the host side that sets it up.
//
// A tile is up to 128 word rows of whole captions (two m64 halves, one a
// warpgroup each) against K whole images side by side, N = 36 K columns
// (no region padding): A[word, 36 p + r] = cap_word . img_{i0 + p, r}.  The
// caption rows of a group are contiguous in the (Nc L, D) view of the
// captions and a group of images in the (Ni 36, D) view, so a chunk of D is
// one 2-D TMA box of each (128-byte swizzle), landed on a stage's mbarrier.
// The ring has 2-4 stages; thread 0 refills a stage (the chunk S positions
// later in the block's stream of tiles and chunks) as soon as every
// warp has released it, which each warp does when the product of
// the next stage is in flight: no block-wide barrier a chunk.  The grid is
// persistent: one block an SM walks the tiles, runs of kRun image groups
// sweeping the caption groups (so the tiles in flight share a few image and
// caption groups, read from L2), and the first stages of the next tile load
// while the current tile's chain runs.  A separate producer warp was built
// first: with 9 (or 12) warps an SM a thread gets 168 registers (one of the
// four register files holds 3 warps), and the t2i chain spilled.
//
// bf16 inputs: wgmma m64n216k16 (K = 6 images), both operands in shared
// memory.  fp32 inputs: fp64 mma.sync m8n8k4 on the tensor cores (K = 4
// images, N = 144), both operands as fp64 copies the wrapper makes once a
// call (8-byte elements, 16 a chunk), so that A is the exact dot product
// rounded once: the t2i grid holds an fp32 pair whose score moves by 1.5e-6
// with the order of an fp32 sum, and three TF32 passes on wgmma read 1.2e-6
// to 2.4e-6 on it against the 1e-6 limit.
//
// Accumulator layout (one warpgroup, m64nN): warp w of the warpgroup holds
// rows 16 w + g and 16 w + g + 8 (g = lane / 4), columns 8 i + 2 t + e
// (t = lane % 4, e = 0, 1) in d[i][2 h + e] for row 16 w + 8 h + g.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace itrx_xwg {

constexpr int kR = 36;                     // regions per image
constexpr int kRows = 128;                 // word rows of a tile
constexpr int kThreads = 256;              // two warpgroups
constexpr int kRun = 16;                   // image groups a run of the tile order sweeps
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;           // dynamic shared memory a block may use
constexpr float kEps = 1e-8f;

// per input type: images a tile (K), N = 36 K, the operand type the TMA
// boxes hold (fp32 inputs come as fp64 copies from the wrapper), the depth
// of a chunk (one 128-byte row of a box)
template <typename T>
struct Mode;
template <>
struct Mode<__nv_bfloat16> {
  using Elem = __nv_bfloat16;
  static constexpr int K = 6;
  static constexpr int kChunk = 64;
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Mode<float> {
  using Elem = double;
  static constexpr int K = 4;
  static constexpr int kChunk = 16;
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
};
template <typename T>
constexpr int kN = kR * Mode<T>::K;
template <typename T>
constexpr int kNG = kN<T> / 8;                          // 8-column groups of a row
constexpr int kCapBytes = kRows * 128;                  // a stage's caption box
template <typename T>
constexpr int kImgBytes = kN<T> * 128;                  // a stage's image box (a plane)
template <typename T>
constexpr int kStageBytes = kCapBytes + kImgBytes<T>;
static_assert(kImgBytes<__nv_bfloat16> % 1024 == 0 && kImgBytes<float> % 1024 == 0,
              "boxes start on 1024-byte swizzle atoms");

// the launch's cut of the grid, the same on host and device
struct Plan {
  int Ni, Nc, L, D;
  int cpb;      // captions a group: whole captions, cpb L <= 128 rows
  int n_cg;     // caption groups
  int n_ig;     // image groups of K
  int n_items;  // tiles
  int n_ch;     // chunks of D
  int stages;   // ring stages
};

// tile `item`'s image group and caption group: runs of kRun image groups
// sweep the caption groups
__device__ __forceinline__ void tile_origin(int item, const Plan& pl, int* ig, int* cg) {
  const int run = item / (kRun * pl.n_cg);
  const int ig0 = run * kRun;
  const int run_len = min(kRun, pl.n_ig - ig0);
  const int rem = item - run * kRun * pl.n_cg;
  *ig = ig0 + rem % run_len;
  *cg = rem / run_len;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

struct Bars {
  uint64_t full[kMaxStages];   // thread 0's expect_tx + the TMA bytes
  uint64_t empty[kMaxStages];  // one arrival per warp
};

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count));
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}

// until the phase of parity `parity` has completed (a bounded wait: a lost
// completion traps rather than hangs)
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_addr(b);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 28)) __trap();
  }
}

// every thread of the block (bar.sync 1: barrier 0 stays __syncthreads')
__device__ __forceinline__ void tile_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// ---- TMA and wgmma ---------------------------------------------------------

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// a K-major operand of 128-byte rows in shared memory, 128-byte swizzle
// (8-row atoms of 1024 bytes, the layout TMA's SWIZZLE_128B lands); a k step
// of 32 bytes adds 2 to the descriptor
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to these registers across this
// point (an asynchronous product owns them between its start and its wait)
template <int I>
__device__ __forceinline__ void fence_regs(float (&r)[I][4]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+f"(r[i][q])::"memory");
}

// d (+)= A . B, one warpgroup, both bf16 operands in shared memory
// (descriptors); scale_d 0 starts the sum
__device__ __forceinline__ void wgmma_bf16(float (&d)[27][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %110, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n216k16.f32.bf16.bf16 {"
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
      "%104, %105, %106, %107 "
      "}, %108, %109, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
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
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A . B, one warp, m8n8k4 in fp64 (exact products of fp32 values,
// fp64 sums): a = A[g][t], b = B[t][g], d = D[g][2t], D[g][2t + 1]
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a), "d"(b));
}

// ---- the product -------------------------------------------------------------

// The block's stream of chunks: position q is chunk q % n_ch of its tile
// q / n_ch (the block's tiles are items blockIdx.x + k gridDim.x), in ring
// stage q % stages.  Every thread walks the positions in order (`pos`);
// thread 0 also issues them, `stages` ahead.
struct Ring {
  const CUtensorMap* cap_map;
  const CUtensorMap* img_map;
  uint32_t base;  // stage 0, 1024-byte aligned
  Bars* bars;
  int pos = 0;
};

// thread 0: position q's chunk into its stage, once every warp released the
// stage's previous chunk (q - stages); nothing past the block's last tile
template <typename T>
__device__ __forceinline__ void feed(const Ring& rg, const Plan& pl, int q) {
  if (threadIdx.x != 0) return;
  const int item = blockIdx.x + (q / pl.n_ch) * gridDim.x;
  if (item >= pl.n_items) return;
  int ig, cg;
  tile_origin(item, pl, &ig, &cg);
  const int st = q % pl.stages;
  bar_wait(&rg.bars->empty[st], ((q / pl.stages) & 1) ^ 1);
  // the stage's last generic reads (the fp32 mode's fragments) before the
  // copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  uint64_t* full = &rg.bars->full[st];
  bar_expect_tx(full, kStageBytes<T>);
  const uint32_t dst = rg.base + st * kStageBytes<T>;
  const int x = (q % pl.n_ch) * Mode<T>::kChunk, irow = ig * Mode<T>::K * kR;
  tma_load(dst, rg.cap_map, x, cg * pl.cpb * pl.L, full);
  tma_load(dst + kCapBytes, rg.img_map, x, irow, full);
}

// every thread, once, after the barriers' setup: the first stages
template <typename T>
__device__ __forceinline__ void feed_first(const Ring& rg, const Plan& pl) {
  for (int q = 0; q < pl.stages; ++q) feed<T>(rg, pl, q);
}

// this thread's wait for position q's chunk; its stage's address
template <typename T>
__device__ __forceinline__ uint32_t wait_chunk(const Ring& rg, const Plan& pl, int q) {
  const int st = q % pl.stages;
  bar_wait(&rg.bars->full[st], (q / pl.stages) & 1);
  return rg.base + st * kStageBytes<T>;
}

// position q's stage done in this warp (its products completed): released,
// and thread 0 refills it with position q + stages
template <typename T>
__device__ __forceinline__ void release(const Ring& rg, const Plan& pl, int q) {
  if (threadIdx.x % 32 == 0) bar_arrive(&rg.bars->empty[q % pl.stages]);
  feed<T>(rg, pl, q + pl.stages);
}

// element (row, k) of a box of 128-byte rows with the 128-byte swizzle
// (16-byte unit u of row r at (u ^ (r % 8)) * 16), 8-byte elements
__device__ __forceinline__ double ld_box64(uint32_t box, int row, int k) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];\n"
               : "=d"(v) : "r"(box + row * 128 + (((k >> 1) ^ (row & 7)) << 4) + 8 * (k & 1)));
  return v;
}

// the tile's A into d (this warpgroup's 64 rows x N): every chunk of D from
// the ring, each stage released when the next one's product is in flight.
// Ends with every product done.
template <typename T>
__device__ __forceinline__ void product(float (&d)[kNG<T>][4], const Plan& pl, Ring& rg) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int wg = threadIdx.x / 128;
    for (int ch = 0; ch < pl.n_ch; ++ch, ++rg.pos) {
      const uint32_t base = wait_chunk<T>(rg, pl, rg.pos);
      const uint64_t da = desc_sw128(base + wg * 64 * 128);
      const uint64_t db = desc_sw128(base + kCapBytes);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_bf16(d, da + 2 * j, db + 2 * j, ch > 0 || j > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(d);
      if (ch > 0) release<T>(rg, pl, rg.pos - 1);
    }
    wgmma_wait<0>();
    fence_regs(d);
    release<T>(rg, pl, rg.pos - 1);
  } else {
    // fp64 m8n8k4 on the tensor cores: warp w of the warpgroup takes its 16
    // rows as two m8 tiles (rows g and g + 8 of the accumulator layout) and
    // every n8 tile; the products of fp32 values are exact and the sums
    // fp64, so A is the exact dot product rounded once to fp32.  (Three
    // TF32 passes on wgmma were built first: the tensor core's rounding of
    // each k8 partial sum moved an ill-conditioned t2i pair by 0.4-1.6e-6,
    // a region of norm 8e-4 over a two-word caption, against the 1e-6 limit,
    // in every accumulation order tried.)
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int wg = threadIdx.x / 128, r0 = 16 * (threadIdx.x / 32 % 4) + g;
    constexpr int NT = kNG<T>;
    double acc[2][NT][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < NT; ++i) acc[h][i][0] = acc[h][i][1] = 0.0;
    for (int ch = 0; ch < pl.n_ch; ++ch, ++rg.pos) {
      const uint32_t base = wait_chunk<T>(rg, pl, rg.pos);
      const uint32_t cap_box = base + wg * 64 * 128, img_box = base + kCapBytes;
#pragma unroll
      for (int ks = 0; ks < Mode<T>::kChunk / 4; ++ks) {
        const int k = 4 * ks + t;
        const double a0 = ld_box64(cap_box, r0, k), a1 = ld_box64(cap_box, r0 + 8, k);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const double b = ld_box64(img_box, 8 * i + g, k);
          dmma(acc[0][i], a0, b);
          dmma(acc[1][i], a1, b);
        }
      }
      release<T>(rg, pl, rg.pos);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) d[i][q] = (float)acc[q >> 1][i][q & 1];
  }
}

// 16-byte cp.async of `n` floats (n % 4 == 0, both ends 16-byte aligned);
// zeros for the vectors at or past `valid` floats.  Every thread.
__device__ __forceinline__ void stage_floats(float* dst, const float* __restrict__ src, int n,
                                             int valid) {
  for (int v = threadIdx.x; v < n / 4; v += kThreads) {
    const bool ok = 4 * v < valid;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst + 4 * v)),
                 "l"(ok ? src + 4 * v : src), "r"(ok ? 16 : 0));
  }
}
__device__ __forceinline__ void staged_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void staged_wait() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float leaky(float a) { return a > 0.0f ? a : 0.1f * a; }

// the column range of image p in a row: 8-column groups i0 .. i0 + 4
// (36 columns span five groups, the first or the last one half)
__host__ __device__ constexpr int img_group0(int p) { return 36 * p / 8; }

// Image p's five groups of this thread's accumulators, copied into blk: for
// even p the block starts at column 36 p (its last group's high half is
// image p + 1's), for odd p at 36 p - 4 (its first group's low half is
// image p - 1's).  The chain runs a loop over the images on such a copy
// (one body a parity) rather than the accumulators unrolled image by image:
// the unrolled epilogue was ~14k instructions, more than the instruction
// cache holds.
template <int P, int NG>
__device__ __forceinline__ void take_block(const float (&d)[NG][4], float (&blk)[5][4]) {
  if constexpr (img_group0(P) + 4 < NG) {
#pragma unroll
    for (int il = 0; il < 5; ++il)
#pragma unroll
      for (int q = 0; q < 4; ++q) blk[il][q] = d[img_group0(P) + il][q];
  }
}
template <int NG>
__device__ __forceinline__ void image_block(const float (&d)[NG][4], int p, float (&blk)[5][4]) {
  switch (p) {
    case 0: take_block<0>(d, blk); break;
    case 1: take_block<1>(d, blk); break;
    case 2: take_block<2>(d, blk); break;
    case 3: take_block<3>(d, blk); break;
    case 4: take_block<4>(d, blk); break;
    default: take_block<5>(d, blk); break;
  }
}

// whether slot (il, e) of a block of parity Odd is image p's for quad lane t
template <int Odd>
__device__ __forceinline__ bool in_image(int il, int e, int t) {
  const int off = 8 * il + 2 * t + e - 4 * Odd;
  return off >= 0 && off < 36;
}

// ---- host --------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, found through the runtime
// (no link against libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a (rows, D) row-major matrix read in boxes of (box_rows, chunk), 128-byte
// swizzle, zeros past its edges
template <typename T>
inline bool tensor_map(CUtensorMap* map, const void* base, long long rows, int D, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(typename Mode<T>::Elem)};
  const cuuint32_t box[2] = {(cuuint32_t)Mode<T>::kChunk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, Mode<T>::kTmaType, 2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// the plan of a launch; `fixed` is the epilogue's shared memory (bytes) for
// this plan, which decides the ring's stages; false if nothing fits
template <typename T, typename Fixed>
inline bool make_plan(Plan* pl, int Ni, int Nc, int L, int D, Fixed fixed) {
  pl->Ni = Ni;
  pl->Nc = Nc;
  pl->L = L;
  pl->D = D;
  pl->cpb = kRows / L;
  pl->n_cg = (Nc + pl->cpb - 1) / pl->cpb;
  pl->n_ig = (Ni + Mode<T>::K - 1) / Mode<T>::K;
  const long long items = (long long)pl->n_cg * pl->n_ig;
  if (items > 0x7fffffffLL) return false;
  pl->n_items = (int)items;
  pl->n_ch = (D + Mode<T>::kChunk - 1) / Mode<T>::kChunk;
  const int room = kSmemMax - 1024 - fixed(*pl);
  pl->stages = room / kStageBytes<T>;
  if (pl->stages > kMaxStages) pl->stages = kMaxStages;
  return pl->stages >= 2;
}

// One launch of `kernel(cap_map, img_map, plan, args...)` on `stream`:
// the plan (`fixed(plan)`: the epilogue's shared-memory bytes), the two
// tensor maps and a persistent grid of one block an SM.  Returns a CUDA
// error code: invalid value for a shape the design does not take (L not a
// multiple of 8 in [8, 128], rows not 16-byte strided, no ring of 2
// stages), not supported without the CUDA driver's tensor-map encoder.
template <typename T, typename Kernel, typename Fixed, typename... Args>
inline int launch(Kernel kernel, Fixed fixed, const void* img, const void* cap,
                  int Ni, int Nc, int L, int D, int device, cudaStream_t stream, Args... args) {
  if (L < 8 || L > kRows || L % 8 != 0 || D < 1 ||
      (D * sizeof(typename Mode<T>::Elem)) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Plan pl;
  if (!make_plan<T>(&pl, Ni, Nc, L, D, fixed)) return (int)cudaErrorInvalidValue;
  if (pl.n_items == 0) return (int)cudaSuccess;
  CUtensorMap cap_map, img_map;
  if (!tensor_map<T>(&cap_map, cap, (long long)Nc * L, D, kRows) ||
      !tensor_map<T>(&img_map, img, (long long)Ni * kR, D, kN<T>)) {
    return (int)cudaErrorNotSupported;
  }
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int smem = 1024 + pl.stages * kStageBytes<T> + fixed(pl);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = pl.n_items < sms ? pl.n_items : sms;
  kernel<<<grid, kThreads, smem, stream>>>(cap_map, img_map, pl, args...);
  return (int)cudaGetLastError();
}

// every thread of the block, once: the ring's barriers (stage s full when
// thread 0's expect_tx and the TMA bytes arrived, empty when each of the 8
// warps released it) and its first stages; returns the ring and the
// epilogue's shared memory, after the ring
template <typename T>
__device__ __forceinline__ Ring setup(unsigned char* smem, const Plan& pl, Bars& bars,
                                      const CUtensorMap* cap_map, const CUtensorMap* img_map,
                                      float** epilogue) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      bar_init(&bars.full[s], 1);
      bar_init(&bars.empty[s], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  *epilogue = reinterpret_cast<float*>(smem + (base - smem_addr(smem)) +
                                       pl.stages * kStageBytes<T>);
  Ring rg{cap_map, img_map, base, &bars};
  feed_first<T>(rg, pl);
  return rg;
}

}  // namespace itrx_xwg
