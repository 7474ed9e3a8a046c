// Pieces of the VSRN decoder's persistent loops (vsrn_dec.cu, the forward;
// vsrn_dec_bwd.cu, the backward's reverse loop): a block owns kUnits hidden
// units and multiplies a tile of batch rows, read from an exchange at L2,
// against its units' weight columns, as split-bf16 mma.sync products whose B
// fragments the wrapper laid out once a call (ops/kernels/vsrn_dec.py::
// _fragments) and which sit in shared memory for all steps or stream through
// a cp.async ring; and the timers of the loops' phase builds.

#pragma once

#include "gru_persistent.cuh"
#include "sgraf_nodes_mma.cuh"

// A phase build (ITRX_VSRN_LOOP_PHASES slots, set by the including source):
// block 0's thread 0 reads %globaltimer at every phase boundary of the loop
// and adds the time since the last one to the phase's slot.
#ifdef ITRX_VSRN_LOOP_PHASES
namespace vsrn_loop {
constexpr int kPhases = ITRX_VSRN_LOOP_PHASES;
__device__ unsigned long long g_phase_ns[kPhases];
__device__ __forceinline__ unsigned long long phase_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
}  // namespace vsrn_loop
#define PHASE_START                                        \
  unsigned long long phase_ns[vsrn_loop::kPhases] = {}, phase_at = 0; \
  if (blockIdx.x == 0 && threadIdx.x == 0) phase_at = vsrn_loop::phase_now();
#define PHASE(i)                                           \
  if (blockIdx.x == 0 && threadIdx.x == 0) {               \
    const unsigned long long now_ = vsrn_loop::phase_now(); \
    phase_ns[i] += now_ - phase_at;                        \
    phase_at = now_;                                       \
  }
#define PHASE_END                                          \
  if (blockIdx.x == 0 && threadIdx.x == 0) {               \
    for (int i = 0; i < vsrn_loop::kPhases; ++i) vsrn_loop::g_phase_ns[i] = phase_ns[i]; \
  }
#else
#define PHASE_START
#define PHASE(i)
#define PHASE_END
#endif

namespace vsrn_loop {

namespace mma = itrx_sgraf_mma;

constexpr int kUnits = 8;        // hidden units a loop block owns: one n8 tile
constexpr int kChunkSteps = gru::kKAlign / 16;  // k16 steps in one streamed chunk

// one n8 tile's B fragments of a k16 step, 32 lanes, in 32-bit words: split
// (hi and lo, 16 bytes a lane) in the fp32 mode, the bf16 values alone (8
// bytes a lane) in the bf16 mode
template <bool BF16>
__host__ __device__ constexpr int step_words() { return BF16 ? 64 : 128; }

// Chunk `chunk` of a streamed run of a product's weight fragments (NT tiles)
// into ring slot chunk % kStages: k16 steps ((chunk % per + rot) % per) 4 ..
// + 3, one contiguous piece of NT kChunkSteps step_words words.
template <int NT, bool BF16 = false>
__device__ __forceinline__ void ring_issue_frag(uint32_t* ring, int chunk, int total, int per,
                                                int rot, const uint32_t* __restrict__ src) {
  constexpr int kWords = NT * kChunkSteps * step_words<BF16>();
  if (chunk < total) {
    uint32_t* slot = ring + (chunk % gru::kStages) * kWords;
    const uint32_t* from = src + (size_t)((chunk % per + rot) % per) * kWords;
    for (int i = 4 * threadIdx.x; i < kWords; i += 4 * gru::kThreads) {
      gru::cp_async16(slot + i, from + i, 16);
    }
  }
  gru::cp_async_commit();
}

// One product of a tile of the block's batch rows (16 MT rows) against the
// block's NT n8 tiles of weight columns, on the tensor cores: mma.sync
// m16n8k16 with x = hi + lo both bf16 and three passes a_hi b_lo + a_lo b_hi
// + a_hi b_hi, fp32 accumulation (sgraf_nodes_mma.cuh's split, fp32 accuracy
// kept).  Warp w takes m-tile w % MT and part w / MT of the depth's k16 steps
// (8 / MT parts); its A rows come from the exchange at L2, a float4 of rows g
// and g + 8 a step and lane (lane t holding columns 4t .. 4t + 3 of the k16
// step as its fragment slots 2t, 2t + 1, 2t + 8, 2t + 9; the wrapper lays the
// B fragments out with the same permutation), DEPTH - 1 steps ahead, split as
// they are used; its B fragments, pre-split, from shared memory (ws, or the
// ring's slots when STREAM).  The walk over the depth starts at chunk `rot`
// (of 4 k16 steps) and wraps, so that blocks reading the same rows at once
// read different lines.  The parts are summed in order through shared
// memory (part_s), ending with a barrier of the block; warps of part 0 end
// with the tile's sums: d[nt][2 h + e] at row 16 mt + g + 8 h, column 2t + e
// of tile nt.  BF16 (the bf16 mode): the B fragments are the bf16 weights
// alone (step_words<true>), one pass a_hi b_hi, the A rows rounded to bf16
// (the TPU kernel's dot_dtype="bfloat16").
template <int MT, int NT, bool STREAM, bool BF16 = false>
__device__ __forceinline__ void product_mma(float (&d)[NT][4], const float* A, int lda,
                                            int nrows, const uint32_t* ws, int Kp, int rot,
                                            int& chunk, int total, const uint32_t* src,
                                            float* part_s) {
  using namespace gru;
  constexpr int KS = 8 / MT, DEPTH = 8, kSW = step_words<BF16>();
  static_assert(!STREAM || KS == 1, "a streamed ring feeds every warp the same chunk");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int mt = warp % MT, part = warp / MT;
  const int nsteps = Kp / 16, per = nsteps / KS, s0 = part * per, r16 = rot * kChunkSteps;
  const int ra = 16 * mt + g, rb = ra + 8;
  const bool oka = ra < nrows, okb = rb < nrows;
  const float* pa = A + (size_t)(oka ? ra : 0) * lda + 4 * t;
  const float* pb = A + (size_t)(okb ? rb : 0) * lda + 4 * t;
  // the part's s-th step is k16 step (s0 + s + r16) mod nsteps
  const auto step_of = [&](int s) {
    const int k = s0 + s + r16;
    return k < nsteps ? k : k - nsteps;
  };
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const auto load = [&](int s, float4& xa, float4& xb) {
#ifdef ITRX_VSRN_DEC_PROBE_NO_LOADS
    // a measurement build: the operand rows never read, what the rest takes
    xa = xb = make_float4(__int_as_float(0x3f000000 | threadIdx.x), 0.f, 0.f, 0.f);
#else
    const int k = step_of(s) * 16;
    xa = oka ? __ldcg(reinterpret_cast<const float4*>(pa + k)) : zero;
    xb = okb ? __ldcg(reinterpret_cast<const float4*>(pb + k)) : zero;
#endif
  };
  float dlo[NT][4], dhi[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) dlo[n][q] = dhi[n][q] = 0.0f;
  float4 bufa[DEPTH], bufb[DEPTH];
#pragma unroll
  for (int i = 0; i < DEPTH - 1; ++i)
    if (i < per) load(i, bufa[i], bufb[i]);
  for (int s0i = 0; s0i < per; s0i += DEPTH) {
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      const int s = s0i + i;
      if (s < per) {
        if (s + DEPTH - 1 < per) {
          load(s + DEPTH - 1, bufa[(i + DEPTH - 1) % DEPTH], bufb[(i + DEPTH - 1) % DEPTH]);
        }
        const uint32_t* w;
        if constexpr (STREAM) {
          if (s % kChunkSteps == 0) {
            cp_async_wait<kStages - 2>();
            __syncthreads();
            ring_issue_frag<NT, BF16>(const_cast<uint32_t*>(ws), chunk + kStages - 1, total,
                                      Kp / kKAlign, rot, src);
            ++chunk;
          }
          w = ws + ((chunk - 1) % kStages) * (NT * kChunkSteps * kSW) +
              (s % kChunkSteps) * NT * kSW;
        } else {
          w = ws + (size_t)step_of(s) * NT * kSW;
        }
        const float4 xa = bufa[i], xb = bufb[i];
        uint32_t ah[4], al[4];
        mma::split2(xa.x, xa.y, ah[0], al[0]);
        mma::split2(xb.x, xb.y, ah[1], al[1]);
        mma::split2(xa.z, xa.w, ah[2], al[2]);
        mma::split2(xb.z, xb.w, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if constexpr (BF16) {
            const uint2 b = *reinterpret_cast<const uint2*>(w + n * kSW + 2 * lane);
            mma::mma16(dhi[n], ah, b.x, b.y);
          } else {
            const uint4 b = *reinterpret_cast<const uint4*>(w + n * kSW + 4 * lane);
#ifdef ITRX_VSRN_DEC_PROBE_NO_PRODUCTS
            // a measurement build: the operands formed and kept, no products
            dhi[n][0] += __uint_as_float(ah[0] ^ al[1] ^ ah[2] ^ al[3] ^ b.x ^ b.y ^ b.z ^ b.w);
#else
            mma::mma16(dlo[n], ah, b.z, b.w);
            mma::mma16(dlo[n], al, b.x, b.y);
            mma::mma16(dhi[n], ah, b.x, b.y);
#endif
          }
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) d[n][q] = dlo[n][q] + dhi[n][q];
  if constexpr (KS > 1) {
    // the parts' sums, in order of the part
    float* mine = part_s + ((size_t)mt * 32 + lane) * NT * 4;
    for (int p = 1; p < KS; ++p) {
      if (part == p) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) mine[n * 4 + q] = d[n][q];
      }
      __syncthreads();
      if (part == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[n][q] += mine[n * 4 + q];
      }
      __syncthreads();
    }
  }
}

}  // namespace vsrn_loop
