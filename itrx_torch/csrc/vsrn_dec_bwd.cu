// VSRN's teacher-forced caption decoder, the backward, for sm_90a.
//
// Replaces itrx/ops/pallas/vsrn_dec.py::_bwd_kernel.  From the forward's
// residuals hall[t] = h_{t-1} and ghall[t] = h_{t-1} Whh^T + bhh and the
// cotangent g_hs of the states (all fp32):
//   recompute, for all T x B rows at once: hq = hall Watt^T, the attention
//     (alpha, the masked ctx; vsrn_dec.cuh) and gx = ctx Wctx^T + gxw;
//   then in reverse over t, carrying only g (B x H), g_ht = g + g_hs[t]:
//     the GRU cell's adjoint -> g_gx = [g_prer | g_prez | g_pren] (= g_gxw[t])
//       and g_gh = [g_prer | g_prez | g_pren r], gp = g_ht z
//     g_ctx = (g_gx Wctx) * cmask_t
//     per batch row: g_alpha_r = g_ctx . enc_out_r, g_e = alpha (g_alpha -
//       alpha . g_alpha), g_hq = sum_r g_e_r w2 (1 - o_r^2), o = tanh(enc_att
//       + hq)
//     g = gp + [g_hq | g_gh] [Watt ; Whh]
//   then the sums over t that nothing in the loop reads:
//     g_enc_out[b] = sum_t alpha_t[b]^T g_ctx_t[b],
//     g_enc_att[b, r] = w2 * sum_t g_e_t[b, r] (1 - o_t[b, r]^2),
//     dw2 = sum_{t, b, r} g_e o,
//     [dWatt ; dWhh | . ; dbhh] = [g_hq | g_gh]^T [hall | 1],  dWctx = g_gx^T ctx.
//
// What bounds it: the products, 2 B H^2 x 18 a step (the recomputed hq and
// gx, g_gx Wctx, the carry's [g_hq | g_gh] [Watt ; Whh] and the weight sums),
// of which the loop's two run in T steps one after the other.  Every product
// runs on the tensor cores as a split-bf16 product (sgraf_nodes_mma.cuh's
// split: x = hi + lo both bf16, three passes a_hi b_lo + a_lo b_hi +
// a_hi b_hi, fp32 accumulation), so the gradients keep fp32 accuracy; the
// weights are split once a call by the wrapper.  Design:
//   1. proj_kernel (twice) and attend_kernel: the recomputation over all rows
//      (mma_tile's wgmma on TMA-staged weight slabs).
//   2. loop_kernel: the reverse loop as one persistent cooperative launch, a
//      block an SM (gru_persistent.cuh's grid barrier, vsrn_dec_loop.cuh's
//      product, shared with the forward).  A block owns 8 hidden units j and
//      keeps its split B fragments of the loop's weights in shared memory for
//      all steps (streamed through a cp.async ring where they do not fit: H
//      above 775); where the card has room (H <= 528 on
//      132 SMs) two blocks share the units, each taking half of the batch
//      rows.  A step is three phases between three grid barriers:
//        - from one read of the exchange [g_prer | g_prez | g_pren | g_pren r]
//          (B x 4H, at L2), g_ctx[:, j] = (g_gx Wctx)[:, j] cmask_t and the
//          carry's g_gh Whh[:, j] (mma.sync, two n8 tiles);
//        - the attention's adjoint, a block a batch row, from the whole g_ctx
//          row: g_e and g_hq;
//        - the carry g[:, j] = gp + g_hq Watt[:, j] (one n8 tile), then the
//          cell's adjoint of the next step for the block's units, which
//          writes the exchange (the cell is elementwise in j; its inputs load
//          during the product).
//      The products' operand rows come from the exchange at L2 and pace them
//      with the barriers (python -m itrx_torch.tools.vsrn_dec_phases); each
//      block walks the depth from its own offset.  The loop keeps only what
//      feeds the carry: it saves g_ctx and g_e of every step and writes
//      [g_hq | g_gh] per step where the weight sums read it.
//   3. attn_sums_kernel: g_enc_out, g_enc_att and dw2's parts in one pass
//      after the loop, a thread per (b, h) and four regions, the sums over t
//      in order (tanh again on the recomputed hq).
//   4. gsum_kernel (twice): the weight sums (wgmma, both operands split as
//      they are staged, sgraf_align_bwd.cu's gw_kernel pattern) over fixed
//      splits of the rows; wsum_reduce and colsum_kernel sum the splits and
//      parts in order.
// The bf16 mode (bf16 operands, the train_bf16 step): the TPU kernel at
// dot_dtype="bfloat16".  The weights are bf16 (the loop's B fragments hold
// them alone, half the split layout's bytes; the recompute's slabs split
// them with a zero lo part, which no pass reads); every product and weight
// sum takes one bf16 pass, its operands rounded as the TPU kernel rounds
// them (h, the masked context, g_gx, g_gh and g_hq), fp32 accumulation;
// ghall comes in bf16 (as the forward saves it) and g_gxw is written as bf16
// values; dbhh sums the unrounded g_gh; the attention and its adjoint stay
// fp32 (enc_out comes as its fp32 values).
// No atomics and every sum in a fixed order, so two calls give identical
// gradients; nothing is read back to the host.  Each launch's time on the
// card is in PERF.md §6.
#ifdef ITRX_VSRN_DEC_PHASES
// the loop's phases as block 0's thread 0 sees them (tools/vsrn_dec_phases.py)
#define ITRX_VSRN_LOOP_PHASES 7
#endif
#include "gru_persistent.cuh"
#include "sgraf_nodes_mma.cuh"
#include "vsrn_dec.cuh"
#include "vsrn_dec_loop.cuh"

namespace {

namespace mma = itrx_sgraf_mma;
using itrx_vsrn::kMaxH;
using itrx_vsrn::kMaxR;
using itrx_vsrn::sigmoid_f;
using itrx_vsrn::warp_sum;
using vsrn_loop::kChunkSteps;
using vsrn_loop::step_words;
using vsrn_loop::kUnits;
using vsrn_loop::product_mma;
using vsrn_loop::ring_issue_frag;

constexpr int kThreads = 256, kWarps = kThreads / 32;

// ---------------------------------------------------------------- 1
// Rows t0 .. t0 + nrows - 1 of an fp32 matrix (row stride ld), columns
// k < K: the operand of mma_tile (scalar loads, any alignment).
struct RowsF32 {
  const float* __restrict__ src;
  long long t0;
  int nrows, ld, K;
  float pre[8];

  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ void stage(int) {}
  __device__ __forceinline__ void load(int s) {
    const mma::Part pt(s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = pt.r0 + 8 * h;
      const float* row = src + (t0 + (r < nrows ? r : 0)) * ld;
#pragma unroll
      for (int i = 0; i < 4; ++i) pre[4 * h + i] = (r < nrows && pt.k(i) < K) ? row[pt.k(i)] : 0.0f;
    }
  }
  __device__ __forceinline__ void make(int, float (&v)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = pre[i];
  }
};

constexpr int kProjBytes = (mma::kWStages * mma::kWStage + 2 * mma::kAStage) * 4;

// out (rows x N, row stride N) = A (rows x K, row stride lda) W^T (+ add, the
// layout of out), one 64-row tile and one chunk of S8 columns a block; W
// split by the wrapper into chunks of S8 rows of Kp words (mma_tile's slab
// layout).  Two blocks an SM.  BF16: A rounded to bf16, W bf16, one pass.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
proj_kernel(const float* __restrict__ A, int lda, int K, const uint32_t* __restrict__ wsplit,
            int Kp, int S8, const float* __restrict__ add, float* __restrict__ out, int N,
            long long rows) {
  extern __shared__ __align__(128) float smem[];
  uint32_t* const u = reinterpret_cast<uint32_t*>(smem);
  const mma::Ring rg{u + mma::kWStages * mma::kWStage, u, smem};
  const long long t0 = (long long)blockIdx.x * mma::kMmaRows;
  const int j = blockIdx.y;
  const int nrows = (int)min((long long)mma::kMmaRows, rows - t0);
  mma::init_weight_bars();
  RowsF32 prod{A, t0, nrows, lda, K, {}};
  mma::Acc acc;
  mma::mma_tile<!BF16, !BF16>(acc, rg, wsplit + (size_t)j * S8 * Kp, Kp, S8, nrows, prod);
  mma::tile_out(acc, rg, nrows, [&](const float* y, int n) {
    const int c = threadIdx.x, col = j * S8 + c;
    if (c >= S8 || col >= N) return;
    for (int r = 0; r < n; ++r) {
      const size_t o = (size_t)(t0 + r) * N + col;
      out[o] = y[r * mma::kLdY + c] + (add != nullptr ? add[o] : 0.0f);
    }
  });
}

// ---------------------------------------------------------------- 2
struct LoopArgs {
  const float* gx;      // (T, B, 3H) recomputed input gates
  const void* ghall;    // (T, B, 3H): fp32, bf16 in the bf16 mode
  const float* hall;    // (T, B, H)
  const float* ghs;     // (T, B, H)
  const float* cmask;   // (T, B, H)
  const float* enco;    // (B, R, H)
  const float* enca;    // (B, R, H)
  const float* hq;      // (T, B, H) recomputed
  const float* alpha;   // (T, B, R) recomputed
  const float* w2;      // (H)
  const uint32_t* f1;   // the first product's split B fragments, a unit group's
                        // Kp4 / 16 k16 steps x 2 n8 tiles (loop_weights)
  const uint32_t* f3;   // the carry product's (Watt^T), Kp1 / 16 steps x 1 tile
  float* ggxw;          // (T, B, 3H) out
  float* gh0;           // (B, H) out
  float* eg;            // (B, Kp4) exchange: [g_prer | g_prez | g_pren | g_pren r]
  float* cat;           // (T, B, Kp4): [g_hq | g_gh] a step, zero past 4H
  float* gctx;          // (T, B, H): the masked g_ctx a step
  float* ge;            // (T, B, R): g_e a step
  float* gp;            // (B, H): g_ht z of the step
  unsigned* bar;        // grid barrier, two zeroed words
  int T, B, R, H, Kp1, Kp4;
};

// The inputs of the cell's adjoint at one (row, unit), loaded a product ahead
struct CellIn {
  float x[3], hh[3], hp, gs;
};

// The reverse loop, a block an SM.  Block i owns hidden units j0 = (i /
// halves) 8 .. j0 + 7 and, of the batch cut in tiles of 16 MT rows, the tiles
// i % halves, i % halves + halves, ... (halves = 8 / MT; with MT 4 two blocks
// share the units, each reading half of every exchange row block).  In the
// warps of part 0 of the products, thread (warp, lane) owns, of each of its
// tiles, rows 16 (warp % MT) + lane / 4 + 8 h and units j0 + 2 (lane % 4) + e
// (h, e in {0, 1}): the products' output map, the same in every phase, so the
// carry's local term gp never leaves its thread.
template <int MT, bool STREAM, bool BF16>
__global__ void __launch_bounds__(kThreads, 1) loop_kernel(const LoopArgs p) {
  using namespace gru;
  constexpr int kTile = 16 * MT, kHalves = 8 / MT, NT1 = 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float gcs[kMaxH];
  __shared__ float al[kMaxR], ga[kMaxR];
  __shared__ __align__(16) float part_s[4 * 32 * NT1 * 4];
  const int T = p.T, B = p.B, Rg = p.R, H = p.H, H3 = 3 * H, Kp1 = p.Kp1, Kp4 = p.Kp4;
  constexpr int kSW = step_words<BF16>();
  const int words3 = Kp1 / 16 * kSW;
  const int words1 = STREAM ? kStages * NT1 * kChunkSteps * kSW : Kp4 / 16 * NT1 * kSW;
  uint32_t* const w3 = reinterpret_cast<uint32_t*>(smem_raw);  // Watt^T's fragments, resident
  uint32_t* const w1 = w3 + words3;                            // w1's fragments, or the ring
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4, mt = warp % MT;
  const bool owner = warp < MT;  // part 0 of the products
  const int half = blockIdx.x % kHalves, group = blockIdx.x / kHalves;
  const int j0 = group * kUnits;
  const int n_tiles = (B + kTile - 1) / kTile;
  const int my_tiles = n_tiles > half ? (n_tiles - half + kHalves - 1) / kHalves : 0;
  // x as the mode keeps it: rounded to bf16 in the bf16 mode
  const auto as_dot = [](float x) { return BF16 ? gru::bf16_round(x) : x; };
  const int per1 = Kp4 / kKAlign, total1 = STREAM ? T * my_tiles * per1 : 0;
  // where the block's walks over the depth start (chunks of kKAlign columns)
  const int rot1 = group % per1, rot3 = group % (Kp1 / kKAlign);
  const uint32_t* f1 = p.f1 + (size_t)group * (Kp4 / 16) * NT1 * kSW;
  const uint32_t* f3 = p.f3 + (size_t)group * words3;
  int chunk1 = 0, chunk3 = 0;

  for (int i = 4 * tid; i < words3; i += 4 * kThreads) cp_async16(w3 + i, f3 + i, 16);
  if constexpr (STREAM) {
    cp_async_commit();
    for (int i = 0; i < kStages - 1; ++i) {
      ring_issue_frag<NT1, BF16>(w1, i, total1, per1, rot1, f1);
    }
  } else {
    for (int i = 4 * tid; i < words1; i += 4 * kThreads) cp_async16(w1 + i, f1 + i, 16);
    cp_async_commit();
  }
  // the resident fragments are in before the first product (its barriers
  // follow); a streamed ring's groups are waited for as they are used
  if constexpr (!STREAM) cp_async_wait<0>();

  const auto row_of = [&](int b0, int h) { return b0 + 16 * mt + g + 8 * h; };
  const auto unit_of = [&](int e) { return j0 + 2 * tq + e; };
  const auto load_cell = [&](int t, int b, int j, CellIn& v) {
    if (b >= B || j >= H) return;
    const size_t bt = (size_t)t * B + b;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      v.x[q] = p.gx[bt * H3 + q * H + j];
      if constexpr (BF16) {
        v.hh[q] = __bfloat162float(
            static_cast<const __nv_bfloat16*>(p.ghall)[bt * H3 + q * H + j]);
      } else {
        v.hh[q] = static_cast<const float*>(p.ghall)[bt * H3 + q * H + j];
      }
    }
    v.hp = p.hall[bt * H + j];
    v.gs = p.ghs[bt * H + j];
  };
  // the cell's adjoint at step t for (row b, unit j) with carry g
  const auto cell = [&](int t, int b, int j, const CellIn& v, float gc) {
    const size_t bt = (size_t)t * B + b;
    const float g_ht = gc + v.gs;
    const float r = sigmoid_f(v.x[0] + v.hh[0]);
    const float z = sigmoid_f(v.x[1] + v.hh[1]);
    const float hn = v.hh[2];
    const float n = tanhf(v.x[2] + r * hn);
    const float g_n = g_ht * (1.0f - z);
    const float g_z = g_ht * (v.hp - n);
    const float g_pren = g_n * (1.0f - n * n);
    const float g_r = g_pren * hn;
    const float g_prer = g_r * r * (1.0f - r);
    const float g_prez = g_z * z * (1.0f - z);
    float* o = p.ggxw + bt * H3;
    o[j] = as_dot(g_prer);
    o[H + j] = as_dot(g_prez);
    o[2 * H + j] = as_dot(g_pren);
    float* e = p.eg + (size_t)b * Kp4;
    e[j] = g_prer;
    e[H + j] = g_prez;
    e[2 * H + j] = g_pren;
    e[3 * H + j] = g_pren * r;
    float* cr = p.cat + bt * Kp4 + H;
    cr[j] = g_prer;
    cr[H + j] = g_prez;
    cr[2 * H + j] = g_pren * r;
    p.gp[(size_t)b * H + j] = g_ht * z;
  };

  // the first step's cell, with the carry 0
  if (owner) {
    for (int tl = half; tl < n_tiles; tl += kHalves) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = row_of(tl * kTile, h), j = unit_of(e);
          CellIn v;
          load_cell(T - 1, b, j, v);
          if (b < B && j < H) cell(T - 1, b, j, v, 0.0f);
        }
    }
  }
  PHASE_START
  for (int t = T - 1; t >= 0; --t) {
    const size_t tB = (size_t)t * B;
    grid_sync(p.bar);  // every unit's g_gx of step t is out
    PHASE(1)
    // from one read of the exchange: g_ctx[:, j] = (g_gx Wctx)[:, j] * cmask_t
    // and the carry's g_gh Whh[:, j], added to gp
    for (int tl = half; tl < n_tiles; tl += kHalves) {
      const int b0 = tl * kTile;
      float d[NT1][4];
      product_mma<MT, NT1, STREAM, BF16>(d, p.eg + (size_t)b0 * Kp4, Kp4, B - b0, w1, Kp4,
                                         rot1, chunk1, total1, f1, part_s);
      if (owner) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = row_of(b0, h), j = unit_of(e);
            if (b < B && j < H) {
              const size_t o = (tB + b) * H + j;
              p.gctx[o] = d[0][2 * h + e] * p.cmask[o];
              p.gp[(size_t)b * H + j] += d[1][2 * h + e];
            }
          }
      }
    }
    PHASE(2)
    grid_sync(p.bar);  // every g_ctx row of step t is whole
    PHASE(3)
    // the attention's adjoint, a block a batch row
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      const size_t bt = tB + b;
      for (int k = tid; k < H; k += kThreads) gcs[k] = __ldcg(p.gctx + bt * H + k);
      for (int r = tid; r < Rg; r += kThreads) al[r] = p.alpha[bt * Rg + r];
      __syncthreads();
      // g_alpha: warp w takes rows w, w + 8, w + 16, w + 24 at once (their
      // loads in flight together), then the next four
      const float* eo = p.enco + (size_t)b * Rg * H;
      for (int r0 = warp; r0 < Rg; r0 += 4 * kWarps) {
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int k = lane; k < H; k += 32) {
          const float gk = gcs[k];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (r0 + kWarps * i < Rg) s[i] = fmaf(gk, eo[(size_t)(r0 + kWarps * i) * H + k], s[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i] = warp_sum(s[i]);
          if (lane == 0 && r0 + kWarps * i < Rg) ga[r0 + kWarps * i] = s[i];
        }
      }
      __syncthreads();
      if (warp == 0) {
        float dd = 0.0f;
        for (int r = lane; r < Rg; r += 32) dd = fmaf(al[r], ga[r], dd);
        dd = warp_sum(dd);
        for (int r = lane; r < Rg; r += 32) {
          ga[r] = al[r] * (ga[r] - dd);  // g_e
          p.ge[bt * Rg + r] = ga[r];
        }
      }
      __syncthreads();
      // g_hq: a thread takes columns k and k + 256 at once
      const float* ea = p.enca + (size_t)b * Rg * H;
      for (int k = tid; k < H; k += 2 * kThreads) {
        const int k2 = k + kThreads;
        const bool two = k2 < H;
        const float q = p.hq[bt * H + k], w = p.w2[k];
        const float q2 = two ? p.hq[bt * H + k2] : 0.0f, w2v = two ? p.w2[k2] : 0.0f;
        float g_hq = 0.0f, g_hq2 = 0.0f;
#pragma unroll 6
        for (int r = 0; r < Rg; ++r) {
          const float o = tanhf(ea[(size_t)r * H + k] + q);
          g_hq += ga[r] * w * (1.0f - o * o);
          if (two) {
            const float o2 = tanhf(ea[(size_t)r * H + k2] + q2);
            g_hq2 += ga[r] * w2v * (1.0f - o2 * o2);
          }
        }
        p.cat[bt * Kp4 + k] = g_hq;
        if (two) p.cat[bt * Kp4 + k2] = g_hq2;
      }
      __syncthreads();  // the row's buffers are free
    }
    PHASE(4)
    grid_sync(p.bar);  // every [g_hq | g_gh] row of step t is whole
    PHASE(5)
    // g = gp + g_hq Watt[:, j], then the next step's cell
    for (int tl = half; tl < n_tiles; tl += kHalves) {
      const int b0 = tl * kTile;
      CellIn next[2][2];
      if (owner && t > 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) load_cell(t - 1, row_of(b0, h), unit_of(e), next[h][e]);
      }
      float d[1][4];
      product_mma<MT, 1, false, BF16>(d, p.cat + (tB + b0) * Kp4, Kp4, B - b0, w3, Kp1, rot3,
                                      chunk3, 0, f3, part_s);
      PHASE(6)
      if (owner) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = row_of(b0, h), j = unit_of(e);
            if (b >= B || j >= H) continue;
            const float gc = p.gp[(size_t)b * H + j] + d[0][2 * h + e];
            if (t > 0) {
              cell(t - 1, b, j, next[h][e], gc);
            } else {
              p.gh0[(size_t)b * H + j] = gc;
            }
          }
      }
    }
    PHASE(0)
  }
  PHASE_END
}

// ---------------------------------------------------------------- 3
constexpr int kSumCols = 128;  // h a block
constexpr int kSumRegions = 4;  // regions a thread

// A thread per (b, h) and kSumRegions regions r0 .. r0 + 3, the sums over t
// in order: g_enc_out[b, r, h] = sum_t alpha[t, b, r] g_ctx[t, b, h];
// g_enc_att[b, r, h] = w2[h] sum_t g_e[t, b, r] (1 - o^2); dw2p[(b, rgroup),
// h] = sum over the thread's regions of sum_t g_e o (o = tanh(enc_att + hq)).
__global__ void __launch_bounds__(kSumCols)
attn_sums_kernel(const float* __restrict__ enca, const float* __restrict__ hq,
                 const float* __restrict__ alpha, const float* __restrict__ gctx,
                 const float* __restrict__ ge, const float* __restrict__ w2,
                 float* __restrict__ genco, float* __restrict__ genca,
                 float* __restrict__ dw2p, int T, int B, int R, int H) {
  const int h = blockIdx.x * kSumCols + threadIdx.x;
  const int rgi = blockIdx.y, r0 = rgi * kSumRegions, b = blockIdx.z;
  if (h >= H) return;
  float ea[kSumRegions], se[kSumRegions], so[kSumRegions], sd[kSumRegions];
#pragma unroll
  for (int k = 0; k < kSumRegions; ++k) {
    ea[k] = r0 + k < R ? enca[((size_t)b * R + r0 + k) * H + h] : 0.0f;
    se[k] = so[k] = sd[k] = 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    const size_t bt = (size_t)t * B + b;
    const float q = hq[bt * H + h], gc = gctx[bt * H + h];
#pragma unroll
    for (int k = 0; k < kSumRegions; ++k) {
      if (r0 + k >= R) continue;
      const float o = tanhf(ea[k] + q);
      const float g_e = ge[bt * R + r0 + k];
      se[k] = fmaf(g_e, 1.0f - o * o, se[k]);
      sd[k] = fmaf(g_e, o, sd[k]);
      so[k] = fmaf(alpha[bt * R + r0 + k], gc, so[k]);
    }
  }
  const float w = w2[h];
  float dw = 0.0f;
#pragma unroll
  for (int k = 0; k < kSumRegions; ++k) {
    if (r0 + k >= R) continue;
    const size_t o = ((size_t)b * R + r0 + k) * H + h;
    genca[o] = w * se[k];
    genco[o] = so[k];
    dw += sd[k];
  }
  dw2p[((size_t)b * gridDim.y + rgi) * H + h] = dw;
}

// dw2 (H) = the sum of the n parts (n x H), in order.
__global__ void colsum_kernel(const float* __restrict__ part, int n, int H,
                              float* __restrict__ out) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sum = 0.0f;
  for (int i = 0; i < n; ++i) sum += part[(size_t)i * H + h];
  out[h] = sum;
}

// ---------------------------------------------------------------- 4
// part[z] (M x N) = sum over the rows of split z of A[row, m] Bm[row, n], a
// 64 (m) x 256 (n) tile a block on wgmma, both operands split as they are
// staged (a slab of 32 rows ahead, in registers); with bpart, also
// bpart[z, m] = sum over the rows of A[row, m] (blocks with blockIdx.y 0,
// the unrounded A).  BF16: both operands rounded to bf16, one pass.
constexpr int kGsM = mma::kMmaRows;
constexpr int kGsN = 256;
constexpr int kGsA = kGsM * mma::kSlab;
constexpr int kGsB = kGsN * mma::kSlab;
constexpr int kGsBytes = 2 * (kGsA + kGsB) * 4;

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
gsum_kernel(const float* __restrict__ A, int lda, int M, const float* __restrict__ Bm, int ldb,
            int N, long long n_rows, int splits, float* __restrict__ part,
            float* __restrict__ bpart) {
  using mma::core_word;
  extern __shared__ __align__(128) float smem[];
  uint32_t* const a_s = reinterpret_cast<uint32_t*>(smem);  // [2][kGsA]
  uint32_t* const b_s = a_s + 2 * kGsA;                     // [2][kGsB]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, wg = tid / 128;
  const int m0 = blockIdx.x * kGsM, n0 = blockIdx.y * kGsN, z = blockIdx.z;
  const long long per = (n_rows + splits - 1) / splits;
  const long long kb = min(n_rows, (long long)z * per), ke = min(n_rows, kb + per);
  const int nslab = (int)((ke - kb + mma::kSlab - 1) / mma::kSlab);
  // this thread forms k pairs 4 cc + t of A column am and of B columns
  // 8 (warp + 8 jj) + lane / 4 (a warp's words on 32 banks)
  const int t = tid % 4, am = tid / 4, bn = lane / 4;
  const bool a_ok = m0 + am < M;
  float pa[8], pb[32];
  float bsum = 0.0f;
  const auto load = [&](int sl) {
    const long long k0 = kb + (long long)sl * mma::kSlab;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long k = k0 + 2 * (4 * cc + t) + h;
        const bool ok = k < ke;
        pa[2 * cc + h] = (ok && a_ok) ? A[k * lda + m0 + am] : 0.0f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int n = n0 + 8 * (warp + 8 * jj) + bn;
          pb[8 * jj + 2 * cc + h] = (ok && n < N) ? Bm[k * ldb + n] : 0.0f;
        }
      }
  };
  const auto make = [&](int buf) {
    uint32_t* a = a_s + buf * kGsA;
    uint32_t* bb = b_s + buf * kGsB;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int st = cc / 2, kg = cc % 2;
      uint32_t hi, lo;
      mma::split2(pa[2 * cc], pa[2 * cc + 1], hi, lo);
      a[2 * st * (kGsM * 8) + core_word(am, kg, t)] = hi;
      a[(2 * st + 1) * (kGsM * 8) + core_word(am, kg, t)] = lo;
      bsum += pa[2 * cc] + pa[2 * cc + 1];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = 8 * (warp + 8 * jj) + bn;
        mma::split2(pb[8 * jj + 2 * cc], pb[8 * jj + 2 * cc + 1], hi, lo);
        bb[2 * st * (kGsN * 8) + core_word(n, kg, t)] = hi;
        bb[(2 * st + 1) * (kGsN * 8) + core_word(n, kg, t)] = lo;
      }
    }
  };

  mma::Acc acc;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  mma::fence_acc(acc);
  if (nslab > 0) {
    load(0);
    make(0);
    if (nslab > 1) load(1);
  }
  for (int sl = 0; sl < nslab; ++sl) {
    // slab sl is formed and visible to the tensor cores; every warpgroup is
    // done with slab sl - 1
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t* as = a_s + (sl & 1) * kGsA;
    const uint32_t* bs = b_s + (sl & 1) * kGsB + wg * 16 * 2 * mma::kCoreWords;
    mma::fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const uint64_t ah = mma::smem_desc(as + (2 * st) * (kGsM * 8), 128, 256);
      const uint64_t alo = mma::smem_desc(as + (2 * st + 1) * (kGsM * 8), 128, 256);
      const uint64_t bh = mma::smem_desc(bs + (2 * st) * (kGsN * 8), 128, 256);
      const uint64_t blo = mma::smem_desc(bs + (2 * st + 1) * (kGsN * 8), 128, 256);
      if constexpr (!BF16) {
        mma::wgmma_m64n128(acc, ah, blo);
        mma::wgmma_m64n128(acc, alo, bh);
      }
      mma::wgmma_m64n128(acc, ah, bh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the products of slab sl run while slab sl + 1 is formed
    if (sl + 1 < nslab) {
      make((sl + 1) & 1);
      if (sl + 2 < nslab) load(sl + 2);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    mma::fence_acc(acc);
  }
  const mma::Frag f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + f.row(h);
    if (m >= M) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + f.col(i, e);
        if (n < N) part[((size_t)z * M + m) * N + n] = acc[i][2 * h + e];
      }
  }
  if (bpart != nullptr && blockIdx.y == 0) {
    // the four pair groups of each m summed in a fixed order
    bsum += __shfl_xor_sync(0xffffffffu, bsum, 1);
    bsum += __shfl_xor_sync(0xffffffffu, bsum, 2);
    if (t == 0 && a_ok) bpart[(size_t)z * M + m0 + am] = bsum;
  }
}

// The splits summed in order.  cat (which == 0): part (splits, 4H, H) into
// dWatt (rows < H) and dWhh, bpart (splits, 4H) into dbhh (rows >= H); ctx
// (which == 1): part (splits, 3H, H) into dWctx.
__global__ void wsum_reduce(int which, const float* __restrict__ part,
                            const float* __restrict__ bpart, int splits, int H,
                            float* __restrict__ dwatt, float* __restrict__ dwhh,
                            float* __restrict__ dbhh, float* __restrict__ dwctx) {
  const int M = which == 0 ? 4 * H : 3 * H;
  const size_t n_w = (size_t)M * H;
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float sum = 0.0f;
  if (o < n_w) {
    for (int z = 0; z < splits; ++z) sum += part[(size_t)z * n_w + o];
    if (which == 1) {
      dwctx[o] = sum;
    } else if (o < (size_t)H * H) {
      dwatt[o] = sum;
    } else {
      dwhh[o - (size_t)H * H] = sum;
    }
  } else if (which == 0 && o < n_w + 3 * (size_t)H) {
    const size_t m = o - n_w + H;
    for (int z = 0; z < splits; ++z) sum += bpart[(size_t)z * M + m];
    dbhh[m - H] = sum;
  }
}

unsigned blocks_for(size_t n, int per) { return (unsigned)((n + per - 1) / per); }

int round_up_i(int x, int m) { return (x + m - 1) / m * m; }

// dynamic shared memory of the loop (ops/kernels/vsrn_dec.py::plan computes
// the same)
int loop_smem(int H, bool streamed, bool bf16) {
  const int kp1 = round_up_i(H, gru::kKAlign), kp4 = round_up_i(4 * H, gru::kKAlign);
  const int sw = bf16 ? step_words<true>() : step_words<false>();
  const int w3 = kp1 / 16 * sw;
  const int w1 = streamed ? gru::kStages * 2 * kChunkSteps * sw : kp4 / 16 * 2 * sw;
  return (w3 + w1) * 4;
}

template <int MT, bool S, bool BF16>
cudaError_t launch_loop(const LoopArgs& a, int blocks, int smem, cudaStream_t stream) {
  auto* kernel = loop_kernel<MT, S, BF16>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<LoopArgs*>(&a)};
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, (size_t)smem,
                                     stream);
}

// itrx_vsrn_dec_bwd in the mode BF16
template <bool BF16>
int run_bwd(const void* gxw, const void* cmask, const void* enco, const void* enca,
            const void* hall, const void* ghall, const void* ghs, const void* w2,
            const void* wattS, const void* wctxS, const void* f1, const void* f3, void* ggxw,
            void* gh0, void* genco, void* genca, void* dwatt, void* dw2, void* dwctx,
            void* dwhh, void* dbhh, void* ws_hq, void* ws_ctx, void* ws_gctx, void* ws_alpha,
            void* ws_ge, void* ws_gx, void* ws_cat, void* ws_eg, void* ws_gp, void* ws_dw2p,
            void* part0, void* bpart, void* part1, void* bar, int T, int B, int R, int H,
            int s8a, int s8c, int kpw, int splits, int halves, int blocks, int streamed,
            int smem, int device, void* stream) {
  const int kp1 = round_up_i(H, gru::kKAlign), kp4 = round_up_i(4 * H, gru::kKAlign);
  if (T < 1 || B < 1 || R < 1 || R > kMaxR || H < 1 || H > kMaxH || splits < 1 ||
      (halves != 1 && halves != 2) || blocks != halves * ((H + kUnits - 1) / kUnits) ||
      smem < loop_smem(H, streamed != 0, BF16) || s8a < 8 || s8a > 256 || s8a % 8 ||
      s8c < 8 || s8c > 256 || s8c % 8 || kpw != round_up_i(H, mma::kSlab)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const auto cu = [](const void* p) { return static_cast<const uint32_t*>(p); };
  const long long rows = (long long)T * B;
  const int H3 = 3 * H;

  // 1. the recomputation over all rows: hq, alpha and ctx, gx
  err = cudaFuncSetAttribute(proj_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kProjBytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned row_tiles = blocks_for(rows, mma::kMmaRows);
  proj_kernel<BF16><<<dim3(row_tiles, blocks_for(H, s8a)), kThreads, kProjBytes, st>>>(
      cf(hall), H, H, cu(wattS), kpw, s8a, nullptr, f(ws_hq), H, rows);
  itrx_vsrn::attend_kernel<<<(unsigned)rows, itrx_vsrn::kThreads, 0, st>>>(
      cf(enca), cf(enco), f(ws_hq), cf(w2), cf(cmask), f(ws_ctx), f(ws_alpha), B, R, H);
  proj_kernel<BF16><<<dim3(row_tiles, blocks_for(H3, s8c)), kThreads, kProjBytes, st>>>(
      cf(ws_ctx), H, H, cu(wctxS), kpw, s8c, cf(gxw), f(ws_gx), H3, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 2. the reverse loop; the exchanges' pad columns read as zero
  if (kp4 > 4 * H) {
    err = cudaMemsetAsync(ws_eg, 0, sizeof(float) * B * kp4, st);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(ws_cat, 0, sizeof(float) * rows * kp4, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const LoopArgs a{cf(ws_gx), ghall, cf(hall), cf(ghs), cf(cmask), cf(enco), cf(enca),
                   cf(ws_hq), cf(ws_alpha), cf(w2), cu(f1), cu(f3), f(ggxw), f(gh0),
                   f(ws_eg), f(ws_cat), f(ws_gctx), f(ws_ge), f(ws_gp),
                   static_cast<unsigned*>(bar), T, B, R, H, kp1, kp4};
  if (halves == 2) {
    // two blocks a unit slice only where the weights stay resident (H <= 528)
    err = streamed ? cudaErrorInvalidValue : launch_loop<4, false, BF16>(a, blocks, smem, st);
  } else {
    err = streamed ? launch_loop<8, true, BF16>(a, blocks, smem, st)
                   : launch_loop<8, false, BF16>(a, blocks, smem, st);
  }
  if (err != cudaSuccess) return (int)err;

  // 3. the attention's sums over t
  const int rgroups = (R + kSumRegions - 1) / kSumRegions;
  attn_sums_kernel<<<dim3(blocks_for(H, kSumCols), rgroups, B), kSumCols, 0, st>>>(
      cf(enca), f(ws_hq), f(ws_alpha), f(ws_gctx), f(ws_ge), cf(w2), f(genco), f(genca),
      f(ws_dw2p), T, B, R, H);
  colsum_kernel<<<blocks_for(H, 256), 256, 0, st>>>(f(ws_dw2p), B * rgroups, H, f(dw2));

  // 4. the weight sums over every row, in fixed splits summed in order
  err = cudaFuncSetAttribute(gsum_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGsBytes);
  if (err != cudaSuccess) return (int)err;
  gsum_kernel<BF16><<<dim3(blocks_for(4 * H, kGsM), blocks_for(H, kGsN), splits), kThreads, kGsBytes,
                st>>>(f(ws_cat), kp4, 4 * H, cf(hall), H, H, rows, splits, f(part0), f(bpart));
  gsum_kernel<BF16><<<dim3(blocks_for(H3, kGsM), blocks_for(H, kGsN), splits), kThreads, kGsBytes,
                st>>>(f(ggxw), H3, H3, f(ws_ctx), H, H, rows, splits, f(part1), nullptr);
  const size_t n0 = (size_t)4 * H * H + H3, n1 = (size_t)H3 * H;
  wsum_reduce<<<blocks_for(n0, 256), 256, 0, st>>>(0, f(part0), f(bpart), splits, H, f(dwatt),
                                                  f(dwhh), f(dbhh), nullptr);
  wsum_reduce<<<blocks_for(n1, 256), 256, 0, st>>>(1, f(part1), nullptr, splits, H, nullptr,
                                                  nullptr, nullptr, f(dwctx));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward of itrx_vsrn_dec_fwd (bf16 != 0: its bf16 mode, wattS and wctxS
// split from bf16 weights, f1 and f3 the bf16 weights' fragments alone, ghall
// bf16).  In, fp32 (but ghall) and contiguous: gxw (T, B, 3H),
// cmask (T, B, H), enco, enca (B, R, H), hall (T, B, H), ghall (T, B, 3H),
// ghs (T, B, H), w2 (H); wattS and wctxS Watt (H, H) and Wctx (3H, H) split
// for the tensor cores (ops/kernels/vsrn_dec.py::split_rows: chunks of s8a
// and s8c rows of kpw words, kpw = H rounded up to 32); the loop's split B
// fragments f1 and f3 (ops/kernels/vsrn_dec.py::loop_weights: per group of 8
// units, kp4 / 16 and kp1 / 16 k16 steps of 2 and 1 n8 tiles; kp1, kp4 = H,
// 4H rounded up to 64).  Out, fp32: ggxw (T, B, 3H), gh0 (B, H),
// genco, genca (B, R, H), dwatt (H, H), dw2 (H), dwctx (3H, H), dwhh (3H, H),
// dbhh (3H).  Workspaces, fp32: hq, ctx, gctx of T x B x H, alpha and ge of
// T x B x R, gx of T x B x 3H, cat of T x B x kp4, eg of B x kp4, gp of B x H,
// dw2p of B x ceil(R / 4) x H, part0 of splits x 4H x H, bpart of splits x
// 4H, part1 of splits x 3H x H; bar two words.  1 <= R <= 128, 1 <= H <=
// 1024, splits >= 1.  The loop runs as one cooperative launch of `blocks` =
// halves x ceil(H / 8) blocks of 8 hidden units, each reading 1 / `halves`
// (1 or 2) of every exchange row block, f1's fragments `streamed` or
// resident, `smem` bytes of dynamic shared memory.  Launches on `stream` of CUDA
// device `device`, none of which the host waits for; returns the first CUDA
// error (cudaErrorInvalidValue for a plan the kernels cannot take,
// cudaErrorCooperativeLaunchTooLarge for a grid that cannot be co-resident)
// or 0.
int itrx_vsrn_dec_bwd(const void* gxw, const void* cmask, const void* enco, const void* enca,
                      const void* hall, const void* ghall, const void* ghs, const void* w2,
                      const void* wattS, const void* wctxS, const void* f1,
                      const void* f3, void* ggxw, void* gh0, void* genco, void* genca,
                      void* dwatt, void* dw2, void* dwctx, void* dwhh, void* dbhh, void* ws_hq,
                      void* ws_ctx, void* ws_gctx, void* ws_alpha, void* ws_ge, void* ws_gx,
                      void* ws_cat, void* ws_eg, void* ws_gp, void* ws_dw2p, void* part0,
                      void* bpart, void* part1, void* bar, int T, int B, int R, int H,
                      int s8a, int s8c, int kpw, int splits, int halves, int blocks,
                      int streamed, int smem, int bf16, int device, void* stream) {
  return bf16 ? run_bwd<true>(gxw, cmask, enco, enca, hall, ghall, ghs, w2, wattS, wctxS, f1, f3,
                              ggxw, gh0, genco, genca, dwatt, dw2, dwctx, dwhh, dbhh, ws_hq,
                              ws_ctx, ws_gctx, ws_alpha, ws_ge, ws_gx, ws_cat, ws_eg, ws_gp,
                              ws_dw2p, part0, bpart, part1, bar, T, B, R, H, s8a, s8c, kpw,
                              splits, halves, blocks, streamed, smem, device, stream)
              : run_bwd<false>(gxw, cmask, enco, enca, hall, ghall, ghs, w2, wattS, wctxS, f1,
                               f3, ggxw, gh0, genco, genca, dwatt, dw2, dwctx, dwhh, dbhh, ws_hq,
                               ws_ctx, ws_gctx, ws_alpha, ws_ge, ws_gx, ws_cat, ws_eg, ws_gp,
                               ws_dw2p, part0, bpart, part1, bar, T, B, R, H, s8a, s8c, kpw,
                               splits, halves, blocks, streamed, smem, device, stream);
}

#ifdef ITRX_VSRN_DEC_PHASES
// the loop's phase times of the last launch (ns, block 0)
int itrx_vsrn_dec_bwd_phases(void* out) {
  return (int)cudaMemcpyFromSymbol(out, vsrn_loop::g_phase_ns,
                                   sizeof(vsrn_loop::g_phase_ns));
}
#endif

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
