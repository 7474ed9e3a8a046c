// VSRN's teacher-forced caption decoder, the forward, for sm_90a.
//
// Replaces itrx/ops/pallas/vsrn_dec.py::_fwd_kernel.  From h_0 (the region
// encoder's final state), for t = 0 .. T-1:
//   hq   = h Watt^T                         (B x H, the decoder-state half of
//                                            the attention's linear1)
//   ctx  = attention(enc_att + hq, enc_out) * cmask_t
//   gx   = ctx Wctx^T + gxw_t,  gh = h Whh^T + bhh
//   r = sig(gx_r + gh_r), z = sig(gx_z + gh_z), n = tanh(gx_n + r gh_n)
//   h    = (1 - z) n + z h                  -> hs[t]
// with the residuals hall[t] = h_{t-1} and ghall[t] = gh for the backward.
//
// What bounds it: the products, 2 B H^2 x 7 a step, in T steps that follow
// each other.  At B 128, H 512 a step's products are 0.47 GFLOP, about a
// microsecond at the TF32 peak, so a step's latency (dependent L2 reads and
// grid-wide waits), not its work, paces the loop.  Design: the time loop as
// one persistent cooperative launch, a block an SM (vsrn_dec_bwd.cu's
// reverse loop run forwards; gru_persistent.cuh's grid barrier,
// vsrn_dec_loop.cuh's product).  A block owns 8 hidden units j and keeps its
// split B fragments of [Watt ; Whh] (four n8 tiles) and Wctx (three) in
// shared memory for all steps (Wctx's streamed through a cp.async ring where
// both do not fit: H above 960); where the card has room (H <= 528 on 132
// SMs) two blocks share the units, each taking half of the batch rows.  Every
// product runs on the tensor cores as a split-bf16 mma.sync (x = hi + lo both
// bf16, three passes, fp32 accumulation), so the states keep fp32 accuracy.
// A step is three phases between three grid barriers:
//   1. from one read of the state exchange h_{t-1} (B x Kp at L2): hq[:, j]
//      to the hq exchange, gh[:, j] = (h Whh^T)[:, j] + bhh to ghall[t];
//   2. the attention, a block a batch row: e_r = tanh(enc_att_r + hq) . w2,
//      the softmax over R, ctx = (sum_r alpha_r enc_out_r) cmask_t to the
//      context exchange (attend_kernel's arithmetic);
//   3. gx[:, j] = ctx Wctx^T + gxw_t, then the cell on the block's units,
//      which writes h_t to the state exchange and hs[t], h_{t-1} to hall[t].
// Both products map a (row, unit) to the same thread, so gh and h_{t-1} of
// a unit are read back only by the thread that wrote them.
// The bf16 mode (bf16 operands, the train_bf16 step): the TPU kernel at
// dot_dtype="bfloat16".  The B fragments are the bf16 weights alone, h and
// the masked context are rounded to bf16 as the products read them, one
// a_hi b_hi pass each, fp32 accumulation; enc_out comes as its fp32 values
// and the attention, the cell and the states stay fp32.  gh reaches the
// cell in fp32 through a B x 3H workspace and is saved in bf16 (ghall16),
// as the TPU kernel saves it.  No atomics and
// every sum in a fixed order, so two calls give identical states; nothing is
// read back to the host.
#ifdef ITRX_VSRN_DEC_FWD_PHASES
// the loop's phases as block 0's thread 0 sees them (tools/vsrn_dec_phases.py)
#define ITRX_VSRN_LOOP_PHASES 6
#endif
#include <cuda_bf16.h>

#include "gru_persistent.cuh"
#include "vsrn_dec.cuh"
#include "vsrn_dec_loop.cuh"

namespace {

using itrx_vsrn::kMaxH;
using itrx_vsrn::kMaxR;
using itrx_vsrn::sigmoid_f;
using itrx_vsrn::warp_max;
using itrx_vsrn::warp_sum;
using vsrn_loop::kChunkSteps;
using vsrn_loop::step_words;
using vsrn_loop::kUnits;
using vsrn_loop::product_mma;
using vsrn_loop::ring_issue_frag;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kTilesH = 4;  // n8 tiles of the product over h: Watt, Whh's r, z, n
constexpr int kTilesC = 3;  // of the product over ctx: Wctx's r, z, n

struct FwdArgs {
  const float* gxw;     // (T, B, 3H)
  const float* cmask;   // (T, B, H)
  const float* enco;    // (B, R, H)
  const float* enca;    // (B, R, H)
  const float* w2;      // (H)
  const float* bhh;     // (3H)
  const uint32_t* fh;   // [Watt ; Whh]'s split B fragments: a unit group's Kp / 16
                        // k16 steps x 4 n8 tiles (fwd_weights)
  const uint32_t* fc;   // Wctx's: Kp / 16 steps x 3 tiles
  float* hs;            // (T, B, H) out
  float* hall;          // (T, B, H) out, or null
  float* gh;            // ghall (T, B, 3H) out, or a B x 3H workspace (gh_step 0)
  __nv_bfloat16* gh16;  // the bf16 mode's ghall (T, B, 3H) out, or null
  float* hx;            // (B, Kp) state exchange: h_0 at the launch, zero past H
  float* hq;            // (B, H) exchange
  float* cx;            // (B, Kp) context exchange, zero past H
  unsigned* bar;        // grid barrier, two zeroed words
  long long gh_step;    // B 3H, or 0
  int T, B, R, H, Kp;
};

// The attention of batch row b at step t (attend_kernel's arithmetic, the
// score rows four at a time a warp and the context two columns at a time a
// thread): ctx = (softmax_r(tanh(enc_att_r + hq) . w2) enc_out) cmask_t into
// row b of the context exchange.  Ends with a barrier of the block.
__device__ __forceinline__ void attend_row(const FwdArgs& p, int t, int b, float* qs,
                                           const float* w2s, float* es) {
  const int H = p.H, R = p.R, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int k = tid; k < H; k += kThreads) qs[k] = __ldcg(p.hq + (size_t)b * H + k);
  __syncthreads();
  const float* ea = p.enca + (size_t)b * R * H;
  for (int r0 = warp; r0 < R; r0 += 4 * kWarps) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int k = lane; k < H; k += 32) {
      const float q = qs[k], w = w2s[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + kWarps * i;
        if (r < R) s[i] = fmaf(tanhf(ea[(size_t)r * H + k] + q), w, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = warp_sum(s[i]);
      if (lane == 0 && r0 + kWarps * i < R) es[r0 + kWarps * i] = s[i];
    }
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -3.0e38f;
    for (int r = lane; r < R; r += 32) mx = fmaxf(mx, es[r]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int r = lane; r < R; r += 32) {
      const float e = expf(es[r] - mx);
      es[r] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int r = lane; r < R; r += 32) es[r] *= inv;
  }
  __syncthreads();
  const float* eo = p.enco + (size_t)b * R * H;
  const float* cm = p.cmask + ((size_t)t * p.B + b) * H;
  float* out = p.cx + (size_t)b * p.Kp;
  for (int k = tid; k < H; k += 2 * kThreads) {
    const int k2 = k + kThreads;
    const bool two = k2 < H;
    float c = 0.0f, c2 = 0.0f;
#pragma unroll 6
    for (int r = 0; r < R; ++r) {
      const float a = es[r];
      c = fmaf(a, eo[(size_t)r * H + k], c);
      if (two) c2 = fmaf(a, eo[(size_t)r * H + k2], c2);
    }
    out[k] = c * __ldcg(cm + k);
    if (two) out[k2] = c2 * __ldcg(cm + k2);
  }
  __syncthreads();  // the row's buffers are free
}

// The inputs of the cell at one (row, unit), loaded during the ctx product
struct CellIn {
  float x[3], hh[3], hp;
};

// The decode loop, a block an SM.  Block i owns hidden units j0 = (i /
// halves) 8 .. j0 + 7 and, of the batch cut in tiles of 16 MT rows, the tiles
// i % halves, i % halves + halves, ... (halves = 8 / MT).  In the warps of
// part 0 of the products, thread (warp, lane) owns, of each of its tiles,
// rows 16 (warp % MT) + lane / 4 + 8 h and units j0 + 2 (lane % 4) + e (h, e
// in {0, 1}): the products' output map, the same in both.
template <int MT, bool STREAM, bool BF16>
__global__ void __launch_bounds__(kThreads, 1) loop_kernel(const FwdArgs p) {
  using namespace gru;
  constexpr int kTile = 16 * MT, kHalves = 8 / MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float qs[kMaxH], w2s[kMaxH];
  __shared__ float es[kMaxR];
  __shared__ __align__(16) float part_s[4 * 32 * kTilesH * 4];
  const int T = p.T, B = p.B, H = p.H, H3 = 3 * H, Kp = p.Kp;
  const int words_h = Kp / 16 * kTilesH * step_words<BF16>();
  const int words_c = Kp / 16 * kTilesC * step_words<BF16>();
  uint32_t* const wh = reinterpret_cast<uint32_t*>(smem_raw);  // [Watt ; Whh]'s, resident
  uint32_t* const wc = wh + words_h;                           // Wctx's, or the ring
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4, mt = warp % MT;
  const bool owner = warp < MT;  // part 0 of the products
  const int half = blockIdx.x % kHalves, group = blockIdx.x / kHalves;
  const int j0 = group * kUnits;
  const int n_tiles = (B + kTile - 1) / kTile;
  const int my_tiles = n_tiles > half ? (n_tiles - half + kHalves - 1) / kHalves : 0;
  const int per = Kp / kKAlign, total = STREAM ? T * my_tiles * per : 0;
  // where the block's walks over the depth start (chunks of kKAlign columns)
  const int rot = group % per;
  const uint32_t* fh = p.fh + (size_t)group * words_h;
  const uint32_t* fc = p.fc + (size_t)group * words_c;
  int chunk = 0, no_chunk = 0;

  for (int i = 4 * tid; i < words_h; i += 4 * kThreads) cp_async16(wh + i, fh + i, 16);
  if constexpr (!STREAM) {
    for (int i = 4 * tid; i < words_c; i += 4 * kThreads) cp_async16(wc + i, fc + i, 16);
  }
  cp_async_commit();
  if constexpr (STREAM) {
    for (int i = 0; i < kStages - 1; ++i) {
      ring_issue_frag<kTilesC, BF16>(wc, i, total, per, rot, fc);
    }
  }
  for (int k = tid; k < H; k += kThreads) w2s[k] = p.w2[k];
  const auto row_of = [&](int b0, int h) { return b0 + 16 * mt + g + 8 * h; };
  const auto unit_of = [&](int e) { return j0 + 2 * tq + e; };
  float bh[3][2];  // bhh at the thread's units
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) bh[q][e] = unit_of(e) < H ? p.bhh[q * H + unit_of(e)] : 0.0f;
  // the resident fragments are in before the first product; a streamed
  // ring's groups are waited for as they are used
  cp_async_wait<STREAM ? kStages - 1 : 0>();
  __syncthreads();

  PHASE_START
  for (int t = 0; t < T; ++t) {
    const size_t tB = (size_t)t * B;
    float* gh_t = p.gh + t * p.gh_step;
    // from one read of the state exchange: hq[:, j] and gh[:, j]
    for (int tl = half; tl < n_tiles; tl += kHalves) {
      const int b0 = tl * kTile;
      float d[kTilesH][4];
      product_mma<MT, kTilesH, false, BF16>(d, p.hx + (size_t)b0 * Kp, Kp, B - b0, wh, Kp, rot,
                                            no_chunk, 0, nullptr, part_s);
      if (owner) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = row_of(b0, h), j = unit_of(e);
            if (b < B && j < H) {
              p.hq[(size_t)b * H + j] = d[0][2 * h + e];
              float* o = gh_t + (size_t)b * H3 + j;
#pragma unroll
              for (int q = 0; q < 3; ++q) o[q * H] = d[1 + q][2 * h + e] + bh[q][e];
              if (p.gh16 != nullptr) {
                __nv_bfloat16* o16 = p.gh16 + (tB + b) * H3 + j;
#pragma unroll
                for (int q = 0; q < 3; ++q) o16[q * H] = __float2bfloat16(o[q * H]);
              }
            }
          }
      }
    }
    PHASE(0)
    grid_sync(p.bar);  // every hq row of step t is whole
    PHASE(1)
    for (int b = blockIdx.x; b < B; b += gridDim.x) attend_row(p, t, b, qs, w2s, es);
    PHASE(2)
    grid_sync(p.bar);  // every context row of step t is whole
    PHASE(3)
    // gx[:, j] = ctx Wctx^T + gxw_t, then the cell
    for (int tl = half; tl < n_tiles; tl += kHalves) {
      const int b0 = tl * kTile;
      CellIn in[2][2];
      if (owner) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = row_of(b0, h), j = unit_of(e);
            if (b >= B || j >= H) continue;
            const float* x = p.gxw + (tB + b) * H3 + j;
            const float* hh = gh_t + (size_t)b * H3 + j;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              in[h][e].x[q] = __ldcg(x + q * H);
              in[h][e].hh[q] = __ldcg(hh + q * H);
            }
            in[h][e].hp = __ldcg(p.hx + (size_t)b * Kp + j);
          }
      }
      float d[kTilesC][4];
      product_mma<MT, kTilesC, STREAM, BF16>(d, p.cx + (size_t)b0 * Kp, Kp, B - b0, wc, Kp,
                                             rot, chunk, total, fc, part_s);
      if (owner) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = row_of(b0, h), j = unit_of(e);
            if (b >= B || j >= H) continue;
            const CellIn& v = in[h][e];
            const float r = sigmoid_f(d[0][2 * h + e] + v.x[0] + v.hh[0]);
            const float z = sigmoid_f(d[1][2 * h + e] + v.x[1] + v.hh[1]);
            const float n = tanhf(d[2][2 * h + e] + v.x[2] + r * v.hh[2]);
            const float hn = (1.0f - z) * n + z * v.hp;
            const size_t o = (tB + b) * H + j;
            p.hs[o] = hn;
            if (p.hall != nullptr) p.hall[o] = v.hp;
            p.hx[(size_t)b * Kp + j] = hn;
          }
      }
    }
    PHASE(4)
    if (t + 1 < T) grid_sync(p.bar);  // every unit of h_t is out
    PHASE(5)
  }
  PHASE_END
}

int round_up_i(int x, int m) { return (x + m - 1) / m * m; }

// dynamic shared memory of the loop (ops/kernels/vsrn_dec.py::fwd_plan
// computes the same)
int fwd_smem(int H, bool streamed, bool bf16) {
  const int kp = round_up_i(H, gru::kKAlign);
  const int sw = bf16 ? step_words<true>() : step_words<false>();
  const int wh = kp / 16 * kTilesH * sw;
  const int wc = streamed ? gru::kStages * kTilesC * kChunkSteps * sw : kp / 16 * kTilesC * sw;
  return (wh + wc) * 4;
}

template <int MT, bool S, bool BF16>
cudaError_t launch_loop(const FwdArgs& a, int blocks, int smem, cudaStream_t stream) {
  auto* kernel = loop_kernel<MT, S, BF16>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<FwdArgs*>(&a)};
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, (size_t)smem,
                                     stream);
}

}  // namespace

extern "C" {

// In, fp32 and contiguous: gxw (T, B, 3H), cmask (T, B, H), enco, enca (B, R,
// H), h0 (B, H), w2 (H), bhh (3H); the loop's split B fragments fh of [Watt ;
// Whh] and fc of Wctx (bf16 != 0: the bf16 mode, fragments of the bf16
// weights alone) (ops/kernels/vsrn_dec.py::fwd_weights: per group of 8
// units, kp / 16 k16 steps of 4 and 3 n8 tiles; kp = H rounded up to 64).
// Out, fp32: hs (T, B, H); hall (T, B, H) when not null; ghall (T, B, 3H)
// when not null (bf16 in the bf16 mode, whose gh always goes through ws_gh),
// else the B x 3H workspace ws_gh takes gh.  Workspaces,
// fp32: ws_hx and ws_cx of B x kp, ws_hq of B x H; bar two words.  1 <= R <=
// 128, 1 <= H <= 1024.  One cooperative launch of `blocks` = halves x
// ceil(H / 8) blocks of 8 hidden units, each taking 1 / `halves` (1 or 2) of
// the batch row tiles, Wctx's fragments `streamed` or resident, `smem` bytes
// of dynamic shared memory, after the exchanges are set (memsets and a copy
// of h0).  Launches on `stream` of CUDA device `device`, none of which the
// host waits for; returns the first CUDA error (cudaErrorInvalidValue for a
// plan the kernel cannot take, cudaErrorCooperativeLaunchTooLarge for a grid
// that cannot be co-resident) or 0.
int itrx_vsrn_dec_fwd(const void* gxw, const void* cmask, const void* enco, const void* enca,
                      const void* h0, const void* w2, const void* bhh, const void* fh,
                      const void* fc, void* hs, void* hall, void* ghall, void* ws_hx,
                      void* ws_hq, void* ws_cx, void* ws_gh, void* bar, int T, int B, int R,
                      int H, int halves, int blocks, int streamed, int smem, int bf16,
                      int device, void* stream) {
  if (T < 1 || B < 1 || R < 1 || R > kMaxR || H < 1 || H > kMaxH ||
      (halves != 1 && halves != 2) || (halves == 2 && streamed) ||
      blocks != halves * ((H + kUnits - 1) / kUnits) ||
      smem < fwd_smem(H, streamed != 0, bf16 != 0) ||
      (ghall == nullptr && ws_gh == nullptr) || (bf16 && ws_gh == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kp = round_up_i(H, gru::kKAlign);
  const size_t row = sizeof(float) * kp;
  // the exchanges: h_0 and zero past H
  if (kp > H) {
    err = cudaMemsetAsync(ws_hx, 0, row * B, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(ws_cx, 0, row * B, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaMemcpy2DAsync(ws_hx, row, h0, sizeof(float) * H, sizeof(float) * H, B,
                          cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const auto cu = [](const void* p) { return static_cast<const uint32_t*>(p); };
  // fp32 ghall takes gh itself; the bf16 mode's gh goes through ws_gh and
  // leaves in bf16
  const bool gh_out = ghall != nullptr && !bf16;
  const FwdArgs a{cf(gxw), cf(cmask), cf(enco), cf(enca), cf(w2), cf(bhh), cu(fh), cu(fc),
                  f(hs), f(hall), gh_out ? f(ghall) : f(ws_gh),
                  bf16 ? static_cast<__nv_bfloat16*>(ghall) : nullptr, f(ws_hx), f(ws_hq),
                  f(ws_cx), static_cast<unsigned*>(bar), gh_out ? (long long)B * 3 * H : 0LL,
                  T, B, R, H, kp};
  if (bf16) {
    if (halves == 2) {
      err = launch_loop<4, false, true>(a, blocks, smem, st);
    } else {
      err = streamed ? launch_loop<8, true, true>(a, blocks, smem, st)
                     : launch_loop<8, false, true>(a, blocks, smem, st);
    }
  } else if (halves == 2) {
    err = launch_loop<4, false, false>(a, blocks, smem, st);
  } else {
    err = streamed ? launch_loop<8, true, false>(a, blocks, smem, st)
                   : launch_loop<8, false, false>(a, blocks, smem, st);
  }
  return (int)err;
}

#ifdef ITRX_VSRN_DEC_FWD_PHASES
// the loop's phase times of the last launch (ns, block 0)
int itrx_vsrn_dec_fwd_phases(void* out) {
  return (int)cudaMemcpyFromSymbol(out, vsrn_loop::g_phase_ns,
                                   sizeof(vsrn_loop::g_phase_ns));
}
#endif

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
