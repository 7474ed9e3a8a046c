// Masked GRU adjoint (backward of csrc/gru.cu), for sm_90a: one persistent
// cooperative launch per call (per batch chunk of at most 128 rows).
//
// Replaces itrx/ops/pallas/gru.py::_bwd_kernel.  The TPU kernel walks the
// sequence in the opposite order of the forward, one timestep per grid step,
// with the whole (3H, H) recurrent weight resident in VMEM and the carry
// gradient in a VMEM scratch.  Per step t it recomputes the gates from the
// saved h_{t-1} (hall) and gh = h_{t-1} . W_hh^T + b_hh (ghall), emits the
// gate gradients ggx[t] = [g_prer | g_prez | g_pren] and ghn[t] = g_pren * r,
// and carries
//     g_prev = (1 - m) g_carry + g_hnew z + [g_prer | g_prez | ghn] . W_hh.
// dW_hh, db_hh and the input-side gradients are large matmuls outside the
// kernel (itrx_torch/ops/kernels/gru.py).
//
// What bounds it here: L sequential steps, each a (B, 3H) x (3H, H) product
// whose weight (12.6 MB fp32 at H 1024) one SM cannot hold, and whose
// reduction over 3H needs the gate gradients of every hidden unit.  Design,
// the forward's persistent shape (csrc/gru_persistent.cuh): one block per SM,
// each owning `U` hidden units k and holding columns k of W_hh (rows k of
// W_hh^T, which the wrapper passes: 3H x U fp32, 96 KB at H 1024 over 128
// blocks) in shared memory for the whole sequence.  A step: the block
// computes the gate gradients of its units from the residuals and its carry
// gradient (which never leaves the block: it stays in registers), writes
// them out, publishes g_gh = [g_prer | g_prez | ghn] (B x 3U) to a
// double-buffered exchange, meets the other blocks at one grid barrier, then
// reduces the full g_gh (B x 3H, read at L2: 1.57 MB a block a step at B 128,
// H 1024) against its columns into its units' carry gradient.  The product
// is register-tiled fp32 FMAs (no TF32) summed in a fixed order, and nothing
// is summed with atomics, so two calls are bit-identical.  Column slices too large to stay resident (H > 1152 at 16
// units: VSRN's H 2048) stream through the 4-stage cp.async ring each step.
//
// bf16 mode (bf16 W_hh, the train_bf16 step): the TPU kernel's arithmetic at
// dot_dtype="bfloat16".  gx and ghall are read as bf16 values (the TPU saves
// ghall and feeds gx in bf16; here both stay fp32 in memory and round as
// they load), the carry gradient stays fp32, g_gh is published to the
// exchange in bf16 and reduced against the bf16 columns on tensor cores
// (gru_persistent.cuh's product_bf16, mma.sync m16n8k16, fp32 accumulation,
// a fixed order), and ggx and ghn are written as bf16 values.  Its slices
// stay resident (49,664 B a block at H 1024, 197,632 B at H 2048).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "gru_persistent.cuh"

namespace {

using namespace gru;

// W: weight and exchange type (bf16: tensor cores; fp32: FMAs).  U: hidden
// units a block.  STREAM: the fp32 slice streams through the ring.  A thread
// owns R rows (rowg + (16 / R) i) times U / (2 R) units (unit[a]): fp32 R = 4
// and the units reduce_lanes leaves it; bf16 R = 2 and the units of its mma
// accumulator fragment.
template <typename W, int U, bool STREAM>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_kernel(const float* __restrict__ gx,      // (B, L, 3H) input gates
               const float* __restrict__ mask,    // (B, L)
               const float* __restrict__ hall,    // (B, L, H) h_{t-1}
               const float* __restrict__ ghall,   // (B, L, 3H) gh
               const float* __restrict__ gout,    // (B, L, H) or nullptr (zero)
               const float* __restrict__ gfinal,  // (B, H) or nullptr (zero)
               const W* __restrict__ wt,          // W_hh^T (H, ldw)
               int ldw,
               W* ebuf,                           // (2, B, round_up(3H, 64)) g_gh exchange
               unsigned* bar,                     // grid barrier, zeroed
               float* __restrict__ ggx,           // (B, L, 3H)
               float* __restrict__ ghn,           // (B, L, H)
               float* __restrict__ gh0,           // (B, H)
               int B, int L, int H, int reverse) {
  constexpr bool kMMA = std::is_same<W, __nv_bfloat16>::value;
  static_assert(!(kMMA && STREAM), "the bf16 slice always fits (plan)");
  constexpr int R = kMMA ? 2 : 4;  // rows a lane: rowg + kStep i
  constexpr int S = 2 * R;         // lanes that split K for one row group
  constexpr int A = U / S;         // units a lane
  constexpr int kStep = 16 / R;
  constexpr bool kPrefetch = kMMA || U == 8;
  // x as the mode reads it: rounded to bf16 in the bf16 mode
  const auto in_w = [](float x) { return kMMA ? bf16_round(x) : x; };
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* ws = reinterpret_cast<W*>(smem_raw);
  const int H3 = 3 * H;
  const int Kp = round_up(H3, kKAlign);
  const int per_product = Kp / kKAlign;
  const int ld = STREAM ? kKAlign + kPadF32 : Kp + (kMMA ? kPadBf16 : kPadF32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane / S, c = lane % S;
  const int rowg = 16 * warp + rg;
  const bool live = 16 * warp < B;
  const int j0 = blockIdx.x * U;
  const int total = STREAM ? L * per_product : 0;
  int chunk = 0;

  if constexpr (STREAM) {
    for (int i = 0; i < kStages - 1; ++i) {
      ring_issue<U, U>(reinterpret_cast<float*>(ws), i, total, per_product,
                       reinterpret_cast<const float*>(wt), ldw, 0, j0, H, H3);
    }
  } else {
    load_resident<W, U, U>(ws, ld, wt, ldw, 0, j0, H, H3, Kp);
  }
  if (blockIdx.x == 0 && Kp > H3) {  // the exchange's pad columns stay zero
    const int pad = Kp - H3;
    for (int idx = threadIdx.x; idx < 2 * B * pad; idx += kThreads) {
      const int row = idx / pad;
      ebuf[(size_t)row * Kp + H3 + (idx - row * pad)] = zero_of<W>();
    }
  }

  // the thread's pairs: rows rowg + kStep r; units S a + c (reduce_lanes'
  // map) or the mma accumulator's
  int unit[A];
  float gc[A][R];  // carry gradient
#pragma unroll
  for (int a = 0; a < A; ++a) {
    unit[a] = kMMA ? 8 * (a >> 1) + 2 * c + (a & 1) : S * a + c;
    const int k = j0 + unit[a];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = rowg + kStep * r;
      gc[a][r] = (gfinal != nullptr && row < B && k < H) ? gfinal[(size_t)row * H + k] : 0.0f;
    }
  }

  // a step's residuals for the thread's pairs, loaded a step ahead
  struct Step {
    float x[3][A][R], hh[3][A][R], hp[A][R], go[A][R], m[R];
  };
  auto load_step = [&](int t, Step& v) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = rowg + kStep * r;
      const size_t bt = (size_t)row * L + t;
      v.m[r] = row < B ? mask[bt] : 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int k = j0 + unit[a];
        const bool ok = row < B && k < H;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          v.x[q][a][r] = ok ? in_w(gx[bt * H3 + q * H + k]) : 0.0f;
          v.hh[q][a][r] = ok ? in_w(ghall[bt * H3 + q * H + k]) : 0.0f;
        }
        v.hp[a][r] = ok ? hall[bt * H + k] : 0.0f;
        v.go[a][r] = (ok && gout != nullptr) ? gout[bt * H + k] : 0.0f;
      }
    }
  };

  Step cur, nxt;
  load_step(reverse ? 0 : L - 1, cur);

  for (int s = 0; s < L; ++s) {
    const int t = reverse ? s : L - 1 - s;
    W* E = ebuf + (size_t)(s & 1) * B * Kp;
    float loc[A][R];  // (1 - m) g_carry + g_hnew z, the carry gradient's local terms
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int k = j0 + unit[a];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = rowg + kStep * r;
        loc[a][r] = 0.0f;
        if (row >= B || k >= H) continue;
        const float hr = cur.hh[0][a][r], hz = cur.hh[1][a][r], hn = cur.hh[2][a][r];
        const float gate_r = sigmoidf_(cur.x[0][a][r] + hr);
        const float gate_z = sigmoidf_(cur.x[1][a][r] + hz);
        const float gate_n = tanhf(cur.x[2][a][r] + gate_r * hn);
        const float m = cur.m[r];
        const float g_hnew = m * (gc[a][r] + cur.go[a][r]);
        const float g_n = g_hnew * (1.0f - gate_z);
        const float g_z = g_hnew * (cur.hp[a][r] - gate_n);
        const float g_pren = g_n * (1.0f - gate_n * gate_n);
        const float g_hn = g_pren * gate_r;
        const float g_prer = g_pren * hn * gate_r * (1.0f - gate_r);
        const float g_prez = g_z * gate_z * (1.0f - gate_z);
        const size_t bt = (size_t)row * L + t;
        ggx[bt * H3 + k] = in_w(g_prer);
        ggx[bt * H3 + H + k] = in_w(g_prez);
        ggx[bt * H3 + 2 * H + k] = in_w(g_pren);
        ghn[bt * H + k] = in_w(g_hn);
        W* e = E + (size_t)row * Kp;
        e[k] = to_w<W>(g_prer);
        e[H + k] = to_w<W>(g_prez);
        e[2 * H + k] = to_w<W>(g_hn);
        loc[a][r] = (1.0f - m) * gc[a][r] + g_hnew * gate_z;
      }
    }
    // the next step's residuals load during the barrier and the product,
    // where the registers allow (at 16 units the product's own need them)
    if (kPrefetch && s + 1 < L) load_step(reverse ? s + 1 : L - 2 - s, nxt);
    grid_sync(bar);

    // g_gh . W_hh[:, units] for the warp's rows
    float res[R][1][A];
    if constexpr (kMMA) {
      if (live) {
        float d[U / 8][4];
        product_bf16<U / 8>(d, E, Kp, rowg, B, ws, ld, Kp, rg, c);
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int r = 0; r < R; ++r) res[r][0][a] = d[a >> 1][2 * r + (a & 1)];
      }
    } else {
      product_f32<R, 1, U, STREAM>(res, E, Kp, rowg, B, live, ws, ld, Kp, c, chunk, total,
                                   wt, ldw, 0, j0, H, H3);
    }
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int r = 0; r < R; ++r) gc[a][r] = live ? loc[a][r] + res[r][0][a] : 0.0f;
    if (s + 1 < L) {
      if (kPrefetch) {
        cur = nxt;
      } else {
        load_step(reverse ? s + 1 : L - 2 - s, cur);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int k = j0 + unit[a];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = rowg + kStep * r;
      if (row < B && k < H) gh0[(size_t)row * H + k] = gc[a][r];
    }
  }
}

// dynamic shared memory of a (H, U, mode, route); the wrapper's plan computes
// the same (itrx_torch/ops/kernels/gru.py::plan)
int bwd_smem(int H, int U, bool bf16, bool streamed) {
  if (streamed) return kStages * U * (kKAlign + kPadF32) * 4;
  const int Kp = round_up(3 * H, kKAlign);
  return bf16 ? U * (Kp + kPadBf16) * 2 : U * (Kp + kPadF32) * 4;
}

template <typename W, int U, bool S>
cudaError_t launch(void** args, int blocks, int smem, cudaStream_t stream) {
  auto* kernel = gru_bwd_kernel<W, U, S>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, (size_t)smem,
                                     stream);
}

}  // namespace

extern "C" {

// gx, ghall (B, L, 3H); mask (B, L); hall (B, L, H); gout (B, L, H) or
// nullptr; gfinal (B, H) or nullptr, all fp32; wt = W_hh^T (H, ldw), ldw >=
// 3H, ldw % 4 == 0, zero past 3H, fp32 or bf16 (wt_bf16 != 0: the bf16
// mode).  ebuf the g_gh exchange, 2 x B x round_up(3H, 64) elements of wt's
// type; bar two zeroed-here words.  Writes ggx (B, L, 3H),
// ghn (B, L, H) and gh0 (B, H).  B <= 128.  The steps run in the opposite
// order of the forward (`reverse` is the forward's direction).  One
// cooperative launch of `blocks` blocks of `units` hidden units, `streamed`
// route, `smem` bytes of dynamic shared memory, on `stream` of CUDA device
// `device`.  Returns a cudaError_t (cudaErrorInvalidValue for a plan the
// kernel cannot take, cudaErrorCooperativeLaunchTooLarge for a grid that
// cannot be co-resident).
int itrx_gru_bwd(const void* gx, const void* mask, const void* hall, const void* ghall,
                 const void* gout, const void* gfinal, const void* wt, int ldw, int wt_bf16,
                 void* ebuf,
                 void* bar, void* ggx, void* ghn, void* gh0, int B, int L, int H, int units,
                 int blocks, int streamed, int smem, int reverse, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > kRows || L < 1 || H < 1 || blocks < 1 || (long long)blocks * units < H ||
      (units != 8 && units != 16) || (streamed && (wt_bf16 || units != 16)) || ldw < 3 * H ||
      ldw % 4 || smem < bwd_smem(H, units, wt_bf16, streamed)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  const float* p_gx = static_cast<const float*>(gx);
  const float* p_mask = static_cast<const float*>(mask);
  const float* p_hall = static_cast<const float*>(hall);
  const float* p_ghall = static_cast<const float*>(ghall);
  const float* p_gout = static_cast<const float*>(gout);
  const float* p_gfinal = static_cast<const float*>(gfinal);
  unsigned* p_bar = static_cast<unsigned*>(bar);
  float* p_ggx = static_cast<float*>(ggx);
  float* p_ghn = static_cast<float*>(ghn);
  float* p_gh0 = static_cast<float*>(gh0);
  // wt and ebuf of the mode's type (void pointers: one argument list)
  const void* p_wt = wt;
  void* p_e = ebuf;
  void* args[] = {&p_gx, &p_mask, &p_hall, &p_ghall, &p_gout, &p_gfinal, &p_wt, &ldw, &p_e,
                  &p_bar, &p_ggx, &p_ghn, &p_gh0, &B, &L, &H, &reverse};
  if (wt_bf16) {
    err = units == 8 ? launch<__nv_bfloat16, 8, false>(args, blocks, smem, s)
                     : launch<__nv_bfloat16, 16, false>(args, blocks, smem, s);
  } else if (streamed) {
    err = launch<float, 16, true>(args, blocks, smem, s);
  } else {
    err = units == 8 ? launch<float, 8, false>(args, blocks, smem, s)
                     : launch<float, 16, false>(args, blocks, smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
