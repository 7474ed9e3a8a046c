// Masked GRU recurrence, forward, for sm_90a: one persistent cooperative
// launch per call (per batch chunk of at most 128 rows).
//
// Replaces itrx/ops/pallas/gru.py::_fwd_kernel.  Semantics: torch.nn.GRU gate
// order [r|z|n]; the mask freezes the carry past each sequence's length;
// outputs are zero at padded steps; `reverse` runs right to left
// (packed-bidirectional semantics).  The carry is fp32; with bf16 W_hh the
// carry is rounded to bf16 before the product, which accumulates in fp32, as
// the TPU kernel's bf16 dot does.
//
// What bounds it here: L sequential steps, each a (B, H) x (H, 3H) product
// plus gate math.  The TPU kernel keeps W_hh^T resident in VMEM for all L grid
// steps; one SM's 227 KB cannot hold it (6.3 MB bf16, 12.6 MB fp32 at H
// 1024), but the card's 132 SMs together can.  Design: one block per SM
// (cooperative launch, so all blocks are resident and a grid that cannot be
// co-resident fails the launch), each owning `U` hidden units j and holding
// rows j, H + j, 2H + j of W_hh in shared memory for the whole sequence.  A
// step: every block reads the whole previous carry operand (B x H: bf16 in
// bf16 mode, fp32 in fp32 mode) from a double-buffered exchange in global
// memory, computes its (B, 3U) slice of h . W_hh^T, applies the gate math to
// its own units (their fp32 carry stays in registers), publishes its units'
// new carry and meets the other blocks at one grid barrier
// (csrc/gru_persistent.cuh).  Per step the product is small (at B 128, H
// 1024: 6.3 MFLOP a block); the pace is set by the carry each block re-reads
// at L2 (256 KB bf16, 512 KB fp32 a block a step) and by the barrier.
//
// The product: bf16 on tensor cores (mma.sync m16n8k16, fp32 accumulate;
// warp w takes batch rows 16 w .. 16 w + 15, the k order inside each 32
// columns permuted so that a lane's A and B fragments are one 16-byte load
// each); fp32 as register-tiled fp32 FMAs (no TF32: the lanes of a row group
// split k and add their partials in a fixed order).  fp32 slices too large to
// stay resident (H > 1152 at 16 units a block: VSRN's H 2048 training GRUs)
// take the streamed route, a compile-time variant chosen by the wrapper's
// plan (itrx_torch/ops/kernels/gru.py::plan): the slice passes through a
// 4-stage cp.async ring every step, the next step's first chunks loading
// during the epilogue and the barrier.
//
// Residuals for the backward (csrc/gru_bwd.cu), written only when the caller
// passes the buffers (training): hall[b, t] = h_{t-1}, the fp32 carry
// entering step t, and ghall[b, t] = h_{t-1} . W_hh^T + b_hh, as the TPU
// kernel saves them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "gru_persistent.cuh"

namespace {

using namespace gru;

// W: weight and exchange type (bf16: tensor cores; fp32: FMAs).  U: hidden
// units a block.  STREAM: the fp32 slice streams through the ring.  A thread
// owns R rows (rowg + (16 / R) i) times U / (2 R) units (unit[a]): U / 2
// (row, unit) pairs, whose fp32 carry it keeps in registers.  bf16: R = 2 and
// the units of its mma accumulator fragment; fp32: R = 4 at 8 units (96
// accumulators), 2 at 16, and the units reduce_lanes leaves it.
template <typename W, int U, bool STREAM>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_kernel(const float* __restrict__ gx,    // (B, L, 3H) input gates
               const float* __restrict__ mask,  // (B, L)
               const W* __restrict__ whh,       // (3H, ldw)
               int ldw,
               const float* __restrict__ bhh,   // (3H)
               W* xbuf,                         // (2, B, Kp) carry exchange
               unsigned* bar,                   // grid barrier, zeroed
               float* __restrict__ out,         // (B, L, H)
               float* __restrict__ fin,         // (B, H)
               float* __restrict__ hall,        // (B, L, H) or nullptr
               float* __restrict__ ghall,       // (B, L, 3H) or nullptr
               int B, int L, int H, int reverse) {
  constexpr bool kMMA = std::is_same<W, __nv_bfloat16>::value;
  static_assert(!(kMMA && STREAM), "the bf16 slice always fits (plan)");
  static_assert(U % 8 == 0, "units come in mma column tiles of 8");
  constexpr int R = (kMMA || U == 16) ? 2 : 4;
  constexpr int S = 2 * R;  // lanes that split K for one row group
  constexpr int A = U / S;  // units a lane
  constexpr int kStep = 16 / R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* ws = reinterpret_cast<W*>(smem_raw);
  const int Kp = round_up(H, kKAlign);
  const int per_product = Kp / kKAlign;
  const int ld = STREAM ? kKAlign + kPadF32 : Kp + (kMMA ? kPadBf16 : kPadF32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane / S, c = lane % S;
  const int rowg = 16 * warp + rg;
  const bool live = 16 * warp < B;
  const int j0 = blockIdx.x * U;
  const int H3 = 3 * H;
  const int total = STREAM ? (L - 1) * per_product : 0;
  int chunk = 0;

  if constexpr (STREAM) {
    for (int i = 0; i < kStages - 1; ++i) {
      ring_issue<3 * U, U>(reinterpret_cast<float*>(ws), i, total, per_product,
                           reinterpret_cast<const float*>(whh), ldw, H, j0, H, H);
    }
  } else {
    load_resident<W, 3 * U, U>(ws, ld, whh, ldw, H, j0, H, H, Kp);
  }
  if (blockIdx.x == 0 && Kp > H) {  // the exchange's pad columns stay zero
    const int pad = Kp - H;
    for (int idx = threadIdx.x; idx < 2 * B * pad; idx += kThreads) {
      const int row = idx / pad;
      xbuf[(size_t)row * Kp + H + (idx - row * pad)] = zero_of<W>();
    }
  }

  int unit[A];
  float h[A][R], bh[3][A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    unit[a] = kMMA ? 8 * (a >> 1) + 2 * c + (a & 1) : S * a + c;
    const int j = j0 + unit[a];
#pragma unroll
    for (int q = 0; q < 3; ++q) bh[q][a] = j < H ? bhh[q * H + j] : 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) h[a][r] = 0.0f;
  }

  // a step's input gates and mask for the thread's pairs, loaded a step ahead
  auto load_step = [&](int t, float (&gxv)[3][A][R], float (&mv)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = rowg + kStep * r;
      mv[r] = row < B ? mask[(size_t)row * L + t] : 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int j = j0 + unit[a];
        const bool ok = row < B && j < H;
        const size_t base = ((size_t)row * L + t) * H3 + j;
#pragma unroll
        for (int q = 0; q < 3; ++q) gxv[q][a][r] = ok ? gx[base + q * H] : 0.0f;
      }
    }
  };

  // a step's input gates load a step ahead, during the barrier and the
  // product, where the registers allow (the fp32 product at 16 units needs
  // them: there they load after the product)
  constexpr bool kPrefetch = kMMA || U == 8;
  float gxc[3][A][R], mc[R];
  if (kPrefetch) load_step(reverse ? L - 1 : 0, gxc, mc);

  for (int s = 0; s < L; ++s) {
    const int t = reverse ? L - 1 - s : s;
    float gh[3][A][R];  // h_{t-1} . W_hh^T of the thread's pairs, without b_hh
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int r = 0; r < R; ++r) gh[q][a][r] = 0.0f;
    if (s > 0) {  // step 0 starts from the zero carry
      const W* X = xbuf + (size_t)((s - 1) & 1) * B * Kp;
      if constexpr (kMMA) {
        if (live) {
          float d[3 * U / 8][4];
          product_bf16<3 * U / 8>(d, X, Kp, rowg, B, ws, ld, Kp, rg, c);
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int a = 0; a < A; ++a)
#pragma unroll
              for (int r = 0; r < R; ++r) gh[q][a][r] = d[q * (U / 8) + (a >> 1)][2 * r + (a & 1)];
        }
      } else {
        float res[R][3][A];
        product_f32<R, 3, U, STREAM>(res, X, Kp, rowg, B, live, ws, ld, Kp, c, chunk,
                                             total, whh, ldw, H, j0, H, H);
        if (live) {
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int a = 0; a < A; ++a)
#pragma unroll
              for (int r = 0; r < R; ++r) gh[q][a][r] = res[r][q][a];
        }
      }
    }
    float gxn[3][A][R], mn[R];
    if (!kPrefetch) load_step(t, gxc, mc);
    if (kPrefetch && s + 1 < L) load_step(reverse ? L - 2 - s : s + 1, gxn, mn);

    W* Xn = xbuf + (size_t)(s & 1) * B * Kp;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int j = j0 + unit[a];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = rowg + kStep * r;
        if (row >= B || j >= H) continue;
        const float hp = h[a][r];
        const float ghr = gh[0][a][r] + bh[0][a];
        const float ghz = gh[1][a][r] + bh[1][a];
        const float ghn = gh[2][a][r] + bh[2][a];
        const size_t bt = (size_t)row * L + t;
        if (hall != nullptr) {
          hall[bt * H + j] = hp;
          ghall[bt * H3 + j] = ghr;
          ghall[bt * H3 + H + j] = ghz;
          ghall[bt * H3 + 2 * H + j] = ghn;
        }
        const float gate_r = sigmoidf_(gxc[0][a][r] + ghr);
        const float gate_z = sigmoidf_(gxc[1][a][r] + ghz);
        const float gate_n = tanhf(gxc[2][a][r] + gate_r * ghn);
        const float hn = (1.0f - gate_z) * gate_n + gate_z * hp;
        const float m = mc[r];
        out[bt * H + j] = m * hn;
        const float hnew = m * hn + (1.0f - m) * hp;
        h[a][r] = hnew;
        Xn[(size_t)row * Kp + j] = to_w<W>(hnew);
      }
    }
    if (s + 1 < L) {
      if (kPrefetch) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          mc[r] = mn[r];
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int a = 0; a < A; ++a) gxc[q][a][r] = gxn[q][a][r];
        }
      }
      grid_sync(bar);
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int j = j0 + unit[a];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = rowg + kStep * r;
      if (row < B && j < H) fin[(size_t)row * H + j] = h[a][r];
    }
  }
}

// dynamic shared memory of a (H, U, mode, route); the wrapper's plan computes
// the same (itrx_torch/ops/kernels/gru.py::plan)
int fwd_smem(int H, int U, bool bf16, bool streamed) {
  if (streamed) return kStages * 3 * U * (kKAlign + kPadF32) * 4;
  const int Kp = round_up(H, kKAlign);
  return bf16 ? 3 * U * (Kp + kPadBf16) * 2 : 3 * U * (Kp + kPadF32) * 4;
}

template <typename W, int U, bool S>
cudaError_t launch(void** args, int blocks, int smem, cudaStream_t stream) {
  auto* kernel = gru_fwd_kernel<W, U, S>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, (size_t)smem,
                                     stream);
}

}  // namespace

extern "C" {

// gx (B, L, 3H) fp32; mask (B, L) fp32; whh (3H, ldw) fp32 or bf16
// (whh_bf16 != 0); bhh (3H) fp32; xbuf the carry exchange, 2 x B x
// round_up(H, 64) elements of W_hh's type; bar two zeroed-here words; out
// (B, L, H), fin (B, H); hall (B, L, H) and ghall (B, L, 3H), both nullptr or
// both set.  B <= 128.  One cooperative launch of `blocks` blocks of `units`
// hidden units, `streamed` route, `smem` bytes of dynamic shared memory, on
// `stream` of CUDA device `device`.  Returns a cudaError_t:
// cudaErrorInvalidValue for a plan the kernel cannot take,
// cudaErrorCooperativeLaunchTooLarge for a grid that cannot be co-resident.
int itrx_gru_fwd(const void* gx, const void* mask, const void* whh, int ldw, int whh_bf16,
                 const void* bhh, void* xbuf, void* bar, void* out, void* fin, void* hall,
                 void* ghall, int B, int L, int H, int units, int blocks, int streamed, int smem,
                 int reverse, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > kRows || L < 1 || H < 1 || blocks < 1 || (long long)blocks * units < H ||
      (units != 8 && units != 16) || (streamed && (whh_bf16 || units != 16 || ldw % 4)) ||
      ldw < H || smem < fwd_smem(H, units, whh_bf16, streamed)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  const float* p_gx = static_cast<const float*>(gx);
  const float* p_mask = static_cast<const float*>(mask);
  const float* p_bhh = static_cast<const float*>(bhh);
  unsigned* p_bar = static_cast<unsigned*>(bar);
  float* p_out = static_cast<float*>(out);
  float* p_fin = static_cast<float*>(fin);
  float* p_hall = static_cast<float*>(hall);
  float* p_ghall = static_cast<float*>(ghall);
  if (whh_bf16) {
    const __nv_bfloat16* p_w = static_cast<const __nv_bfloat16*>(whh);
    __nv_bfloat16* p_x = static_cast<__nv_bfloat16*>(xbuf);
    void* args[] = {&p_gx, &p_mask, &p_w, &ldw, &p_bhh, &p_x, &p_bar, &p_out, &p_fin,
                    &p_hall, &p_ghall, &B, &L, &H, &reverse};
    err = units == 8 ? launch<__nv_bfloat16, 8, false>(args, blocks, smem, s)
                     : launch<__nv_bfloat16, 16, false>(args, blocks, smem, s);
  } else {
    const float* p_w = static_cast<const float*>(whh);
    float* p_x = static_cast<float*>(xbuf);
    void* args[] = {&p_gx, &p_mask, &p_w, &ldw, &p_bhh, &p_x, &p_bar, &p_out, &p_fin,
                    &p_hall, &p_ghall, &B, &L, &H, &reverse};
    if (streamed) {
      err = launch<float, 16, true>(args, blocks, smem, s);
    } else {
      err = units == 8 ? launch<float, 8, false>(args, blocks, smem, s)
                       : launch<float, 16, false>(args, blocks, smem, s);
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
