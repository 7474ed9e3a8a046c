// SCAN t2i stacked cross-attention score grid for sm_90a.
//
// Replaces itrx/ops/pallas/xattn.py::_kernel (raw_feature_norm =
// clipped_l2norm, agg_func LogSumExp or Mean).  For image i and caption c:
//   A[r, l]  = img_ir . cap_cl                      (formed here, fp32 accumulation)
//   h        = leaky_relu(A, 0.1) * mask_l
//   attn     = h / (sqrt(max(sum_l h^2, 1e-16)) + 1e-8)    per region, over the caption's words
//   s[:, l]  = softmax_r(lambda_softmax * attn[:, l])
//   num_l    = sum_r s[r, l] A[r, l]
//   ctx_l    = s[:, l]^T G_i s[:, l]                (|context|^2 by the Gram trick)
//   row_l    = num_l / max(sqrt(max(ctx_l, 1e-16)) * |cap_cl|, 1e-8)
//   score    = log(sum_l mask_l exp(lambda_lse row_l)) / lambda_lse,  or the masked mean
//
// What bounds it here: forming A is 2 * 36 * L * D flops per pair (about
// 1.8 Mflop at L = 24, D = 1024), the chain after it ~2 * 36^2 fp32 flops a
// (pair, word) for the Gram context; the A tensor itself (Ni x Nc x 36 x L)
// would be gigabytes and must never reach device memory.  At one block an SM
// the tiles' loads from L2 bound the product (each tile reads its caption
// group and its images over all of D).
// Design: xattn_wgmma.cuh's persistent tiles of up to 128 word rows of whole
// captions x K images (bf16: 6, wgmma m64n216k16; fp32: 4, exact fp64
// mma.sync products), TMA ring refilled by thread 0.  The chain starts on the
// accumulators (a thread holds rows g, g + 8 of its warp's 16 and a quarter
// of each 8-column group): the clipped l2norm's sum over a caption's words
// runs along the rows, by shuffles within the warp and one shared-memory
// exchange across warps (per 8-row group and column); the region softmax
// and the numerator of a (word, image) run along the columns, within a quad,
// on a copy of the image's five column groups (a loop over the images, not
// an unrolled epilogue: that was ~14k instructions, past the instruction
// cache, and ran the chain at half this speed).  Two images at a time, the
// softmax weights go to shared memory and one (word, image) a thread forms
// ctx = s^T G s, every lane of a warp reading the same row of G (a quad
// gathering its weights by shuffles read G 4 rows an instruction and took
// 1.6x as long); the words' terms are summed over each caption at the end.
// fp32 throughout after A, in fixed orders: repeats are bit-identical.  The
// per-image Gram (36 x 36), the word norms and the masked captions come from
// the wrapper, as in the TPU wrapper; the tile's Grams, norms and mask are
// staged by cp.async while its product runs.
#include "xattn_wgmma.cuh"

namespace {

using namespace itrx_xwg;

// the epilogue's shared memory after the ring, in floats
template <typename T>
struct Epi {
  static constexpr int K = Mode<T>::K, N = kN<T>;
  static constexpr int kS = 0;                      // [2][128 words][36] softmax weights
  static constexpr int kPart = kS;                  // [16 row groups][N] sums of h^2, before
  static constexpr int kInv = kS + 2 * kRows * kR;  // [cpb][N] inverse l2norm denominators
  static constexpr int kGram = kInv + 16 * N;       // [K][36 * 36] the images' Grams
  static constexpr int kMask = kGram + K * kR * kR; // [128] the group's word mask
  static constexpr int kCapn = kMask + kRows;       // [128] the group's word norms
  static constexpr int kNum = kCapn + kRows;        // [2][128] numerators
  static constexpr int kTerm = kNum + 2 * kRows;    // [K][128] the words' aggregation terms
  static constexpr int kFloats = kTerm + K * kRows;
  static_assert(16 * N <= 2 * kRows * kR, "the h^2 sums fit under the softmax weights");
};

// sum over the 8 lanes of a warp that share lane % 4 (the rows g = 0..7)
__device__ __forceinline__ float sum_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
// over the quad (the four threads of a row)
__device__ __forceinline__ float sum_quad(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float max_quad(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// One image's region softmax for this thread's two words (rows h = 0, 1),
// on its block of the accumulators (take_block; parity Odd): the softmax
// weights s to s_img [word][region], the numerator sum_r s A to num_img
// [word] (quad lane 0).
template <int Odd>
__device__ __forceinline__ void softmax_words(const float (&blk)[5][4], int t, const int (&row)[2],
                                              const bool (&valid)[2], const int (&cc)[2],
                                              const float (&m)[2], const float* inv, int N,
                                              float lambda_softmax, int p, float* s_img,
                                              float* num_img) {
  constexpr int kSpan = 5;
  const int col0 = 36 * p - 4 * Odd;  // the block's first column
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float z[kSpan][2];
    float mx = -3.0e38f;  // every logit is finite
#pragma unroll
    for (int il = 0; il < kSpan; ++il) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * il + 2 * t + e;
        const float iv = valid[h] && in_image<Odd>(il, e, t) ? inv[cc[h] * N + col] : 0.0f;
        z[il][e] = leaky(blk[il][2 * h + e]) * m[h] * iv * lambda_softmax;
        if (in_image<Odd>(il, e, t)) mx = fmaxf(mx, z[il][e]);
      }
    }
    mx = max_quad(mx);
    float sum = 0.0f;
#pragma unroll
    for (int il = 0; il < kSpan; ++il) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        z[il][e] = in_image<Odd>(il, e, t) ? expf(z[il][e] - mx) : 0.0f;
        sum += z[il][e];
      }
    }
    const float inv_sum = 1.0f / sum_quad(sum);
    float num = 0.0f;
#pragma unroll
    for (int il = 0; il < kSpan; ++il) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (in_image<Odd>(il, e, t)) {
          const float s = z[il][e] * inv_sum;
          num = fmaf(s, blk[il][2 * h + e], num);
          s_img[row[h] * kR + 8 * il + 2 * t + e - 4 * Odd] = s;
        }
      }
    }
    num = sum_quad(num);
    if (t == 0) num_img[row[h]] = num;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
xattn_t2i_kernel(const __grid_constant__ CUtensorMap cap_map,
                 const __grid_constant__ CUtensorMap img_map, const Plan pl,
                 const float* __restrict__ capn,   // (Nc, L) word norms
                 const float* __restrict__ mask,   // (Nc, L)
                 const float* __restrict__ gram,   // (Ni, 36, 36)
                 float* __restrict__ out,          // (Ni, Nc)
                 float lambda_lse, float lambda_softmax, int agg_mean) {
  using E = Epi<T>;
  constexpr int K = Mode<T>::K, N = kN<T>, NG = kNG<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Bars bars;
  float* ep;
  Ring rg = setup<T>(smem, pl, bars, &cap_map, &img_map, &ep);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg0 = 2 * (threadIdx.x / 32);  // this warp's first 8-row group
  const int L = pl.L, g8 = L / 8;
  float* const part = ep + E::kPart;
  float* const inv = ep + E::kInv;
  const float* const gram_s = ep + E::kGram;
  const float* const mask_s = ep + E::kMask;
  const float* const capn_s = ep + E::kCapn;

  for (int item = blockIdx.x; item < pl.n_items; item += gridDim.x) {
    int ig, cg;
    tile_origin(item, pl, &ig, &cg);
    const int i0 = ig * K, c0 = cg * pl.cpb, ncols = pl.cpb * L;
    stage_floats(ep + E::kGram, gram + (size_t)i0 * kR * kR, K * kR * kR, (pl.Ni - i0) * kR * kR);
    stage_floats(ep + E::kMask, mask + (size_t)c0 * L, ncols, (pl.Nc - c0) * L);
    stage_floats(ep + E::kCapn, capn + (size_t)c0 * L, ncols, (pl.Nc - c0) * L);
    staged_commit();

    float d[NG][4];
    product<T>(d, pl, rg);
    staged_wait();
    tile_sync();
#ifdef ITRX_XATTN_PRODUCT_ONLY
    // phase timer build: the product alone, every accumulator kept live
    {
      float keep = 0.0f;
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) keep += d[i][q];
      if (keep == 1.0f) out[(size_t)i0 * pl.Nc + c0] = keep;
    }
    tile_sync();
    continue;
#endif

    int row[2], cc[2];
    bool valid[2];
    float m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = 8 * (rg0 + h) + g;
      cc[h] = row[h] / L;
      valid[h] = row[h] < ncols && c0 + cc[h] < pl.Nc;
      m[h] = valid[h] ? mask_s[row[h]] : 0.0f;
    }

    // the clipped l2norm: sums of h^2 per (8-row group, column), then per
    // (caption, column) over the caption's groups
#pragma unroll
    for (int i = 0; i < NG; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float hv = leaky(d[i][q]) * m[q >> 1];
        const float s = sum_rows(hv * hv);
        if (g == 0) part[(rg0 + (q >> 1)) * N + 8 * i + 2 * t + (q & 1)] = s;
      }
    }
    tile_sync();
    for (int idx = threadIdx.x; idx < pl.cpb * N; idx += kThreads) {
      const int c = idx / N, col = idx % N;
      float ss = 0.0f;
      for (int j = 0; j < g8; ++j) ss += part[(c * g8 + j) * N + col];
      inv[idx] = 1.0f / (sqrtf(fmaxf(ss, 1e-16f)) + kEps);
    }
    tile_sync();

    // two images at a time: the region softmax on the accumulators (the
    // weights and numerators to shared memory), then one (word, image) a
    // thread: ctx = s^T G s with G's rows read by the whole warp at once
    // (one image a warp), and the word's term of the aggregation
    float* const s_s = ep + E::kS;
    float* const num_s = ep + E::kNum;
    float* const term_s = ep + E::kTerm;
#pragma unroll 1
    for (int p0 = 0; p0 < K; p0 += 2) {
      float blk[5][4];
      image_block(d, p0, blk);
      softmax_words<0>(blk, t, row, valid, cc, m, inv, N, lambda_softmax, p0, s_s, num_s);
      image_block(d, p0 + 1, blk);
      softmax_words<1>(blk, t, row, valid, cc, m, inv, N, lambda_softmax, p0 + 1,
                       s_s + kRows * kR, num_s + kRows);
      tile_sync();
      {
        const int w = threadIdx.x % kRows, q = threadIdx.x / kRows;  // word, image of the pair
        const float* sw = s_s + (q * kRows + w) * kR;
        float sv[kR];
#pragma unroll
        for (int k4 = 0; k4 < kR / 4; ++k4) {
          const float4 v = reinterpret_cast<const float4*>(sw)[k4];
          sv[4 * k4] = v.x;
          sv[4 * k4 + 1] = v.y;
          sv[4 * k4 + 2] = v.z;
          sv[4 * k4 + 3] = v.w;
        }
        const float4* g4 = reinterpret_cast<const float4*>(gram_s + (p0 + q) * kR * kR);
        float ctx = 0.0f;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int k4 = 0; k4 < kR / 4; ++k4) {
            const float4 gq = g4[r * (kR / 4) + k4];
            y[0] = fmaf(gq.x, sv[4 * k4], y[0]);
            y[1] = fmaf(gq.y, sv[4 * k4 + 1], y[1]);
            y[2] = fmaf(gq.z, sv[4 * k4 + 2], y[2]);
            y[3] = fmaf(gq.w, sv[4 * k4 + 3], y[3]);
          }
          ctx = fmaf(sv[r], (y[0] + y[1]) + (y[2] + y[3]), ctx);
        }
        const bool ok = w < ncols && c0 + w / L < pl.Nc;
        float term = 0.0f;
        if (ok) {
          const float mw = mask_s[w];
          const float rs = num_s[q * kRows + w] / fmaxf(sqrtf(fmaxf(ctx, 1e-16f)) * capn_s[w], kEps);
          term = agg_mean ? rs * mw : expf(rs * lambda_lse) * mw;
        }
        term_s[(p0 + q) * kRows + w] = term;
      }
      tile_sync();
    }

    // aggregate each (image, caption) over its words
#ifdef ITRX_XATTN_NO_AGG
    // phase timer build: no aggregation, the chain's first word kept live
    if (threadIdx.x < K && c0 < pl.Nc && i0 + (int)threadIdx.x < pl.Ni) {
      out[(size_t)(i0 + threadIdx.x) * pl.Nc + c0] = term_s[threadIdx.x * kRows];
    }
#else
    if (threadIdx.x < pl.cpb * K) {
      const int c = threadIdx.x / K, p = threadIdx.x % K;
      if (c0 + c < pl.Nc && i0 + p < pl.Ni) {
        float acc = 0.0f, cnt = 0.0f;
        for (int l = 0; l < L; ++l) {
          acc += term_s[p * kRows + c * L + l];
          cnt += mask_s[c * L + l];
        }
        out[(size_t)(i0 + p) * pl.Nc + c0 + c] =
            agg_mean ? acc / fmaxf(cnt, 1.0f) : logf(acc) / lambda_lse;
      }
    }
#endif
    tile_sync();
  }
}

template <typename T>
int run(const void* img, const void* cap, const void* capn, const void* mask, const void* gram,
        void* out, int Ni, int Nc, int L, int D, float lambda_lse, float lambda_softmax,
        int agg_mean, int device, cudaStream_t stream) {
  return launch<T>(xattn_t2i_kernel<T>, [](const Plan&) { return Epi<T>::kFloats * 4; }, img, cap, Ni, Nc, L,
                   D, device, stream, static_cast<const float*>(capn),
                   static_cast<const float*>(mask), static_cast<const float*>(gram),
                   static_cast<float*>(out), lambda_lse, lambda_softmax, agg_mean);
}

}  // namespace

extern "C" {

// bf16 != 0: img (Ni, 36, D) and cap (Nc, L, D) bf16; else both fp64 copies
// of the fp32 embeddings.  Rows 16-byte strided and aligned, captions zero
// at padded words, L a multiple of 8 in [8, 128]; capn, mask (Nc, L) fp32; gram (Ni, 36, 36) fp32;
// out (Ni, Nc) fp32.  One launch on `stream` of CUDA device `device`;
// returns a CUDA error code (cudaGetLastError() after the launch).
int itrx_xattn_t2i(const void* img, const void* cap, const void* capn, const void* mask,
                   const void* gram, void* out, int Ni, int Nc, int L, int D, int bf16,
                   float lambda_lse, float lambda_softmax, int agg_mean, int device,
                   void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return run<__nv_bfloat16>(img, cap, capn, mask, gram, out, Ni, Nc, L, D, lambda_lse,
                              lambda_softmax, agg_mean, device, s);
  }
  return run<float>(img, cap, capn, mask, gram, out, Ni, Nc, L, D, lambda_lse, lambda_softmax,
                    agg_mean, device, s);
}

const char* itrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
