// The FPN neck's level-0 chain in f32 for Hopper (sm_90a), NHWC:
//
//   a  = GELU(LN(f0 · W1 + b1))                 step1 lateral, C0 -> Cm
//   t  = a + u                                  u: nearest-x2 of the level-1 sum
//   z0 = GELU(LN(conv3x3(t) + b2))              step2, Cm -> Co, zero padding on t
//
// Replaces the Pallas TPU kernel adascale/ops/pallas/fpn_neck.py::
// fused_neck_l0 (pallas_call at :185, kernel body `_kernel` at :39). Same
// arithmetic: LayerNorm in f32 (eps 1e-6, biased variance), exact erf GELU.
//
// Border: the 3x3's zero padding applies to t, and step1 of a zero input is
// not zero (bias + LN + GELU). Here t is a real tensor and the 3x3's gather
// reads zero outside it, which is that rule exactly.
//
// What bounds it: per pixel 2*C0*Cm + 2*9*Cm*Co flops = 0.737 MFLOP at the
// flagship's C0 = 96, Cm = 384, Co = 96, 90 % of it in the 3x3. On the
// tensor cores at f32 accuracy each product is three TF32 products
// (conv_gemm.cuh), so the bound is 3 x flops at the H100 SXM's 495 TFLOP/s
// dense TF32 (700 W): 0.206 ms at 240x192, 0.238 ms at 256x208, against
// ~0.03 ms for its bytes (f0, u and z0 once). Bound by operations.
//
// Design: two launches of the implicit GEMM of conv_gemm.cuh (3xTF32 wgmma,
// B packed once per parameter set by the wrapper), where the TPU kernel
// made one pass over row bands and recomputed step1 for the halo rows:
//   * step1 (K = C0, one tap): a block owns 64 pixels and all kMid = 384
//     features; both warpgroups hold the same 64 rows, each half the
//     features (two 96-wide wgmma widths), so a stage's B is 384 x 32 (hi
//     and lo, 96 KB) in a two-stage ring. The tile plus b1 goes to shared
//     memory over the ring, then a quad per row: LN over the real Cm
//     features, GELU, + u (a row's u loads issued together), -> t in device
//     memory. Bound by its bytes more than its products: u read and t
//     written, 3 KB a pixel at the flagship.
//   * step2 (K = 9 Cm, the 3x3 as 9 taps at offsets -1..1): a block owns
//     128 pixels (a warpgroup each 64 rows) by all kNB = 96 features, one
//     96-wide wgmma, in a two-stage ring of 90 KB, so two blocks share an
//     SM (at most 128 registers a thread) and one's copies and barriers
//     overlap the other's products; the tile plus b2 to shared memory, LN
//     over the real Co features, GELU -> z0. Its A (9 shifted copies of t)
//     and B (all of W2, hi and lo, for every block) pass through L2, about
//     1.6 GB at 240x192.
// t costs 4*Cm bytes a pixel each way (70.8 MB at 240x192, ~0.04 ms of
// traffic against the 0.206 ms bound); the TPU kept it out of HBM where it
// was ~1.3 GB at batch 16. Tiles walk gridDim.x, which has no 65535 cap.

#include <cuda_runtime.h>

#include "conv_gemm.cuh"

namespace {

using namespace conv_gemm;

constexpr int kMid = 384;  // widest Cm: step1's features a block
constexpr int kNB = 96;    // widest Co: step2's features a block, one wgmma
constexpr int kBM1 = 64, kBM2 = 128;  // pixels a block
using R1 = Ring<kBM1, kMid, 2>;
using R2 = Ring<kBM2, kNB, 2>;
constexpr int kLdz1 = ldz(kMid), kLdz2 = ldz(kNB);
// The ring, then the bias, LN scale and LN bias, then the mbarriers.
constexpr size_t kSmem1 = (size_t)R1::BYTES + 3 * kMid * 4 + 16;
constexpr size_t kSmem2 = (size_t)R2::BYTES + 3 * kNB * 4 + 16;
static_assert(kBM1 * kLdz1 * 4 <= R1::BYTES && kBM2 * kLdz2 * 4 <= R2::BYTES, "epilogue tile");
static_assert(kSmem1 <= 232448 && 2 * (kSmem2 + 1024) <= 233472, "shared memory");

// f0 (B, H, W, C0); w1 (1 tap, ceil(C0/32) chunks, [hi, lo], kMid/8, 8, 8,
// 4) and vec1 (3, kMid): b1, LN scale, LN bias, zero past Cm; u and t (B, H,
// W, Cm).
__global__ void __launch_bounds__(kThreads, 1)
neck_step1_kernel(const float* __restrict__ f0, const float* __restrict__ w1,
                  const float* __restrict__ vec1, const float* __restrict__ u,
                  float* __restrict__ t, int npix, int H, int W, int C0, int Cm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM1;
  float* sv = reinterpret_cast<float*>(smem + R1::BYTES);
  for (int i = tid; i < 3 * kMid; i += kThreads) sv[i] = vec1[i];
  const uint32_t bars =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + R1::BYTES + 3 * kMid * 4;

  // Warpgroup wg: all 64 rows, features 192 wg .. 192 wg + 191.
  const int nb0 = (kMid / 2) * (tid / 128);
  float acc0[48], acc1[48];
  mainloop<kBM1, kMid, 2, 96, 96>(f0, w1, npix, H, W, C0, Taps{1, 1, 0, 0}, m0, smem, bars, 0,
                                  nb0, acc0, acc1);

  __syncthreads();  // both warpgroups are done with the ring
  float* z = reinterpret_cast<float*>(smem);
  const int t4 = tid % 4;
  store_pairs(acc0, z + quad_row() * kLdz1, kLdz1, nb0, t4, sv);
  store_pairs(acc1, z + quad_row() * kLdz1, kLdz1, nb0 + 96, t4, sv);
  __syncthreads();  // a row's features come from both warpgroups

  // Quad tid / 4 owns row tid / 4; thread t4 features 8 j + 2 t4, + 1,
  // twelve pairs at a time with their u loads issued first.
  const int r = tid / 4, m = m0 + r;
  const float* zr = z + r * kLdz1 + 2 * t4;
  float rstd;
  const float mean = ln_stats<kMid>(zr, Cm, t4, rstd);
  if (m >= npix) return;
  const float* ur = u + (long long)m * Cm + 2 * t4;
  float* tr = t + (long long)m * Cm + 2 * t4;
#pragma unroll 1
  for (int j0 = 0; j0 < kMid / 8; j0 += 12) {
    float2 uv[12];
#pragma unroll
    for (int j = 0; j < 12; ++j)  // Cm % 4 == 0: a pair is all in or all out
      if (8 * (j0 + j) + 2 * t4 < Cm) uv[j] = *reinterpret_cast<const float2*>(ur + 8 * (j0 + j));
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int n = 8 * (j0 + j) + 2 * t4;
      if (n < Cm) {
        const float y0 =
            gelu_exact((zr[8 * (j0 + j)] - mean) * rstd * sv[kMid + n] + sv[2 * kMid + n]);
        const float y1 = gelu_exact((zr[8 * (j0 + j) + 1] - mean) * rstd * sv[kMid + n + 1] +
                                    sv[2 * kMid + n + 1]);
        *reinterpret_cast<float2*>(tr + 8 * (j0 + j)) = make_float2(y0 + uv[j].x, y1 + uv[j].y);
      }
    }
  }
}

// t (B, H, W, Cm); w2 (9 taps, ceil(Cm/32) chunks, [hi, lo], kNB/8, 8, 8,
// 4) and vec2 (3, kNB): b2, LN scale, LN bias, zero past Co; out (B, H, W,
// Co).
__global__ void __launch_bounds__(kThreads, 2)
neck_step2_kernel(const float* __restrict__ t, const float* __restrict__ w2,
                  const float* __restrict__ vec2, float* __restrict__ out, int npix, int H,
                  int W, int Cm, int Co) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM2;
  float* sv = reinterpret_cast<float*>(smem + R2::BYTES);
  for (int i = tid; i < 3 * kNB; i += kThreads) sv[i] = vec2[i];
  const uint32_t bars =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + R2::BYTES + 3 * kNB * 4;

  // Warpgroup wg: rows 64 wg .. 64 wg + 63, all features. Tap t reads
  // source pixel (i - 1 + t / 3, j - 1 + t % 3).
  const int arow = 64 * (tid / 128);
  float acc[kNB / 2], none[1];
  mainloop<kBM2, kNB, 2, kNB, 0>(t, w2, npix, H, W, Cm, Taps{9, 3, -1, -1}, m0, smem, bars, arow,
                                 0, acc, none);

  __syncthreads();  // both warpgroups are done with the ring
  float* z = reinterpret_cast<float*>(smem);
  const int t4 = tid % 4, row0 = arow + quad_row();
  store_pairs(acc, z + row0 * kLdz2, kLdz2, 0, t4, sv);
  __syncwarp();  // a row's features come from the four threads of its quad
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + row0 + 8 * r;
    const float* zr = z + (row0 + 8 * r) * kLdz2 + 2 * t4;
    float rstd;
    const float mean = ln_stats<kNB>(zr, Co, t4, rstd);
    if (m >= npix) continue;
    float* orow = out + (long long)m * Co;
#pragma unroll
    for (int j = 0; j < kNB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * t4 + e;
        if (n < Co)
          orow[n] = gelu_exact((zr[8 * j + e] - mean) * rstd * sv[kNB + n] + sv[2 * kNB + n]);
      }
    }
  }
}

}  // namespace

extern "C" int fpn_neck_l0_max_mid() { return kMid; }
extern "C" int fpn_neck_l0_max_out() { return kNB; }

// f0 (B, H, W, C0), u and t (B, H, W, Cm), out (B, H, W, Co), all f32 and
// contiguous; C0 % 4 == 0, Cm % 4 == 0, Cm <= 384, Co <= 96. w1, vec1, w2
// and vec2 as the kernels above take them (kernels/fpn_neck.py::pack_neck).
// t is scratch. Returns cudaGetLastError() after the two launches (0 on
// success).
extern "C" int fpn_neck_l0_f32(const float* f0, const float* u, const float* w1,
                               const float* vec1, const float* w2, const float* vec2, float* t,
                               float* out, int B, int H, int W, int C0, int Cm, int Co,
                               cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C0 <= 0 || Cm <= 0 || Co <= 0 || C0 % 4 || Cm % 4 ||
      Cm > kMid || Co > kNB || H > 32767 || W > 32767)
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  if (npix > (1LL << 30)) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(neck_step1_kernel, kSmem1);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(neck_step2_kernel, kSmem2);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid1 = (unsigned)((npix + kBM1 - 1) / kBM1);
  neck_step1_kernel<<<grid1, kThreads, kSmem1, stream>>>(f0, w1, vec1, u, t, (int)npix, H, W, C0,
                                                         Cm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned grid2 = (unsigned)((npix + kBM2 - 1) / kBM2);
  neck_step2_kernel<<<grid2, kThreads, kSmem2, stream>>>(t, w2, vec2, out, (int)npix, H, W, Cm,
                                                         Co);
  return (int)cudaGetLastError();
}
