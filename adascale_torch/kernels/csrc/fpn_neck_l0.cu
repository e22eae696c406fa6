// The FPN neck's level-0 chain in f32 for Hopper (sm_90a), NHWC:
//
//   a  = GELU(LN(f0 · W1 + b1))                 step1 lateral, C0 -> Cm
//   t  = a + u                                  u: nearest-x2 of the level-1 sum
//   z0 = GELU(LN(conv3x3(t) + b2))              step2, Cm -> Co, zero padding on t
//
// Replaces the Pallas TPU kernel adascale/ops/pallas/fpn_neck.py::
// fused_neck_l0 (pallas_call at :185, kernel body `_kernel` at :38). Same
// arithmetic: LayerNorm in f32 (eps 1e-6, biased variance), exact erf GELU.
//
// Border: the 3x3's zero padding applies to t, and step1 of a zero input is
// not zero (bias + LN + GELU). Here t is a real tensor and the 3x3's gather
// reads zero outside it, which is that rule exactly.
//
// What bounds it: per pixel 2*C0*Cm + 2*9*Cm*Co flops = 0.737 MFLOP at the
// flagship's C0 = 96, Cm = 384, Co = 96; at 240x192 that is 34 GFLOP, 0.51 ms
// at the H100 SXM's 67 TFLOP/s f32 peak (700 W), against ~0.04 ms for its
// bytes. Bound by operations.
//
// Design: two launches of the tiled implicit GEMM in conv_gemm.cuh, where
// the TPU kernel made one pass over row bands and recomputed step1 for the
// halo rows. (i) step1 GEMM (K = C0, all Cm features of a pixel in one block)
// + LN + GELU + u -> t in device memory; (ii) the 3x3 over t (K = 9*Cm) + LN
// + GELU -> z0. t costs 4*Cm bytes a pixel (70.8 MB at 240x192, ~0.04 ms of
// traffic against the 0.51 ms bound); the TPU kept it out of HBM where it
// was ~1.3 GB at batch 16.

#include <cuda_runtime.h>

#include "conv_gemm.cuh"

namespace {

using namespace conv_gemm;

constexpr int kTM1 = 4, kTN1 = 24;  // step1: 64 pixels x 384 features
constexpr int kTM2 = 8, kTN2 = 6;   // step2: 128 pixels x 96 features
using Tile1 = Tile<kTM1, kTN1>;
using Tile2 = Tile<kTM2, kTN2>;

__global__ void __launch_bounds__(kThreads, 1)
step1_kernel(const float* __restrict__ f0, const float* __restrict__ w1,
             const float* __restrict__ b1, const float* __restrict__ g1,
             const float* __restrict__ e1, const float* __restrict__ u, float* __restrict__ t,
             long long npix, int H, int W, int C0, int Cm) {
  extern __shared__ float4 smem4[];
  float acc[kTM1][kTN1];
  const long long m0 = (long long)blockIdx.x * Tile1::BM;
  mainloop<kTM1, kTN1>(f0, w1, npix, H, W, C0, Taps{1, 1, 0, 0}, m0,
                       reinterpret_cast<float*>(smem4), acc);
  bias_ln_gelu<kTM1, kTN1>(acc, b1, g1, e1, Cm);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kTM1; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= npix) continue;
#pragma unroll
    for (int j = 0; j < kTN1; ++j) {
      const int n = tx + 16 * j;
      if (n < Cm) t[m * Cm + n] = acc[i][j] + u[m * Cm + n];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
step2_kernel(const float* __restrict__ t, const float* __restrict__ w2,
             const float* __restrict__ b2, const float* __restrict__ g2,
             const float* __restrict__ e2, float* __restrict__ out, long long npix, int H,
             int W, int Cm, int Co) {
  extern __shared__ float4 smem4[];
  float acc[kTM2][kTN2];
  const long long m0 = (long long)blockIdx.x * Tile2::BM;
  mainloop<kTM2, kTN2>(t, w2, npix, H, W, Cm, Taps{9, 3, -1, -1}, m0,
                       reinterpret_cast<float*>(smem4), acc);
  bias_ln_gelu<kTM2, kTN2>(acc, b2, g2, e2, Co);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kTM2; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= npix) continue;
#pragma unroll
    for (int j = 0; j < kTN2; ++j) {
      const int n = tx + 16 * j;
      if (n < Co) out[m * Co + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int fpn_neck_l0_max_mid() { return Tile1::BN; }
extern "C" int fpn_neck_l0_max_out() { return Tile2::BN; }

// f0 (B, H, W, C0), u and t (B, H, W, Cm), out (B, H, W, Co), all f32 and
// contiguous; C0 % 4 == 0, Cm % 4 == 0, Cm <= 384, Co <= 96. w1 is (C0, 384)
// and w2 (9, Cm, 96), both zero past the real width; the vectors have Cm
// (b1, g1, e1) and Co (b2, g2, e2) entries. t is scratch. Returns
// cudaGetLastError() after the two launches (0 on success).
extern "C" int fpn_neck_l0_f32(const float* f0, const float* u, const float* w1,
                               const float* b1, const float* g1, const float* e1,
                               const float* w2, const float* b2, const float* g2,
                               const float* e2, float* t, float* out, int B, int H, int W,
                               int C0, int Cm, int Co, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C0 <= 0 || Cm <= 0 || Co <= 0 || C0 % 4 || Cm % 4 ||
      Cm > Tile1::BN || Co > Tile2::BN)
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  cudaError_t e = allow_smem(step1_kernel, Tile1::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(step2_kernel, Tile2::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid1 = (unsigned)((npix + Tile1::BM - 1) / Tile1::BM);
  step1_kernel<<<grid1, kThreads, Tile1::SMEM_BYTES, stream>>>(f0, w1, b1, g1, e1, u, t, npix,
                                                               H, W, C0, Cm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned grid2 = (unsigned)((npix + Tile2::BM - 1) / Tile2::BM);
  step2_kernel<<<grid2, kThreads, Tile2::SMEM_BYTES, stream>>>(t, w2, b2, g2, e2, out, npix, H,
                                                               W, Cm, Co);
  return (int)cudaGetLastError();
}
