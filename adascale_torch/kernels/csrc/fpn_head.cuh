// FpnHead chains over one shared neck output, for fpn_heads.cu (the two
// rough heads) and precise_heads.cu (the four precise heads):
//
//   y_h = Linear_h(GELU(LN_h(conv3x3_h(nearest_x2(x)) + sb_h)))
//
// The nearest-x2 upsample followed by the 3x3 is computed as four phases at
// the low resolution: output pixel (2i+a, 2j+b) is a 2x2 convolution whose
// tap (dy, dx) multiplies source pixel (i+a-1+dy, j+b-1+dx) with the 3x3's
// taps collapsed along each axis (parity 0: [k0, k1+k2], parity 1:
// [k0+k1, k2]). Zero padding outside the low-resolution map is exact,
// because nearest-x2 of a zero border is a zero border. The wrappers pack
// the collapsed taps; the kernel sees a 4-tap implicit GEMM per phase, 4/9
// of the work of the 3x3 at the high resolution.
//
// One block computes one head at one phase for BM low-resolution pixels: all
// of the head's inner features (F <= BN), so the head's own LayerNorm is a
// reduction inside the block, then the projection to the head's M <= 4
// channels. Blocks of one pixel tile (all heads and phases) are launched
// next to each other so that the tile's input is read from L2. The kernel
// writes the interleaved (B, 2H, 2W, Mtot) map directly, each head at its
// own channel offset.

#pragma once

#include <cuda_runtime.h>

#include "conv_gemm.cuh"

namespace fpn_head {

using namespace conv_gemm;

constexpr int kMaxHeads = 4;
constexpr int kMaxOut = 4;

struct HeadSizes {
  int F[kMaxHeads];
  int M[kMaxHeads];
  int moff[kMaxHeads];
};

// x (B, H, W, C); w (heads, 4 phases, 4 taps, C, BN); vec (heads, 3, BN):
// smoothing bias, LN scale, LN bias; w2 (heads, kMaxOut, BN) and b2 (heads,
// kMaxOut), zero past each head's real sizes; out (B, 2H, 2W, Mtot).
template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, 1)
heads_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ vec, const float* __restrict__ w2,
             const float* __restrict__ b2, float* __restrict__ out, HeadSizes sizes,
             long long npix, int H, int W, int C, int Mtot) {
  using T = Tile<TM, TN>;
  constexpr int BN = T::BN;
  extern __shared__ float4 smem4[];
  const int head = blockIdx.x / 4, phase = blockIdx.x % 4;
  const int pa = phase / 2, pb = phase % 2;
  const long long m0 = (long long)blockIdx.y * T::BM;
  float acc[TM][TN];
  mainloop<TM, TN>(x, w + (long long)(head * 4 + phase) * 4 * C * BN, npix, H, W, C,
                   Taps{4, 2, pa - 1, pb - 1}, m0, reinterpret_cast<float*>(smem4), acc);
  // Select this block's sizes without indexing the parameter struct by a
  // run-time value (which would copy it to local memory).
  int F = sizes.F[0], M = sizes.M[0], moff = sizes.moff[0];
#pragma unroll
  for (int h = 1; h < kMaxHeads; ++h) {
    if (head == h) {
      F = sizes.F[h];
      M = sizes.M[h];
      moff = sizes.moff[h];
    }
  }
  const float* v = vec + head * 3 * BN;
  bias_ln_gelu<TM, TN>(acc, v, v + BN, v + 2 * BN, F);

  const float* proj = w2 + head * kMaxOut * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long hw = (long long)H * W;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float mine = 0.0f;  // lane tx keeps output channel tx
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (o < M) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < TN; ++j) s = fmaf(acc[i][j], proj[o * BN + tx + 16 * j], s);
        s = sum16(s);
        if (tx == o) mine = s + b2[head * kMaxOut + o];
      }
    }
    const long long m = m0 + ty + 16 * i;
    if (m < npix && tx < M) {
      const long long b = m / hw;
      const long long rem = m - b * hw;
      const long long si = rem / W, sj = rem - si * W;
      const long long pix = (b * 2 * H + 2 * si + pa) * 2 * W + 2 * sj + pb;
      out[pix * Mtot + moff + tx] = mine;
    }
  }
}

// The C entry points' body: checks, head sizes, one launch.
template <int TM, int TN>
int launch_heads(const float* x, const float* w, const float* vec, const float* w2,
                 const float* b2, float* out, const int* F, const int* M, int heads, int B,
                 int H, int W, int C, cudaStream_t stream) {
  using T = Tile<TM, TN>;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 4 || heads <= 0 || heads > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  HeadSizes sizes{};
  int mtot = 0;
  for (int h = 0; h < heads; ++h) {
    if (F[h] <= 0 || F[h] > T::BN || M[h] <= 0 || M[h] > kMaxOut)
      return (int)cudaErrorInvalidValue;
    sizes.F[h] = F[h];
    sizes.M[h] = M[h];
    sizes.moff[h] = mtot;
    mtot += M[h];
  }
  const long long npix = (long long)B * H * W;
  const long long tiles = (npix + T::BM - 1) / T::BM;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(heads_kernel<TM, TN>, T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(4 * heads, (unsigned)tiles);
  heads_kernel<TM, TN><<<grid, kThreads, T::SMEM_BYTES, stream>>>(x, w, vec, w2, b2, out, sizes,
                                                                  npix, H, W, C, mtot);
  return (int)cudaGetLastError();
}

}  // namespace fpn_head
