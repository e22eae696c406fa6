// FpnHead chains over one shared neck output, for fpn_heads.cu (the two
// rough heads) and precise_heads.cu (the four precise heads), f32 results
// from Hopper's tensor cores (sm_90a):
//
//   y_h = Linear_h(GELU(LN_h(conv3x3_h(nearest_x2(x)) + sb_h)))
//
// The nearest-x2 upsample followed by the 3x3 is computed as four phases at
// the low resolution: output pixel (2i+a, 2j+b) is a 2x2 convolution whose
// tap (dy, dx) multiplies source pixel (i+a-1+dy, j+b-1+dx) with the 3x3's
// taps collapsed along each axis (parity 0: [k0, k1+k2], parity 1:
// [k0+k1, k2]). Zero padding outside the low-resolution map is exact,
// because nearest-x2 of a zero border is a zero border. Each (head, phase)
// is an implicit GEMM with K = 4 taps x C, 4/9 of the work of the 3x3 at
// the high resolution.
//
// What bounds it: the products, 4 phases x 4 taps x C x sum(F) x 2 flops
// per low-resolution pixel. On the tensor cores at f32 accuracy each
// product is three TF32 products (below), so the bound is 3 x flops at the
// H100 SXM's 495 TFLOP/s dense TF32 (700 W): 1.32 ms for the rough heads at
// 240x192x384, 3.07 ms for the precise heads at 256x208x384.
//
// Design (one launch), on the implicit GEMM of conv_gemm.cuh:
//   * A block owns one head at one phase for kBM = 128 low-resolution pixels
//     (flattened over B, H, W) and all of the head's features, padded to N
//     (a multiple of 8; the wrapper zero-pads the weights). 256 threads are
//     two warpgroups; warpgroup w owns pixel rows 64w..64w+63 and all N
//     features, so a row's LayerNorm sums are two quad shuffles. The blocks
//     of one pixel tile (all heads and phases) are adjacent in the grid, so
//     the tile's input is read from L2: x passes through L2 once per
//     (head, phase), 8 times (rough) or 16 times (precise).
//   * The main loop is conv_gemm::mainloop over the phase's 4 taps, a
//     three-stage ring, N split as N0 + N1 (96 + 96 or 104 + 96) wgmma
//     widths sharing one fresh tile.
//   * The epilogue stays in the block: the tile plus the bias goes to shared
//     memory over the ring and each thread reads back its two rows (so the
//     GELUs do not need the accumulators' registers); LayerNorm over the
//     head's real F features (mean, then biased variance, eps 1e-6; a row's
//     features lie in one quad, so each sum is two shuffles), exact erf
//     GELU, the projection to the head's M <= 4 channels, and the
//     interleaved (B, 2H, 2W, Mtot) write, each head at its own channel
//     offset.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_gemm.cuh"

namespace fpn_head {

using namespace conv_gemm;

constexpr int kMaxHeads = 4;
constexpr int kMaxOut = 4;
constexpr int kBM = 128;  // low-resolution pixels a block
constexpr int kStages = 3;

struct HeadSizes {
  int F[kMaxHeads];
  int M[kMaxHeads];
  int moff[kMaxHeads];
};

template <int N>
struct Layout {
  static constexpr int N0 = (N / 2 + 7) / 8 * 8;  // the two wgmma widths
  static constexpr int N1 = N - N0;
  using R = Ring<kBM, N, kStages>;
  static constexpr int VEC_BYTES = (3 + kMaxOut) * N * 4;  // the head's epilogue vectors
  static constexpr int LDZ = ldz(N);
  static constexpr size_t SMEM_BYTES = (size_t)R::BYTES + VEC_BYTES + 8 * kStages;
  static_assert(N % 8 == 0 && (N0 == 96 || N0 == 104) && N1 == 96, "head width");
  static_assert(kBM * LDZ * 4 <= R::BYTES, "epilogue tile");
};

// x (B, H, W, C); w (heads, 4 phases, 4 taps, ceil(C/32) chunks, [hi, lo],
// N/8, 8, 8, 4): each chunk's B in core-matrix order (row group, K group of
// 4, row, K), K permuted within each 8 as above, zero past the head's F and
// past C; vec (heads, 3, N): smoothing bias, LN scale, LN bias; w2 (heads,
// kMaxOut, N) and b2 (heads, kMaxOut), zero past each head's real sizes;
// out (B, 2H, 2W, Mtot).
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
heads_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ vec, const float* __restrict__ w2,
             const float* __restrict__ b2, float* __restrict__ out, HeadSizes sizes, int npix,
             int H, int W, int C, int Mtot) {
  using L = Layout<N>;
  constexpr int N0 = L::N0, N1 = L::N1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int head = blockIdx.x / 4, phase = blockIdx.x % 4;
  const int pa = phase / 2, pb = phase % 2;
  const int m0 = blockIdx.y * kBM;
  const int nk = 4 * ((C + kKC - 1) / kKC);
  const float* wb = w + (long long)(head * 4 + phase) * nk * 2 * N * kKC;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // The head's bias, LN scale, LN bias (N each) and projection (kMaxOut x N)
  // for the epilogue, after the ring; then the ring's mbarriers.
  float* sv = reinterpret_cast<float*>(smem + L::R::BYTES);
  for (int i = tid; i < 3 * N; i += kThreads) sv[i] = vec[head * 3 * N + i];
  for (int i = tid; i < kMaxOut * N; i += kThreads) sv[3 * N + i] = w2[head * kMaxOut * N + i];
  const uint32_t bars = sbase + L::R::BYTES + L::VEC_BYTES;

  // Tap t of phase (pa, pb) reads source pixel (i + pa - 1 + t / 2, j + pb - 1 + t % 2).
  const int arow = 64 * (tid / 128);
  float acc0[N0 / 2], acc1[N1 / 2];
  mainloop<kBM, N, kStages, N0, N1>(x, wb, npix, H, W, C, Taps{4, 2, pa - 1, pb - 1}, m0, smem,
                                    bars, arow, 0, acc0, acc1);

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
  // The epilogue reads the tile back from shared memory, one row and 8
  // features at a time, so its GELUs do not compete with the accumulators
  // for registers: z = acc + bias (kBM x LDZ) goes over the ring, which
  // both warpgroups have finished with.
  __syncthreads();
  float* z = reinterpret_cast<float*>(smem);
  const int t4 = tid % 4, row0 = arow + quad_row();
  store_pairs(acc0, z + row0 * L::LDZ, L::LDZ, 0, t4, sv);
  store_pairs(acc1, z + row0 * L::LDZ, L::LDZ, N0, t4, sv);
  __syncwarp();  // a row's features come from the four threads of its quad
  const int hw = H * W;
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const float* zr = z + (row0 + 8 * r) * L::LDZ + 2 * t4;
    float rstd;
    const float mean = ln_stats<N>(zr, F, t4, rstd);
    // GELU and the projection in one pass; the LN scale and bias and the
    // projection are zero past F, the projection and b2 past M.
    float dot[kMaxOut] = {};
#pragma unroll 2
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * t4 + e;
        const float y = gelu_exact((zr[8 * j + e] - mean) * rstd * sv[N + n] + sv[2 * N + n]);
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) dot[o] = fmaf(y, sv[(3 + o) * N + n], dot[o]);
      }
    }
    float mine = 0.0f;  // thread t4 keeps output channel t4
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      const float v = quad_sum(dot[o]);
      if (t4 == o) mine = v + __ldg(b2 + head * kMaxOut + o);
    }
    const int m = m0 + row0 + 8 * r;
    if (m < npix && t4 < M) {
      const int b = m / hw, rem = m - b * hw;
      const int si = rem / W, sj = rem - si * W;
      const long long pix = ((long long)b * 2 * H + 2 * si + pa) * 2 * W + 2 * sj + pb;
      out[pix * Mtot + moff + t4] = mine;
    }
  }
}

// The C entry points' body: checks, head sizes, one launch.
template <int N>
int launch_heads(const float* x, const float* w, const float* vec, const float* w2,
                 const float* b2, float* out, const int* F, const int* M, int heads, int B,
                 int H, int W, int C, cudaStream_t stream) {
  using L = Layout<N>;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 4 || H > 32767 || W > 32767 || heads <= 0 ||
      heads > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  HeadSizes sizes{};
  int mtot = 0;
  for (int h = 0; h < heads; ++h) {
    if (F[h] <= 0 || F[h] > N || M[h] <= 0 || M[h] > kMaxOut) return (int)cudaErrorInvalidValue;
    sizes.F[h] = F[h];
    sizes.M[h] = M[h];
    sizes.moff[h] = mtot;
    mtot += M[h];
  }
  const long long npix = (long long)B * H * W;
  const long long tiles = (npix + kBM - 1) / kBM;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(heads_kernel<N>, L::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(4 * heads, (unsigned)tiles);
  heads_kernel<N><<<grid, kThreads, L::SMEM_BYTES, stream>>>(x, w, vec, w2, b2, out, sizes,
                                                             (int)npix, H, W, C, mtot);
  return (int)cudaGetLastError();
}

}  // namespace fpn_head
