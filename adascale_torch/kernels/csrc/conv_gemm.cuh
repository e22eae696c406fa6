// Shared pieces of the neck and head kernels (fpn_neck_l0.cu, fpn_heads.cu,
// precise_heads.cu), f32 SIMT for Hopper (sm_90a).
//
// Each of those kernels is an implicit-GEMM convolution followed by a
// LayerNorm over the output features of one pixel and an exact GELU:
//
//   acc[m][n] = sum_{t, c} x[b, i + oy_t, j + ox_t, c] * w[t][c][n]
//
// where m = (b, i, j) walks the pixels of an NHWC map, t walks the taps of a
// 1x1, 3x3 or phase-collapsed 2x2 window, and a tap that falls outside the
// map reads zero (the convolution's zero padding). The LayerNorm needs all
// features of a pixel in one block, so a block owns BM = 16*TM pixels by all
// BN = 16*TN features (the real width N <= BN; w is zero past N).
//
// Bound: f32 FMAs (no tensor cores: TF32 misses the 1e-5 kernel bar over
// K = 4*384 or 9*384). A naive kernel that streams K from global memory for
// each output reaches a few percent of the 67 TFLOP/s peak, so this is a
// shared-memory-tiled GEMM with register blocking:
//   * 256 threads as 16 (features, tx) x 16 (pixels, ty); a thread owns
//     pixels ty + 16*i (i < TM) and features tx + 16*j (j < TN), so a
//     pixel's features live in one half-warp and the LayerNorm reductions
//     are four shuffles;
//   * K is staged 16 input channels of one tap at a time through a
//     three-stage cp.async ring in shared memory (16-byte copies, zero-fill
//     for taps outside the map and for channels past C);
//   * per 4 channels a thread reads TM float4 of A and 4*TN floats of B from
//     shared memory for 4*TM*TN FMAs (A broadcast within a half-warp, B
//     conflict-free).
// x needs C % 4 == 0 and 16-byte alignment (the wrappers check it).

#pragma once

#include <cuda_runtime.h>

namespace conv_gemm {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // input channels per K chunk
constexpr int kStages = 3;
constexpr float kEps = 1e-6f;

// Tap t reads source pixel (i + oy0 + t / kw, j + ox0 + t % kw).
struct Taps {
  int count, kw, oy0, ox0;
};

template <int TM, int TN>
struct Tile {
  static constexpr int BM = 16 * TM;
  static constexpr int BN = 16 * TN;
  static constexpr int A_FLOATS = BM * kBK;
  static constexpr int STAGE_FLOATS = A_FLOATS + kBK * BN;
  static constexpr size_t SMEM_BYTES = (size_t)kStages * STAGE_FLOATS * sizeof(float);
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// acc[i][j] = sum over taps and channels for pixel m0 + ty + 16 i (flattened
// over B, H, W; npix = B*H*W) and feature tx + 16 j. x is (B, H, W, C);
// w is (taps, C, BN). smem holds Tile<TM, TN>::SMEM_BYTES.
template <int TM, int TN>
__device__ __forceinline__ void mainloop(const float* __restrict__ x, const float* __restrict__ w,
                                         long long npix, int H, int W, int C, Taps taps,
                                         long long m0, float* smem, float (&acc)[TM][TN]) {
  using T = Tile<TM, TN>;
  constexpr int BN = T::BN;
  constexpr int A_VECS = T::BM * (kBK / 4);
  constexpr int A_ITERS = (A_VECS + kThreads - 1) / kThreads;
  constexpr int B_VECS = kBK * BN / 4;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long hw = (long long)H * W;

  // The A rows this thread copies are the same for every chunk.
  int a_i[A_ITERS], a_j[A_ITERS];
  long long a_base[A_ITERS];
  bool a_ok[A_ITERS];
#pragma unroll
  for (int r = 0; r < A_ITERS; ++r) {
    const int idx = tid + r * kThreads;
    const long long m = m0 + idx / 4;
    a_ok[r] = idx < A_VECS && m < npix;
    const long long b = a_ok[r] ? m / hw : 0;
    const long long rem = a_ok[r] ? m - b * hw : 0;
    a_i[r] = (int)(rem / W);
    a_j[r] = (int)(rem - (long long)a_i[r] * W);
    a_base[r] = b * hw;
  }

  const int chunks_per_tap = (C + kBK - 1) / kBK;
  const int nk = taps.count * chunks_per_tap;

  auto load = [&](int kt, int stage) {
    const int t = kt / chunks_per_tap;
    const int c0 = (kt - t * chunks_per_tap) * kBK;
    const int oy = taps.oy0 + t / taps.kw;
    const int ox = taps.ox0 + t % taps.kw;
    float* As = smem + stage * T::STAGE_FLOATS;
    float* Bs = As + T::A_FLOATS;
#pragma unroll
    for (int r = 0; r < A_ITERS; ++r) {
      const int idx = tid + r * kThreads;
      if (A_VECS % kThreads == 0 || idx < A_VECS) {
        const int row = idx / 4, q = idx % 4;
        const int c = c0 + 4 * q;
        const int iy = a_i[r] + oy, ix = a_j[r] + ox;
        const bool ok = a_ok[r] && iy >= 0 && iy < H && ix >= 0 && ix < W && c < C;
        const float* src = ok ? x + ((a_base[r] + (long long)iy * W + ix) * C + c) : x;
        cp_async16(As + row * kBK + 4 * q, src, ok);
      }
    }
    for (int idx = tid; idx < B_VECS; idx += kThreads) {
      const int kk = idx / (BN / 4), v = idx % (BN / 4);
      const int c = c0 + kk;
      const bool ok = c < C;
      const float* src = ok ? w + ((long long)(t * C + c) * BN + 4 * v) : w;
      cp_async16(Bs + kk * BN + 4 * v, src, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kt landed for all; chunk kt-1's stage is free
    const int next = kt + kStages - 1;
    if (next < nk) load(next, next % kStages);
    cp_async_commit();

    const float* As = smem + (kt % kStages) * T::STAGE_FLOATS;
    const float* Bs = As + T::A_FLOATS;
#pragma unroll
    for (int k4 = 0; k4 < kBK / 4; ++k4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * kBK + 4 * k4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float b[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[(4 * k4 + e) * BN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = e == 0 ? a[i].x : e == 1 ? a[i].y : e == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// In place: acc[i][j] <- GELU(LN(acc + bias) * gamma + beta) over the real
// features n = tx + 16 j < N (mean and biased variance over N, eps 1e-6);
// features n >= N become 0.
template <int TM, int TN>
__device__ __forceinline__ void bias_ln_gelu(float (&acc)[TM][TN], const float* __restrict__ bias,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta, int N) {
  const int tx = threadIdx.x % 16;
  const float inv_n = 1.0f / N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 16 * j;
      if (n < N) {
        acc[i][j] += bias[n];
        s += acc[i][j];
      }
    }
    const float mean = sum16(s) * inv_n;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 16 * j;
      if (n < N) {
        const float d = acc[i][j] - mean;
        q = fmaf(d, d, q);
      }
    }
    const float rstd = rsqrtf(sum16(q) * inv_n + kEps);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 16 * j;
      acc[i][j] = n < N ? gelu_exact((acc[i][j] - mean) * rstd * gamma[n] + beta[n]) : 0.0f;
    }
  }
}

// Opts a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace conv_gemm
