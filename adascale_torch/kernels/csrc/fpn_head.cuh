// FpnHead chains over one shared neck output, for fpn_heads.cu (the two
// rough heads) and precise_heads.cu (the four precise heads), f32 results
// from Hopper's tensor cores (sm_90a), from f32 or bf16 operands:
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
//   * Heads wider than the tile (F > N: the base and large backbones' 256-258
//     and 384-386) split F into `slices` tiles of N: each block runs the
//     same main loop over one slice and stores its pre-LN sums plus the bias
//     (f32) to a workspace (heads, 4 phases, pixels, slices x N); then
//     heads_ln_kernel, a warp per (head, phase, pixel), takes the LayerNorm
//     over the F features, the GELU, the projection and the interleaved
//     write. The two passes go over the pixels a chunk at a time, so the
//     workspace holds one chunk, whatever the batch (the wrapper sizes it).
//     The flagship's widths keep the one-pass kernel.
//
// bf16 (the JAX package's compute_dtype="bfloat16"): x and the collapsed
// taps in bf16 (collapsed in f32, then rounded, as the Pallas kernel packs
// them), products accumulated in f32, the bias, LayerNorm, GELU and
// projection in f32, as the Pallas kernels keep them; the precise heads
// (ROUND_Y) round the GELU output to bf16 before their projection, whose
// weights the wrapper rounds to bf16, as the Pallas precise-heads kernel
// does (the rough heads' projection stays f32 there). The outputs are f32
// either way. Heads that fit the tile run heads_tma_kernel (below) on
// conv_tma.cuh's persistent, TMA-fed loop; wider ones the two passes above
// on conv_gemm.cuh's mainloop_bf16.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "conv_gemm.cuh"
#include "conv_tma.cuh"

namespace fpn_head {

using namespace conv_gemm;

constexpr int kMaxHeads = 4;
constexpr int kMaxOut = 4;
constexpr int kBM = 128;  // low-resolution pixels a block
constexpr int kStages = 3;
constexpr int kMaxSlices = 4;  // the widest head: kMaxSlices tiles of N

struct HeadSizes {
  int F[kMaxHeads];
  int M[kMaxHeads];
  int moff[kMaxHeads];
};

template <typename T, int N>
struct Layout {
  static constexpr int N0 = (N / 2 + 7) / 8 * 8;  // the two wgmma widths
  static constexpr int N1 = N - N0;
  using R = typename RingFor<T, kBM, N, kStages>::type;
  static constexpr int VEC_BYTES = (3 + kMaxOut) * N * 4;  // the head's epilogue vectors
  static constexpr int LDZ = ldz(N);
  static constexpr int TILE_BYTES = kBM * LDZ * 4;
  // The ring, or the epilogue tile over it where the tile is larger (bf16).
  static constexpr int BASE = R::BYTES > TILE_BYTES ? R::BYTES : TILE_BYTES;
  static constexpr size_t SMEM_BYTES = (size_t)BASE + VEC_BYTES + 8 * kStages;
  static_assert(N % 8 == 0 && (N0 == 96 || N0 == 104) && N1 == 96, "head width");
  static_assert(BASE % 16 == 0, "epilogue vectors");
};

// Selects a head's sizes without indexing the parameter struct by a
// run-time value (which would copy it to local memory).
__device__ __forceinline__ void head_sizes(const HeadSizes& sizes, int head, int& F, int& M,
                                           int& moff) {
  F = sizes.F[0];
  M = sizes.M[0];
  moff = sizes.moff[0];
#pragma unroll
  for (int h = 1; h < kMaxHeads; ++h) {
    if (head == h) {
      F = sizes.F[h];
      M = sizes.M[h];
      moff = sizes.moff[h];
    }
  }
}

// Output pixel of low-resolution pixel m at phase (pa, pb).
__device__ __forceinline__ long long out_pixel(int m, int H, int W, int pa, int pb) {
  const int hw = H * W;
  const int b = m / hw, rem = m - b * hw;
  const int si = rem / W, sj = rem - si * W;
  return ((long long)b * 2 * H + 2 * si + pa) * 2 * W + 2 * sj + pb;
}

// x (B, H, W, C); w (heads, 4 phases, 4 taps, ceil(C/32) chunks, parts,
// N/8, 8, 8 rows, 16 bytes of K): each chunk's B in core-matrix order (row
// group, K group, row, K), for f32 a TF32 hi and lo part with K permuted
// within each 8 as conv_gemm.cuh says, for bf16 one part in K's order; zero
// past the head's F and past C; vec (heads, 3, N): smoothing bias, LN
// scale, LN bias; w2 (heads, kMaxOut, N) and b2 (heads, kMaxOut), zero past
// each head's real sizes; out (B, 2H, 2W, Mtot).
template <typename T, int N, bool ROUND_Y>
__global__ void __launch_bounds__(kThreads, 1)
heads_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ vec, const float* __restrict__ w2,
             const float* __restrict__ b2, float* __restrict__ out, HeadSizes sizes, int npix,
             int H, int W, int C, int Mtot) {
  using L = Layout<T, N>;
  constexpr int N0 = L::N0, N1 = L::N1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int head = blockIdx.x / 4, phase = blockIdx.x % 4;
  const int pa = phase / 2, pb = phase % 2;
  const int m0 = blockIdx.y * kBM;
  const int nk = 4 * ((C + kKC - 1) / kKC);
  const T* wb = w + (long long)(head * 4 + phase) * nk * kParts<T> * N * kKC;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // The head's bias, LN scale, LN bias (N each) and projection (kMaxOut x N)
  // for the epilogue, after the ring; then the ring's mbarriers.
  float* sv = reinterpret_cast<float*>(smem + L::BASE);
  for (int i = tid; i < 3 * N; i += kThreads) sv[i] = vec[head * 3 * N + i];
  for (int i = tid; i < kMaxOut * N; i += kThreads) sv[3 * N + i] = w2[head * kMaxOut * N + i];
  const uint32_t bars = sbase + L::BASE + L::VEC_BYTES;

  // Tap t of phase (pa, pb) reads source pixel (i + pa - 1 + t / 2, j + pb - 1 + t % 2).
  const int arow = 64 * (tid / 128);
  float acc0[N0 / 2], acc1[N1 / 2];
  conv_mainloop<T, kBM, N, kStages, N0, N1>(x, wb, npix, H, W, C, Taps{4, 2, pa - 1, pb - 1}, m0,
                                            smem, bars, arow, 0, acc0, acc1);

  int F, M, moff;
  head_sizes(sizes, head, F, M, moff);
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
        float y = gelu_exact((zr[8 * j + e] - mean) * rstd * sv[N + n] + sv[2 * N + n]);
        if constexpr (ROUND_Y) y = round_bf16(y);
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
    if (m < npix && t4 < M) out[out_pixel(m, H, W, pa, pb) * Mtot + moff + t4] = mine;
  }
}

// The wide heads' first pass over the n pixels from p0: block (head,
// slice, phase) x tile runs the main loop over its slice's N features and
// stores z = acc + bias (f32) to ws (heads, 4 phases, chunk, slices N),
// pixel p0 + r at row r. w (heads, slices, 4 phases, ...) as heads_kernel's
// per slice; vec (heads, 3, slices N).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
heads_sums_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ vec, float* __restrict__ ws, int slices, int p0,
                  int n, int chunk, int H, int W, int C) {
  using L = Layout<T, N>;
  constexpr int N0 = L::N0, N1 = L::N1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int phase = blockIdx.x % 4, slice = (blockIdx.x / 4) % slices;
  const int head = blockIdx.x / (4 * slices);
  const int pa = phase / 2, pb = phase % 2;
  const int r0 = blockIdx.y * kBM;
  const int nk = 4 * ((C + kKC - 1) / kKC);
  const T* wb = w + (long long)((head * slices + slice) * 4 + phase) * nk * kParts<T> * N * kKC;
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + L::R::BYTES;
  const int arow = 64 * (tid / 128);
  float acc0[N0 / 2], acc1[N1 / 2];
  conv_mainloop<T, kBM, N, kStages, N0, N1>(x, wb, p0 + n, H, W, C, Taps{4, 2, pa - 1, pb - 1},
                                            p0 + r0, smem, bars, arow, 0, acc0, acc1);
  const int fp = slices * N;
  float* wsb = ws + (long long)(head * 4 + phase) * chunk * fp;
  const float* bias = vec + (long long)head * 3 * fp;
  const int t4 = tid % 4, r = r0 + arow + quad_row();
  store_sums(acc0, wsb, r, n, fp, slice * N, t4, bias);
  store_sums(acc1, wsb, r, n, fp, slice * N + N0, t4, bias);
}

// The wide heads' second pass over heads_sums_kernel's chunk: warp w of
// block (x, head * 4 + phase) takes pixel p0 + 8 x + w: LayerNorm over the
// head's F sums, GELU (rounded to bf16 where ROUND_Y), the projection and
// the interleaved write. vec (heads, 3, fp), w2 (heads, kMaxOut, fp), b2
// (heads, kMaxOut).
template <bool ROUND_Y>
__global__ void __launch_bounds__(kThreads)
heads_ln_kernel(const float* __restrict__ ws, const float* __restrict__ vec,
                const float* __restrict__ w2, const float* __restrict__ b2,
                float* __restrict__ out, HeadSizes sizes, int fp, int p0, int n, int chunk,
                int H, int W, int Mtot) {
  const int head = blockIdx.y / 4, phase = blockIdx.y % 4;
  const int r = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= n) return;
  const int m = p0 + r;
  int F, M, moff;
  head_sizes(sizes, head, F, M, moff);
  const float* z = ws + ((long long)blockIdx.y * chunk + r) * fp;
  const float* g = vec + (long long)head * 3 * fp + fp;
  const float* wp = w2 + (long long)head * kMaxOut * fp;
  float rstd;
  const float mean = warp_ln_stats(z, F, rstd);
  float dot[kMaxOut] = {};
  for (int n = lane; n < F; n += 32) {
    float y = gelu_exact((z[n] - mean) * rstd * g[n] + g[fp + n]);
    if constexpr (ROUND_Y) y = round_bf16(y);
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) dot[o] = fmaf(y, wp[o * fp + n], dot[o]);
  }
  float mine = 0.0f;
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    const float v = warp_sum(dot[o]);
    if (lane == o) mine = v + __ldg(b2 + head * kMaxOut + o);
  }
  if (lane < M) out[out_pixel(m, H, W, phase / 2, phase % 2) * Mtot + moff + lane] = mine;
}

// The C entry points' body: checks, head sizes, one launch (where the
// heads are split into slices, two a chunk of `chunk` pixels, a multiple of
// kBM; ws then holds heads x 4 x chunk x slices N floats).
template <typename T, int N, bool ROUND_Y>
int launch_heads(const T* x, const T* w, const float* vec, const float* w2, const float* b2,
                 float* out, float* ws, int chunk, const int* F, const int* M, int heads,
                 int slices, int B, int H, int W, int C, cudaStream_t stream) {
  using L = Layout<T, N>;
  constexpr int kVec = std::is_same<T, float>::value ? 4 : 8;  // channels a 16-byte copy
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % kVec || H > 32767 || W > 32767 ||
      heads <= 0 || heads > kMaxHeads || slices <= 0 || slices > kMaxSlices ||
      (slices > 1 && (ws == nullptr || chunk <= 0 || chunk % kBM)))
    return (int)cudaErrorInvalidValue;
  HeadSizes sizes{};
  int mtot = 0;
  for (int h = 0; h < heads; ++h) {
    if (F[h] <= 0 || F[h] > slices * N || M[h] <= 0 || M[h] > kMaxOut)
      return (int)cudaErrorInvalidValue;
    sizes.F[h] = F[h];
    sizes.M[h] = M[h];
    sizes.moff[h] = mtot;
    mtot += M[h];
  }
  const long long npix = (long long)B * H * W;
  const long long tiles = (npix + kBM - 1) / kBM;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  if (slices == 1) {
    cudaError_t e = allow_smem(heads_kernel<T, N, ROUND_Y>, L::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(4 * heads, (unsigned)tiles);
    heads_kernel<T, N, ROUND_Y><<<grid, kThreads, L::SMEM_BYTES, stream>>>(
        x, w, vec, w2, b2, out, sizes, (int)npix, H, W, C, mtot);
    return (int)cudaGetLastError();
  }
  constexpr size_t smem = (size_t)L::R::BYTES + 8 * kStages;
  cudaError_t e = allow_smem(heads_sums_kernel<T, N>, smem);
  if (e != cudaSuccess) return (int)e;
  for (int p0 = 0; p0 < npix; p0 += chunk) {
    const int n = (int)std::min<long long>(chunk, npix - p0);
    heads_sums_kernel<T, N><<<dim3(4 * heads * slices, (n + kBM - 1) / kBM), kThreads, smem,
                              stream>>>(x, w, vec, ws, slices, p0, n, chunk, H, W, C);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int rows = (n + kThreads / 32 - 1) / (kThreads / 32);
    heads_ln_kernel<ROUND_Y><<<dim3(rows, 4 * heads), kThreads, 0, stream>>>(
        ws, vec, w2, b2, out, sizes, slices * N, p0, n, chunk, H, W, mtot);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16, one pass (F <= N): on conv_tma.cuh's loop.
//
// A unit is one (head, phase) of a 128-pixel tile (8 rows x 16 columns of
// one image): each consumer warpgroup takes 4 of the rows by all N features
// (N0 + N1 wgmma widths), over ceil(C / 64) chunks of the phase's 2x2
// window, one 9 x 17 halo box a chunk serving its 4 taps. The epilogue runs
// on the accumulators' registers: bias, LayerNorm over the head's F
// features (a row's features lie in its quad), GELU (rounded to bf16 where
// ROUND_Y), the projection to M <= 4 outputs, and the interleaved write;
// the producer meanwhile loads the next unit. Every head's vectors sit in
// shared memory for the block's life.

template <int N>
using HeadsLoop =
    conv_tma::Loop<8, 2, 2, N, Layout<bf16, N>::N0, Layout<bf16, N>::N1, false, 2, 6>;

template <int N>
constexpr int heads_tma_smem() {
  return HeadsLoop<N>::HEAD + kMaxHeads * (3 + kMaxOut) * N * 4;
}

// x through xmap (B, H, W, C as conv_tma::make_map, boxes of HeadsLoop's
// halo); w (heads, 4 phases, 4 taps, ceil(C/64) chunks, N/8, 8 rows, 128
// bytes of K in the 128-byte swizzle); vec, w2, b2 and out as
// heads_kernel's.
template <int N, bool ROUND_Y>
__global__ void __launch_bounds__(conv_tma::kThreads, 1)
heads_tma_kernel(const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ w,
                 const float* __restrict__ vec, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ out, HeadSizes sizes,
                 conv_tma::Geo g, int heads, int Mtot) {
  using L = HeadsLoop<N>;
  constexpr int N0 = L::N0, N1 = L::N1, kV = (3 + kMaxOut) * N;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t ring = conv_tma::ring_base(smem), bars = ring + L::RING;
  // Each head's bias, LN scale, LN bias (N each), then its projection
  // (kMaxOut x N).
  float* sv = conv_tma::after_ring<L>(smem, ring);
  for (int i = tid; i < heads * kV; i += conv_tma::kThreads) {
    const int h = i / kV, j = i - h * kV;
    sv[i] = j < 3 * N ? vec[h * 3 * N + j] : w2[h * kMaxOut * N + j - 3 * N];
  }
  conv_tma::init_bars<L>(bars);
  __syncthreads();
  const int units = g.tiles * g.sets;
  if (tid >= conv_tma::kConsumers) {
    conv_tma::producer_regs();
    auto taps_of = [](int set) {
      const int phase = set % 4;
      return Taps{4, 2, phase / 2 - 1, phase % 2 - 1};
    };
    if (tid == conv_tma::kConsumers) conv_tma::produce<L>(&xmap, w, g, taps_of, ring, bars);
    return;
  }
  conv_tma::consumer_regs();
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32, t4 = lane % 4;
  const int row0 = 64 * wg + 16 * warp + lane / 4;  // the tile row of this thread's first
  float acc0[N0 / 2], acc1[N1 / 2];
  conv_tma::Cursor cur;
  for (int un = blockIdx.x; un < units; un += gridDim.x) {
    const conv_tma::Unit u = conv_tma::unit_of<8>(g, un);
    conv_tma::consume<L>(ring, bars, g.chunks, cur, 4 * wg, 0, acc0, acc1);
    const int head = u.set / 4, phase = u.set % 4, pa = phase / 2, pb = phase % 2;
    int F, M, moff;
    head_sizes(sizes, head, F, M, moff);
    const float* hv = sv + head * kV;
    // z = acc + bias; register i holds feature n0 + 8 (i / 4) + 2 t4 + i % 2
    // of row (i / 2) % 2.
    float sum[2] = {0.0f, 0.0f};
    auto add_bias = [&](auto& a, int n0) {
#pragma unroll
      for (int i = 0; i < (int)(sizeof(a) / sizeof(float)); i += 2) {
        const float2 bias = *reinterpret_cast<const float2*>(hv + n0 + 8 * (i / 4) + 2 * t4);
        a[i] += bias.x;
        a[i + 1] += bias.y;
        sum[(i >> 1) & 1] += a[i] + a[i + 1];
      }
    };
    add_bias(acc0, 0);
    add_bias(acc1, N0);
    const float inv_f = 1.0f / F;
    float mean[2], rstd[2], sq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) mean[r] = conv_gemm::quad_sum(sum[r]) * inv_f;
    auto square = [&](auto& a, int n0) {
#pragma unroll
      for (int i = 0; i < (int)(sizeof(a) / sizeof(float)); i += 2) {
        const int n = n0 + 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
        const float d0 = a[i] - mean[r], d1 = a[i + 1] - mean[r];
        sq[r] = fmaf(d0, n < F ? d0 : 0.0f, sq[r]);
        sq[r] = fmaf(d1, n + 1 < F ? d1 : 0.0f, sq[r]);
      }
    };
    square(acc0, 0);
    square(acc1, N0);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rstd[r] = rsqrtf(conv_gemm::quad_sum(sq[r]) * inv_f + conv_gemm::kEps);
    // GELU and the projection in one pass; the LN scale and bias and the
    // projection are zero past F, the projection and b2 past M.
    float dot[2][kMaxOut] = {};
    auto project = [&](auto& a, int n0) {
#pragma unroll
      for (int i = 0; i < (int)(sizeof(a) / sizeof(float)); i += 2) {
        const int n = n0 + 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
        const float2 ga = *reinterpret_cast<const float2*>(hv + N + n);
        const float2 be = *reinterpret_cast<const float2*>(hv + 2 * N + n);
        float y0 = gelu_exact((a[i] - mean[r]) * rstd[r] * ga.x + be.x);
        float y1 = gelu_exact((a[i + 1] - mean[r]) * rstd[r] * ga.y + be.y);
        if constexpr (ROUND_Y) {
          y0 = round_bf16(y0);
          y1 = round_bf16(y1);
        }
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) {
          const float2 p = *reinterpret_cast<const float2*>(hv + (3 + o) * N + n);
          dot[r][o] = fmaf(y1, p.y, fmaf(y0, p.x, dot[r][o]));
        }
      }
    };
    project(acc0, 0);
    project(acc1, N0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mine = 0.0f;  // thread t4 keeps output channel t4
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        const float v = conv_gemm::quad_sum(dot[r][o]);
        if (t4 == o) mine = v + __ldg(b2 + head * kMaxOut + o);
      }
      const int row = row0 + 8 * r;
      const int h = u.h0 + row / conv_tma::kBW, x = u.w0 + row % conv_tma::kBW;
      if (u.b < g.B && h < g.H && x < g.W && t4 < M)
        out[(((long long)u.b * 2 * g.H + 2 * h + pa) * 2 * g.W + 2 * x + pb) * Mtot + moff + t4] =
            mine;
    }
  }
}

// The bf16 C entry points' body: the one-pass heads on conv_tma.cuh's loop;
// heads wider than the tile through launch_heads' two passes.
template <int N, bool ROUND_Y>
int launch_heads_bf16(const bf16* x, const bf16* w, const float* vec, const float* w2,
                      const float* b2, float* out, float* ws, int chunk, const int* F,
                      const int* M, int heads, int slices, int B, int H, int W, int C,
                      cudaStream_t stream) {
  if (slices != 1)
    return launch_heads<bf16, N, ROUND_Y>(x, w, vec, w2, b2, out, ws, chunk, F, M, heads, slices, B,
                                          H, W, C, stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || heads <= 0 || heads > kMaxHeads)
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
  using L = HeadsLoop<N>;
  constexpr int smem = heads_tma_smem<N>();
  static_assert(smem <= conv_tma::kSmemLimit, "shared memory");
  const conv_tma::Geo g = conv_tma::make_geo(B, H, W, C, L::BH, 4 * heads);
  if ((long long)g.tiles * g.sets >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = conv_tma::persistent_grid<heads_tma_kernel<N, ROUND_Y>>(
      smem, (long long)g.tiles * g.sets, &grid);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  e = conv_tma::make_map<L>(&map, x, B, H, W, C);
  if (e != cudaSuccess) return (int)e;
  heads_tma_kernel<N, ROUND_Y><<<grid, conv_tma::kThreads, smem, stream>>>(
      map, w, vec, w2, b2, out, sizes, g, heads, mtot);
  return (int)cudaGetLastError();
}

}  // namespace fpn_head
