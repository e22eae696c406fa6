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
//     and 384-386) split F into `slices` slices of NS features (NS = N, or
//     the library's narrower slice where `slices` of it hold F, with no
//     padding: 128 rough, 136 precise at the base widths), and the slices
//     of one (head, phase, pixel tile) are the CTAs of one thread-block
//     cluster (heads_cluster_kernel; heads_cluster_tma_kernel for bf16 and
//     the single-pass TF32 entries below): each runs the main loop over its
//     slice, and the LayerNorm's statistics (each slice's row sum and
//     squared deviations from its own mean over its real features, the
//     feature index global) and the projection's partial dots cross the
//     cluster through distributed shared memory, combined in rank order so
//     that every CTA gets the same bits; rank 0 adds b2 and writes. One
//     launch, no workspace.

// bf16 (the JAX package's compute_dtype="bfloat16"): x and the collapsed
// taps in bf16 (collapsed in f32, then rounded, as the Pallas kernel packs
// them), products accumulated in f32, the bias, LayerNorm, GELU and
// projection in f32, as the Pallas kernels keep them; the precise heads
// (ROUND_Y) round the GELU output to bf16 before their projection, whose
// weights the wrapper rounds to bf16, as the Pallas precise-heads kernel
// does (the rough heads' projection stays f32 there). The outputs are f32
// either way. Heads that fit the tile run heads_tma_kernel (below) on
// conv_tma.cuh's persistent, TMA-fed loop; wider ones its cluster form,
// heads_cluster_tma_kernel.
//
// The single-pass TF32 entries (matmul_precision "default" / "high"): where
// the heads fit the tile, heads_tma_kernel with f32 operands (the rough
// heads at N = 192, the precise at 200), x rounded to TF32 in registers and
// the taps rounded when packed (packing.pack_sw128_tf32), 32 channels a box
// row (launch_heads_tma); wider heads heads_cluster_tma_kernel on f32.

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
  using R = Ring<kBM, N, kStages>;
  static constexpr int VEC_BYTES = (3 + kMaxOut) * N * 4;  // the head's epilogue vectors
  static constexpr int LDZ = ldz(N);
  static constexpr int TILE_BYTES = kBM * LDZ * 4;
  // The ring, or the epilogue tile over it where the tile is larger (bf16).
  static constexpr int BASE = R::BYTES > TILE_BYTES ? R::BYTES : TILE_BYTES;
  static constexpr size_t SMEM_BYTES = (size_t)BASE + VEC_BYTES + 8 * kStages;
  // The tiles (96 + 96, 104 + 96) and the wide heads' narrower slices (64 +
  // 64, 72 + 64).
  static_assert(N % 8 == 0 && (((N0 == 96 || N0 == 104) && N1 == 96) || ((N0 == 64 || N0 == 72) && N1 == 64)),
                "head width");
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
// each head's real sizes; out (B, 2H, 2W, Mtot). PASSES: TF32 products a
// product for f32 (conv_gemm.cuh's mainloop: 3, or 1 for matmul_precision
// "default" / "high").
template <typename T, int N, bool ROUND_Y, int PASSES = 3>
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
  const T* wb = w + (long long)(head * 4 + phase) * nk * kParts * N * kKC;
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
  static_assert(std::is_same<T, float>::value, "the 3xTF32 loop's operands are f32");
  mainloop<kBM, N, kStages, N0, N1, PASSES>(x, wb, npix, H, W, C, Taps{4, 2, pa - 1, pb - 1}, m0, smem, bars,
                                            arow, 0, acc0, acc1);

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

// The heads' sizes from the C entry points' arrays: false where a head is
// not 0 < F <= fcap, 0 < M <= kMaxOut; mtot is the sum of M.
inline bool fill_sizes(const int* F, const int* M, int heads, int fcap, HeadSizes& sizes, int& mtot) {
  sizes = HeadSizes{};
  mtot = 0;
  for (int h = 0; h < heads; ++h) {
    if (F[h] <= 0 || F[h] > fcap || M[h] <= 0 || M[h] > kMaxOut) return false;
    sizes.F[h] = F[h];
    sizes.M[h] = M[h];
    sizes.moff[h] = mtot;
    mtot += M[h];
  }
  return true;
}

// The C entry points' body for one tile (F <= N): checks, head sizes, one
// launch. PASSES as heads_kernel's.
template <typename T, int N, bool ROUND_Y, int PASSES = 3>
int launch_heads(const T* x, const T* w, const float* vec, const float* w2, const float* b2,
                 float* out, const int* F, const int* M, int heads, int B, int H, int W, int C,
                 cudaStream_t stream) {
  using L = Layout<T, N>;
  constexpr int kVec = std::is_same<T, float>::value ? 4 : 8;  // channels a 16-byte copy
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % kVec || H > 32767 || W > 32767 ||
      heads <= 0 || heads > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  HeadSizes sizes;
  int mtot;
  if (!fill_sizes(F, M, heads, N, sizes, mtot)) return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  const long long tiles = (npix + kBM - 1) / kBM;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(heads_kernel<T, N, ROUND_Y, PASSES>, L::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(4 * heads, (unsigned)tiles);
  heads_kernel<T, N, ROUND_Y, PASSES><<<grid, kThreads, L::SMEM_BYTES, stream>>>(
      x, w, vec, w2, b2, out, sizes, (int)npix, H, W, C, mtot);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Heads wider than one tile: `slices` CTAs of one thread-block cluster a
// (head, phase, pixel tile), CTA (cluster rank) r computing features
// r N .. r N + N - 1 of every head (N here the slice width), w packed slice
// by slice, (slices, heads, 4 phases, ...) with each slice in its one-tile
// layout; vec (heads, 3, slices N) and w2 (heads, kMaxOut, slices N) as
// one tile's of slices N features. Each CTA keeps its slice's vectors.
// Per pixel row each slice's sum of z = acc + bias and sum of squared
// deviations from its own mean over its real features (feature r N + n
// counts while it is below F) cross the cluster, and every CTA combines
// them in rank order (combine_stats), so that all compute the same mean
// and rstd bit for bit, with one exchange; then the slices' partial dots of
// the projection go to rank 0, which adds them in rank order, adds b2 and
// writes the interleaved output.

using conv_tma::ClusterLaunch;
using conv_tma::combine_stats;

// The 3xTF32 (f32) form, on conv_gemm.cuh's main loop: a CTA is one slice
// of one (head, phase, 128-pixel tile), the grid (4 heads slices, tiles)
// in clusters of (slices, 1, 1). All 256 threads are consumers, so each
// exchange is a cluster barrier: every CTA writes its rows' partials to its
// own shared memory, the cluster syncs, and each reads its peers' through
// ld.shared::cluster. The epilogue reads the tile back from shared memory,
// as heads_kernel's.
constexpr int kXchgF32Floats = (2 + kMaxOut) * kBM;  // (sum, squared deviations), then dots, a row

template <int N>
constexpr size_t heads_cluster_smem() {
  // The tile's layout, then the exchange on a 16-byte boundary.
  return (size_t)Layout<float, N>::BASE + Layout<float, N>::VEC_BYTES + 32 + 4 * kXchgF32Floats;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
heads_cluster_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ vec, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out, HeadSizes sizes, int npix,
                     int H, int W, int C, int Mtot, int heads) {
  using L = Layout<float, N>;
  constexpr int N0 = L::N0, N1 = L::N1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int rank = conv_tma::cluster_rank(), slices = conv_tma::cluster_size();
  const int set = blockIdx.x / slices, head = set / 4, phase = set % 4;
  const int pa = phase / 2, pb = phase % 2;
  const int m0 = blockIdx.y * kBM;
  const int nk = 4 * ((C + kKC - 1) / kKC);
  const int fp = slices * N, n0 = rank * N;  // the features of the head, of this slice's first
  const float* wb = w + (long long)(rank * heads * 4 + set) * nk * kParts * N * kKC;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // This slice's bias, LN scale, LN bias (N each) and projection (kMaxOut x
  // N), after the ring; then the ring's mbarriers; then the exchange.
  float* sv = reinterpret_cast<float*>(smem + L::BASE);
  for (int i = tid; i < 3 * N; i += kThreads) sv[i] = vec[(head * 3 + i / N) * fp + n0 + i % N];
  for (int i = tid; i < kMaxOut * N; i += kThreads)
    sv[3 * N + i] = w2[(head * kMaxOut + i / N) * fp + n0 + i % N];
  const uint32_t bars = sbase + L::BASE + L::VEC_BYTES;
  float* xs = reinterpret_cast<float*>(smem + L::BASE + L::VEC_BYTES + 32);
  const uint32_t xaddr = sbase + L::BASE + L::VEC_BYTES + 32;

  const int arow = 64 * (tid / 128);
  float acc0[N0 / 2], acc1[N1 / 2];
  // Both widths' products of a chunk at once (the registers allow it here).
  mainloop<kBM, N, kStages, N0, N1, 3, true>(x, wb, npix, H, W, C, Taps{4, 2, pa - 1, pb - 1}, m0, smem, bars,
                                             arow, 0, acc0, acc1);

  int F, M, moff;
  head_sizes(sizes, head, F, M, moff);
  // z = acc + bias over the ring, which both warpgroups have finished with.
  __syncthreads();
  float* z = reinterpret_cast<float*>(smem);
  const int t4 = tid % 4, row0 = arow + quad_row();
  store_pairs(acc0, z + row0 * L::LDZ, L::LDZ, 0, t4, sv);
  store_pairs(acc1, z + row0 * L::LDZ, L::LDZ, N0, t4, sv);
  __syncwarp();  // a row's features come from the four threads of its quad
  // Each of this thread's two rows: this slice's sum of z (zero past F) and
  // squared deviations from its own mean over its real features.
  const int nr = min(max(F - n0, 0), N);
  float2 st[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* zr = z + (row0 + 8 * r) * L::LDZ + 2 * t4;
    float sum = 0.0f;
#pragma unroll 5
    for (int j = 0; j < N / 8; ++j) sum += zr[8 * j] + zr[8 * j + 1];
    st[r].x = quad_sum(sum);
    const float ml = nr > 0 ? st[r].x / nr : 0.0f;
    float sq = 0.0f;
#pragma unroll 5
    for (int j = 0; j < N / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t4;
      const float d0 = zr[8 * j] - ml, d1 = zr[8 * j + 1] - ml;
      if (n < F) sq = fmaf(d0, d0, sq);
      if (n + 1 < F) sq = fmaf(d1, d1, sq);
    }
    st[r].y = quad_sum(sq);
    if (t4 == 0) *reinterpret_cast<float2*>(xs + 2 * (row0 + 8 * r)) = st[r];
  }
  conv_tma::cluster_sync();
  float mean[2], rstd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint32_t a = xaddr + 8 * (row0 + 8 * r);
    const float2 m = combine_stats(
        [&](int k) { return k == rank ? st[r] : conv_tma::ld_peer2(conv_tma::peer_addr(a, k)); }, slices, F, N);
    mean[r] = m.x;
    rstd[r] = m.y;
  }
  // GELU and this slice's part of the projection, to xs; the LN scale and
  // bias and the projection are zero past F, the projection and b2 past M.
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const float mu = r ? mean[1] : mean[0], rs = r ? rstd[1] : rstd[0];
    const float* zr = z + (row0 + 8 * r) * L::LDZ + 2 * t4;
    float dot[kMaxOut] = {};
#pragma unroll 2
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * t4 + e;
        const float y = gelu_exact((zr[8 * j + e] - mu) * rs * sv[N + n] + sv[2 * N + n]);
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) dot[o] = fmaf(y, sv[(3 + o) * N + n], dot[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) dot[o] = quad_sum(dot[o]);
    if (t4 == 0)
      *reinterpret_cast<float4*>(xs + 2 * kBM + kMaxOut * (row0 + 8 * r)) = make_float4(dot[0], dot[1], dot[2], dot[3]);
  }
  conv_tma::cluster_sync();
  if (rank == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      float mine = 0.0f;  // thread t4 keeps output channel t4, the slices' dots in rank order
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        if (t4 != o) continue;
        const int i = 2 * kBM + kMaxOut * row + o;
        float t = xs[i];
        for (int k = 1; k < slices; ++k) t += conv_tma::ld_peer(conv_tma::peer_addr(xaddr + 4 * i, k));
        mine = t + __ldg(b2 + head * kMaxOut + o);
      }
      const int m = m0 + row;
      if (m < npix && t4 < M) out[out_pixel(m, H, W, pa, pb) * Mtot + moff + t4] = mine;
    }
  }
  conv_tma::cluster_sync();  // no CTA leaves while rank 0 reads its dots
}

// The 3xTF32 wide heads: checks and one cluster launch. sizes and mtot as
// fill_sizes gives them for F <= slices N.
template <int N>
int launch_heads_cluster(const float* x, const float* w, const float* vec, const float* w2,
                         const float* b2, float* out, const HeadSizes& sizes, int mtot, int heads,
                         int slices, int B, int H, int W, int C, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 4 || H > 32767 || W > 32767)
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  const long long tiles = (npix + kBM - 1) / kBM;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = heads_cluster_smem<N>();
  static_assert(smem <= conv_tma::kSmemLimit, "shared memory");
  cudaError_t e = allow_smem(heads_cluster_kernel<N>, smem);
  if (e != cudaSuccess) return (int)e;
  ClusterLaunch launch(dim3(4 * heads * slices, (unsigned)tiles), kThreads, smem, slices, stream);
  e = cudaLaunchKernelEx(&launch.cfg, heads_cluster_kernel<N>, x, w, vec, w2, b2, out, sizes, (int)npix, H, W,
                         C, mtot, heads);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// One pass (F <= N) on conv_tma.cuh's loop: bf16, or f32 operands at one
// TF32 product a product.
//
// A unit is one (head, phase) of a 128-pixel tile (8 rows x 16 columns of
// one image): each consumer warpgroup takes 4 of the rows by all N features
// (N0 + N1 wgmma widths), over ceil(C / KC) chunks of the phase's 2x2
// window (KC = 64 bf16 or 32 f32 channels: 128 bytes), one 9 x 17 halo box
// a chunk serving its 4 taps. In f32 a box and a B stage hold the bytes
// they hold in bf16 (half the channels), so the shared memory is the same;
// what a unit takes in doubles. That ingress bounds the f32 kernel: at the
// flagship's 256x208x384 the precise heads' 6656 units bring 9.8 GB into
// the multiprocessors (B 1.23 MB a unit, A 0.24 MB), ~1.5 ms at ~28 bytes
// a cycle an SM, above the products' 1.02 ms; at 240x192x384 the rough
// heads' 2880 units 4.1 GB (B 1.18 MB), ~0.62 ms against 0.44. The epilogue runs
// on the accumulators' registers: bias, LayerNorm over the head's F
// features (a row's features lie in its quad), GELU (rounded to bf16 where
// ROUND_Y), the projection to M <= 4 outputs, and the interleaved write;
// the producer meanwhile loads the next unit. Every head's vectors sit in
// shared memory for the block's life.

template <typename T, int N>
using HeadsLoop =
    conv_tma::Loop<8, 2, 2, N, Layout<bf16, N>::N0, Layout<bf16, N>::N1, false, 2, 6, 0, T>;

template <typename T, int N>
constexpr int heads_tma_smem() {
  return HeadsLoop<T, N>::HEAD + kMaxHeads * (3 + kMaxOut) * N * 4;
}

// x through xmap (B, H, W, C as conv_tma::make_map, boxes of HeadsLoop's
// halo); w (heads, 4 phases, 4 taps, ceil(C/KC) chunks, N/8, 8 rows, 128
// bytes of K in the 128-byte swizzle; f32 rounded to TF32); vec, w2, b2 and
// out as heads_kernel's.
template <typename T, int N, bool ROUND_Y>
__global__ void __launch_bounds__(conv_tma::kThreads, 1)
heads_tma_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ w,
                 const float* __restrict__ vec, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ out, HeadSizes sizes,
                 conv_tma::Geo g, int heads, int Mtot) {
  using L = HeadsLoop<T, N>;
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

// The one-pass heads on conv_tma.cuh's loop (F <= N), operands of type T:
// bf16, or f32 at one TF32 product a product.
template <typename T, int N, bool ROUND_Y>
int launch_heads_tma(const T* x, const T* w, const float* vec, const float* w2, const float* b2,
                     float* out, const int* F, const int* M, int heads, int B, int H, int W, int C,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(T);  // channels a 16-byte copy
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % kVec || heads <= 0 || heads > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  HeadSizes sizes;
  int mtot;
  if (!fill_sizes(F, M, heads, N, sizes, mtot)) return (int)cudaErrorInvalidValue;
  using L = HeadsLoop<T, N>;
  constexpr int smem = heads_tma_smem<T, N>();
  static_assert(smem <= conv_tma::kSmemLimit, "shared memory");
  const conv_tma::Geo g = conv_tma::make_geo(B, H, W, C, L::BH, 4 * heads, L::KC);
  if ((long long)g.tiles * g.sets >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = conv_tma::persistent_grid<heads_tma_kernel<T, N, ROUND_Y>>(
      smem, (long long)g.tiles * g.sets, &grid);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  e = conv_tma::make_map<L>(&map, x, B, H, W, C);
  if (e != cudaSuccess) return (int)e;
  heads_tma_kernel<T, N, ROUND_Y><<<grid, conv_tma::kThreads, smem, stream>>>(
      map, w, vec, w2, b2, out, sizes, g, heads, mtot);
  return (int)cudaGetLastError();
}

// The cluster form of heads_tma_kernel (heads wider than one tile; the
// slices and the exchange as heads_cluster_kernel's): a persistent grid of
// clusters of `slices` CTAs, each cluster walking units (head, phase) of a
// tile, all its CTAs the same units in the same order, CTA r the main loop
// of its slice's B (its producer reading w's slice r) and the epilogue on
// its accumulators. The producer warpgroup runs a unit ahead, so the
// consumers exchange through mbarriers and never a cluster barrier: a
// consumer thread of each quad stores its rows' partials into every peer's
// shared memory by st.async, which completes their bytes on the peer's
// mbarrier of that exchange (each slice's LayerNorm statistics; the dots to
// rank 0 only), and waits on its own. A peer's partials land in slot
// (peer - rank - 1) mod slices, so that a buffer holds slices - 1 of them.
// The statistics are double-buffered by unit parity: a peer stores unit
// i + 2's into the buffer of unit i only after it has received this CTA's
// statistics of unit i + 1 from every row, which each warp sends after
// reading unit i's. The dots need one buffer: a peer stores unit i + 1's
// only after it has received rank 0's statistics of unit i + 1, which rank
// 0 sends after reading unit i's dots. So no buffer is overwritten before it
// is read and no mbarrier phase completes before every thread has waited
// on the one before it. The cluster syncs once after the barriers are set
// and once before any CTA leaves.
constexpr int kXchgStat = 2 * (kMaxSlices - 1) * kBM;  // floats: (sum, squared deviations) a row by slot
constexpr int kXchgDot = 2 * kXchgStat;                // floats: the two statistics buffers, then kMaxOut
                                                       // dots a row by slot
constexpr int kXchgBytes = 4 * (kXchgDot + kMaxOut * (kMaxSlices - 1) * kBM);

template <typename T, int N>
constexpr int heads_cluster_tma_smem() {
  return heads_tma_smem<T, N>() + kXchgBytes + 8 * 3;  // the exchange, then its three mbarriers
}

template <typename T, int N, bool ROUND_Y>
__global__ void __launch_bounds__(conv_tma::kThreads, 1)
heads_cluster_tma_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ w,
                         const float* __restrict__ vec, const float* __restrict__ w2,
                         const float* __restrict__ b2, float* __restrict__ out, HeadSizes sizes,
                         conv_tma::Geo g, int heads, int Mtot) {
  using L = HeadsLoop<T, N>;
  constexpr int N0 = L::N0, N1 = L::N1, kV = (3 + kMaxOut) * N;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int rank = conv_tma::cluster_rank(), slices = conv_tma::cluster_size();
  const int fp = slices * N, n0 = rank * N;  // the features of a head, of this slice's first
  const uint32_t ring = conv_tma::ring_base(smem), bars = ring + L::RING;
  // Each head's bias, LN scale, LN bias (N each), then its projection
  // (kMaxOut x N), this slice's.
  float* sv = conv_tma::after_ring<L>(smem, ring);
  for (int i = tid; i < heads * kV; i += conv_tma::kThreads) {
    const int h = i / kV, j = i - h * kV, k = j / N, n = n0 + j - k * N;
    sv[i] = k < 3 ? vec[(h * 3 + k) * fp + n] : w2[(h * kMaxOut + k - 3) * fp + n];
  }
  float* xs = sv + kMaxHeads * kV;
  const uint32_t xaddr = static_cast<uint32_t>(__cvta_generic_to_shared(xs));
  const uint32_t bstat = xaddr + kXchgBytes, bdot = bstat + 16;  // the statistics' two, the dots'
  if (tid == 0) {
    conv_gemm::mbar_init(bstat, 1);
    conv_gemm::mbar_init(bstat + 8, 1);
    conv_gemm::mbar_init(bdot, 1);
  }
  conv_tma::init_bars<L>(bars);  // its fence covers the three above
  conv_tma::cluster_sync();      // every CTA's barriers are set before a peer stores to them
  const int units = g.tiles * g.sets;
  if (tid >= conv_tma::kConsumers) {
    conv_tma::producer_regs();
    auto taps_of = [](int set) {
      const int phase = set % 4;
      return Taps{4, 2, phase / 2 - 1, phase % 2 - 1};
    };
    if (tid == conv_tma::kConsumers) {
      constexpr int kElems = L::B_BYTES / (int)sizeof(T);
      conv_tma::produce<L>(&xmap, w + (long long)rank * g.sets * L::TAPS * g.chunks * kElems, g, taps_of,
                           ring, bars, conv_tma::cluster_index(), conv_tma::cluster_count());
    }
  } else {
    conv_tma::consumer_regs();
    const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32, t4 = lane % 4;
    const int row0 = 64 * wg + 16 * warp + lane / 4;  // the tile row of this thread's first
    const uint32_t peer_bytes = (uint32_t)(slices - 1) * kBM * 4;  // a float a row from each peer
    auto slot = [&](int from, int to) { return (from - to - 1 + slices) % slices; };
    float acc0[N0 / 2], acc1[N1 / 2];
    conv_tma::Cursor cur;
    uint32_t it = 0;  // this CTA's units so far: the statistics' buffer it & 1, its phase it >> 1 & 1
    for (int un = conv_tma::cluster_index(); un < units; un += conv_tma::cluster_count(), ++it) {
      const conv_tma::Unit u = conv_tma::unit_of<8>(g, un);
      const uint32_t buf = it & 1, sbar = bstat + 8 * buf;
      conv_tma::consume<L>(ring, bars, g.chunks, cur, 4 * wg, 0, acc0, acc1);
      if (tid == 0) {  // this unit's phase of each exchange: the peers' bytes
        conv_tma::mbar_expect(sbar, 2 * peer_bytes);
        if (rank == 0) conv_tma::mbar_expect(bdot, kMaxOut * peer_bytes);
      }
      const int head = u.set / 4, phase = u.set % 4, pa = phase / 2, pb = phase % 2;
      int F, M, moff;
      head_sizes(sizes, head, F, M, moff);
      const float* hv = sv + head * kV;
      // z = acc + bias; register i holds feature n0 + 8 (i / 4) + 2 t4 + i % 2
      // of row (i / 2) % 2 (counted from the slice's first, n0).
      float sum[2] = {0.0f, 0.0f};
      auto add_bias = [&](auto& a, int nb) {
#pragma unroll
        for (int i = 0; i < (int)(sizeof(a) / sizeof(float)); i += 2) {
          const float2 bias = *reinterpret_cast<const float2*>(hv + nb + 8 * (i / 4) + 2 * t4);
          a[i] += bias.x;
          a[i + 1] += bias.y;
          sum[(i >> 1) & 1] += a[i] + a[i + 1];
        }
      };
      add_bias(acc0, 0);
      add_bias(acc1, N0);
      // This slice's (sum, squared deviations from its own mean over its
      // real features) of each row, to every peer; then the statistics of
      // all slices (combine_stats).
      const int nr = min(max(F - n0, 0), N);
      float2 st[2];
      float ml[2], sq[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        st[r].x = conv_gemm::quad_sum(sum[r]);
        ml[r] = nr > 0 ? st[r].x / nr : 0.0f;
      }
      auto square = [&](auto& a, int nb) {
#pragma unroll
        for (int i = 0; i < (int)(sizeof(a) / sizeof(float)); i += 2) {
          const int n = n0 + nb + 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
          const float d0 = a[i] - ml[r], d1 = a[i + 1] - ml[r];
          sq[r] = fmaf(d0, n < F ? d0 : 0.0f, sq[r]);
          sq[r] = fmaf(d1, n + 1 < F ? d1 : 0.0f, sq[r]);
        }
      };
      square(acc0, 0);
      square(acc1, N0);
#pragma unroll
      for (int r = 0; r < 2; ++r) st[r].y = conv_gemm::quad_sum(sq[r]);
      for (int j = 0; j < slices - 1; ++j) {
        if (t4 == j) {
          const int peer = (rank + 1 + j) % slices;
          const uint32_t cbar = conv_tma::peer_addr(sbar, peer);
          const uint32_t dst = xaddr + 8 * ((buf * (kMaxSlices - 1) + slot(rank, peer)) * kBM + row0);
#pragma unroll
          for (int r = 0; r < 2; ++r) conv_tma::st_peer(conv_tma::peer_addr(dst + 8 * 8 * r, peer), st[r], cbar);
        }
      }
      conv_tma::mbar_wait_cluster(sbar, it >> 1 & 1);
      float mean[2], rstd[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2* peers = reinterpret_cast<const float2*>(xs) + buf * (kMaxSlices - 1) * kBM + row0 + 8 * r;
        const float2 m =
            combine_stats([&](int k) { return k == rank ? st[r] : peers[slot(k, rank) * kBM]; }, slices, F, N);
        mean[r] = m.x;
        rstd[r] = m.y;
      }
      // GELU and this slice's part of the projection; the LN scale and bias
      // and the projection are zero past F, the projection and b2 past M.
      float dot[2][kMaxOut] = {};
      auto project = [&](auto& a, int nb) {
#pragma unroll
        for (int i = 0; i < (int)(sizeof(a) / sizeof(float)); i += 2) {
          const int n = nb + 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
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
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) dot[r][o] = conv_gemm::quad_sum(dot[r][o]);
      if (rank != 0) {  // the dots to rank 0
        if (t4 == 0) {
          const uint32_t cbar = conv_tma::peer_addr(bdot, 0);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            conv_tma::st_peer(
                conv_tma::peer_addr(xaddr + 4 * (kXchgDot + kMaxOut * (slot(rank, 0) * kBM + row0 + 8 * r)), 0),
                make_float4(dot[r][0], dot[r][1], dot[r][2], dot[r][3]), cbar);
        }
        continue;
      }
      conv_tma::mbar_wait_cluster(bdot, it & 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mine = 0.0f;  // thread t4 keeps output channel t4, the slices' dots in rank order
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) {
          float t = dot[r][o];
          for (int k = 1; k < slices; ++k) t += xs[kXchgDot + kMaxOut * (slot(k, 0) * kBM + row0 + 8 * r) + o];
          if (t4 == o) mine = t + __ldg(b2 + head * kMaxOut + o);
        }
        const int row = row0 + 8 * r;
        const int h = u.h0 + row / conv_tma::kBW, x = u.w0 + row % conv_tma::kBW;
        if (u.b < g.B && h < g.H && x < g.W && t4 < M)
          out[(((long long)u.b * 2 * g.H + 2 * h + pa) * 2 * g.W + 2 * x + pb) * Mtot + moff + t4] =
              mine;
      }
    }
  }
  __syncwarp();
  conv_tma::cluster_sync();  // no CTA leaves while a peer may still store to it
}

// The TMA-fed wide heads: checks and one launch of a persistent grid of
// clusters. sizes and mtot as fill_sizes gives them for F <= slices N.
template <typename T, int N, bool ROUND_Y>
int launch_heads_cluster_tma(const T* x, const T* w, const float* vec, const float* w2,
                             const float* b2, float* out, const HeadSizes& sizes, int mtot, int heads,
                             int slices, int B, int H, int W, int C, cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(T);  // channels a 16-byte copy
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % kVec) return (int)cudaErrorInvalidValue;
  using L = HeadsLoop<T, N>;
  constexpr int smem = heads_cluster_tma_smem<T, N>();
  static_assert(smem <= conv_tma::kSmemLimit, "shared memory");
  const conv_tma::Geo g = conv_tma::make_geo(B, H, W, C, L::BH, 4 * heads, L::KC);
  if ((long long)g.tiles * g.sets >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t e = conv_tma::make_map<L>(&map, x, B, H, W, C);
  if (e != cudaSuccess) return (int)e;
  ClusterLaunch launch(dim3(slices), conv_tma::kThreads, smem, slices, stream);
  int clusters = 0;
  e = conv_tma::persistent_clusters<heads_cluster_tma_kernel<T, N, ROUND_Y>>(
      launch.cfg, slices, (long long)g.tiles * g.sets, &clusters);
  if (e != cudaSuccess) return (int)e;
  launch.cfg.gridDim = dim3(clusters * slices);
  e = cudaLaunchKernelEx(&launch.cfg, heads_cluster_tma_kernel<T, N, ROUND_Y>, map, w, vec, w2, b2, out,
                         sizes, g, heads, mtot);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The width of each slice for heads whose widest has F = fmax, in a library
// of tile width n and narrower slice ns: n where one tile holds them;
// else ns where ceil(fmax / n) slices of ns hold them (the base widths),
// else n.
inline int slice_width(int fmax, int ns, int n) {
  if (fmax <= n) return n;
  return (fmax + n - 1) / n * ns >= fmax ? ns : n;
}

// The C entry points' body, operands of type T (f32: PASSES TF32 products
// a product, 3 or 1; bf16): one launch. w packed for `slices` slices of
// slice_width(max F, NS, N) features (the wrapper asks the library for
// it); one slice, a tile of N: heads_kernel (3xTF32) or heads_tma_kernel;
// more: their cluster forms at that width.
template <typename T, int N, int NS, bool ROUND_Y, int PASSES>
int launch_entry(const T* x, const T* w, const float* vec, const float* w2, const float* b2, float* out,
                 const int* F, const int* M, int heads, int slices, int B, int H, int W, int C,
                 cudaStream_t stream) {
  constexpr bool kCpAsync = std::is_same<T, float>::value && PASSES == 3;  // conv_gemm.cuh's loop
  if (heads <= 0 || heads > kMaxHeads || slices <= 0 || slices > kMaxSlices) return (int)cudaErrorInvalidValue;
  int fmax = 0;
  for (int h = 0; h < heads; ++h) fmax = std::max(fmax, F[h]);
  const int width = slice_width(fmax, NS, N);
  if (fmax <= 0 || slices != (fmax + width - 1) / width) return (int)cudaErrorInvalidValue;
  if (slices == 1) {
    if constexpr (kCpAsync)
      return launch_heads<float, N, false>(x, w, vec, w2, b2, out, F, M, heads, B, H, W, C, stream);
    else
      return launch_heads_tma<T, N, ROUND_Y>(x, w, vec, w2, b2, out, F, M, heads, B, H, W, C, stream);
  }
  HeadSizes sizes;
  int mtot;
  if (!fill_sizes(F, M, heads, slices * width, sizes, mtot)) return (int)cudaErrorInvalidValue;
  if constexpr (kCpAsync) {
    if (width == NS)
      return launch_heads_cluster<NS>(x, w, vec, w2, b2, out, sizes, mtot, heads, slices, B, H, W, C, stream);
    return launch_heads_cluster<N>(x, w, vec, w2, b2, out, sizes, mtot, heads, slices, B, H, W, C, stream);
  } else {
    if (width == NS)
      return launch_heads_cluster_tma<T, NS, ROUND_Y>(x, w, vec, w2, b2, out, sizes, mtot, heads, slices, B, H,
                                                      W, C, stream);
    return launch_heads_cluster_tma<T, N, ROUND_Y>(x, w, vec, w2, b2, out, sizes, mtot, heads, slices, B, H, W,
                                                   C, stream);
  }
}

}  // namespace fpn_head
