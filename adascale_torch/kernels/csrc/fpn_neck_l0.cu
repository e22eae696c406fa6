// The FPN neck's level-0 chain for Hopper (sm_90a), NHWC, f32 or bf16:
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
// matmul_precision "default" / "high": the entry fpn_neck_l0_tf32, one TF32
// product a product, a third of the products: 0.069 ms at 240x192 at 495
// TFLOP/s. Where each step's features fit its tile (the flagship's), both
// steps run the bf16 entry's persistent, TMA-fed kernels below at T = float
// (neck_step1_tma_kernel, neck_step2_tma_kernel): f0 and t by TMA in halo
// boxes of 32 channels, rounded to TF32 in registers after ldmatrix; W1 and
// W2 rounded to TF32 and packed once (packing.pack_sw128_tf32), W1 resident
// in shared memory for C0 <= 96. That replaced the split-free launches
// below at one pass (A copied once a tap and rounded on each use, each
// 32-deep chunk a fresh register tile, the epilogue read back through
// shared memory, all of W2's hi and lo through L2 for every 128-pixel
// tile). What bounds the TF32 steps now is bytes: step1's memory
// traffic and step2's ingress into the multiprocessors (below).
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
//
// Wider necks (the base and large backbones: Cm 512 / 768, Co 128 / 192;
// any Cm <= 1536 and Co <= 384) run each step in one launch with no
// workspace and no second pass:
//   * step1 (Cm > kMid): a thread-block cluster a 64-pixel tile, CTA r the
//     slice of Cm from r NS, NS chosen so that the slices pad least (the
//     base widths 2 x 256; large 2 x 384 in bf16 and 3xTF32, 4 x 192 in
//     TF32, whose 384-wide W1 would not fit in shared memory). Each CTA
//     computes its slice's sums, adds the bias, and takes its slice's row
//     sum and squared deviations from its own mean over its real features;
//     the slices' statistics cross the cluster through distributed shared
//     memory and are combined in rank order (conv_tma::combine_stats), so
//     every CTA holds the same mean and rstd bit for bit; then each applies
//     the GELU, adds u and writes its own slice of t. bf16 and TF32 on
//     conv_tma.cuh's persistent loop (neck_step1_cluster_tma_kernel, W1's
//     slice resident in shared memory where it fits: C0 <= 320 / 192 in
//     bf16 at NS 256 / 384, 224 / 160 in TF32 at 192 / 256; else bf16
//     streams it through the B ring, and TF32 takes the 3xTF32 kernel at
//     one pass), the statistics by st.async onto the peer's mbarrier
//     (conv_tma::StatExchange); 3xTF32 on conv_gemm.cuh's loop
//     (neck_step1_cluster_kernel, slices of 256 or 384), a cluster barrier
//     and ld.shared::cluster.
//   * step2 (Co > kNB): one CTA a 128-pixel tile with every Co feature, N =
//     128 (Co <= 128) or 192, two accumulator chains of N / 2 (a thread
//     holds 64 or 96 sums); Co > 192 takes a cluster of two 192-wide
//     slices sharing the statistics as step1's. bf16 and TF32:
//     neck_step2_wide_tma_kernel (one 10 x 18 halo box of t a chunk for
//     the nine taps, W2 through a ring of 9 / 7 stages); 3xTF32:
//     neck_step2_wide_kernel on conv_gemm.cuh's loop, one CTA a
//     multiprocessor. The flagship's widths keep the one-pass kernels.
//
// bf16 (the JAX package's compute_dtype="bfloat16", as the Pallas kernel
// computes it): f0, u and the packed W1, W2 in bf16, products accumulated
// in f32, bias, LayerNorm, GELU and + u in f32; t rounded to bf16 before
// the 3x3 (fpn_neck.py:98), z0 written in bf16. Every bf16 step runs on
// conv_tma.cuh's persistent, TMA-fed loop. One bf16 product a product:
// 0.034 ms at 240x192 (0.040 ms at 256x208) at 989 TFLOP/s dense bf16. The
// TF32 entry shares its kernels at T = float.
//
// The route of each step, by precision and width, is plan_neck's (the
// wrapper packs the weights for it, kernels/fpn_neck.py::plan).

#include <cuda_runtime.h>

#include <initializer_list>

#include "conv_gemm.cuh"
#include "conv_tma.cuh"

namespace {

using namespace conv_gemm;

constexpr int kMid = 384;  // step1's features a block (one slice)
constexpr int kNB = 96;    // step2's features a block (one slice), one wgmma
constexpr int kMaxMid = 1536, kMaxOut = 384;  // the widest Cm and Co
constexpr int kBM1 = 64, kBM2 = 128;  // pixels a block
using R1 = Ring<kBM1, kMid, 2>;
using R2 = Ring<kBM2, kNB, 2>;
constexpr int kLdz1 = ldz(kMid), kLdz2 = ldz(kNB);
constexpr int max_int(int a, int b) { return a > b ? a : b; }
// The ring (or the epilogue tile over it, where larger), then the bias, LN
// scale and LN bias, then the mbarriers.
constexpr int kBase1 = max_int(R1::BYTES, kBM1 * kLdz1 * 4);
constexpr int kBase2 = max_int(R2::BYTES, kBM2 * kLdz2 * 4);
constexpr size_t kSmem1 = (size_t)kBase1 + 3 * kMid * 4 + 16;
constexpr size_t kSmem2 = (size_t)kBase2 + 3 * kNB * 4 + 16;
static_assert(kBase1 == R1::BYTES && kBase2 == R2::BYTES, "epilogue tile");
static_assert(kSmem1 <= 232448 && 2 * (kSmem2 + 1024) <= 233472, "shared memory");

// f0 (B, H, W, C0); w1 (1 tap, ceil(C0/32) chunks, 2 parts, kMid/8, 8, 8,
// 16 bytes of K) and vec1 (3, kMid): b1, LN scale, LN bias, zero past Cm;
// u and t (B, H, W, Cm). PASSES: TF32 products a product (conv_gemm.cuh's
// mainloop: 3, or 1 for matmul_precision "default" / "high").
template <int PASSES>
__global__ void __launch_bounds__(kThreads, 1)
neck_step1_kernel(const float* __restrict__ f0, const float* __restrict__ w1,
                  const float* __restrict__ vec1, const float* __restrict__ u,
                  float* __restrict__ t, int npix, int H, int W, int C0, int Cm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM1;
  float* sv = reinterpret_cast<float*>(smem + kBase1);
  for (int i = tid; i < 3 * kMid; i += kThreads) sv[i] = vec1[i];
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + kBase1 + 3 * kMid * 4;

  // Warpgroup wg: all 64 rows, features 192 wg .. 192 wg + 191.
  const int nb0 = (kMid / 2) * (tid / 128);
  float acc0[48], acc1[48];
  mainloop<kBM1, kMid, 2, 96, 96, PASSES>(f0, w1, npix, H, W, C0, Taps{1, 1, 0, 0}, m0, smem, bars, 0, nb0,
                                          acc0, acc1);
  const int t4 = tid % 4;
  __syncthreads();  // both warpgroups are done with the ring
  float* z = reinterpret_cast<float*>(smem);
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
      if (8 * (j0 + j) + 2 * t4 < Cm) uv[j] = load_pair(ur + 8 * (j0 + j));
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int n = 8 * (j0 + j) + 2 * t4;
      if (n < Cm) {
        const float y0 =
            gelu_exact((zr[8 * (j0 + j)] - mean) * rstd * sv[kMid + n] + sv[2 * kMid + n]);
        const float y1 = gelu_exact((zr[8 * (j0 + j) + 1] - mean) * rstd * sv[kMid + n + 1] +
                                    sv[2 * kMid + n + 1]);
        store_pair(tr + 8 * (j0 + j), y0 + uv[j].x, y1 + uv[j].y);
      }
    }
  }
}

// t (B, H, W, Cm); w2 (9 taps, ceil(Cm/32) chunks, 2 parts, kNB/8, 8, 8,
// 16 bytes of K) and vec2 (3, kNB): b2, LN scale, LN bias, zero past Co;
// out (B, H, W, Co). PASSES as step1's.
template <int PASSES>
__global__ void __launch_bounds__(kThreads, 2)
neck_step2_kernel(const float* __restrict__ t, const float* __restrict__ w2,
                  const float* __restrict__ vec2, float* __restrict__ out, int npix, int H, int W,
                  int Cm, int Co) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM2;
  float* sv = reinterpret_cast<float*>(smem + kBase2);
  for (int i = tid; i < 3 * kNB; i += kThreads) sv[i] = vec2[i];
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + kBase2 + 3 * kNB * 4;

  // Warpgroup wg: rows 64 wg .. 64 wg + 63, all features. Tap t reads
  // source pixel (i - 1 + t / 3, j - 1 + t % 3).
  const int arow = 64 * (tid / 128);
  float acc[kNB / 2], none[1];
  mainloop<kBM2, kNB, 2, kNB, 0, PASSES>(t, w2, npix, H, W, Cm, Taps{9, 3, -1, -1}, m0, smem, bars, arow, 0,
                                         acc, none);
  const int t4 = tid % 4, row0 = arow + quad_row();
  __syncthreads();  // both warpgroups are done with the ring
  float* z = reinterpret_cast<float*>(smem);
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
          store_one(orow + n,
                    gelu_exact((zr[8 * j + e] - mean) * rstd * sv[kNB + n] + sv[2 * kNB + n]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The wide 3xTF32 steps (and TF32 step1 past its resident W1) on
// conv_gemm.cuh's loop: clusters of `slices` CTAs along x, CTA r of cluster
// x the slice of features from r NS of pixel tile x. All 256 threads are
// consumers, so the statistics cross the cluster at a cluster barrier: each
// CTA writes its rows' (sum, squared deviations) to its own shared memory,
// the cluster syncs, and each reads its peers' by ld.shared::cluster. The
// epilogues read the tile back from shared memory, as the one-pass
// kernels' do.

// A row's statistics over one slice, held by a quad (thread t4 reads zr[8
// j] and zr[8 j + 1] for j < NS / 8; the row is zero past F): the slice's
// sum and its squared deviations from its own mean over its real features,
// feature n0 + n counting while it is below F.
template <int NS>
__device__ __forceinline__ float2 slice_stats(const float* zr, int t4, int n0, int F) {
  const int nr = min(max(F - n0, 0), NS);
  float sum = 0.0f;
#pragma unroll 4
  for (int j = 0; j < NS / 8; ++j) sum += zr[8 * j] + zr[8 * j + 1];
  sum = quad_sum(sum);
  const float ml = nr > 0 ? sum / nr : 0.0f;
  float sq = 0.0f;
#pragma unroll 4
  for (int j = 0; j < NS / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t4;
    const float d0 = zr[8 * j] - ml, d1 = zr[8 * j + 1] - ml;
    if (n < F) sq = fmaf(d0, d0, sq);
    if (n + 1 < F) sq = fmaf(d1, d1, sq);
  }
  return make_float2(sum, quad_sum(sq));
}

// The row's (mean, rstd) over F features in `slices` slices of NS, from
// this CTA's st and each peer's at the same shared address xaddr.
template <int NS>
__device__ __forceinline__ float2 cluster_stats(float2 st, uint32_t xaddr, int F) {
  const int rank = conv_tma::cluster_rank(), slices = conv_tma::cluster_size();
  return conv_tma::combine_stats(
      [&](int k) { return k == rank ? st : conv_tma::ld_peer2(conv_tma::peer_addr(xaddr, k)); }, slices, F, NS);
}

template <int NS>
constexpr int kStagesC1 = NS == 256 ? 3 : 2;  // the ring's stages at a step1 slice of NS
template <int NS>
constexpr int kBaseC1 = max_int(Ring<kBM1, NS, kStagesC1<NS>>::BYTES, kBM1 * ldz(NS) * 4);
// The ring or the tile, the slice's vectors, the mbarriers, then the rows'
// statistics (a float2 a row).
template <int NS>
constexpr size_t kSmemC1 = (size_t)kBaseC1<NS> + 3 * NS * 4 + 32 + 8 * kBM1;
template <int N>
constexpr int kBaseW2 = max_int(Ring<kBM2, N, 3>::BYTES, kBM2 * ldz(N) * 4);
template <int N>
constexpr size_t kSmemW2 = (size_t)kBaseW2<N> + 3 * N * 4 + 32 + 8 * kBM2;
static_assert(kSmemC1<256> <= conv_tma::kSmemLimit && kSmemC1<384> <= conv_tma::kSmemLimit &&
                  kSmemW2<128> <= conv_tma::kSmemLimit && kSmemW2<192> <= conv_tma::kSmemLimit,
              "shared memory");

// f0 (B, H, W, C0); w1 (slices, 1 tap, ceil(C0/32) chunks, 2 parts, NS/8,
// 8, 8, 16 bytes of K) and vec1 (3, slices NS), zero past Cm; u and t (B,
// H, W, Cm). Block x: slice x % slices of tile x / slices. PASSES 3 (both
// wgmma widths of a chunk at once) or 1.
template <int NS, int PASSES>
__global__ void __launch_bounds__(kThreads, 1)
neck_step1_cluster_kernel(const float* __restrict__ f0, const float* __restrict__ w1,
                          const float* __restrict__ vec1, const float* __restrict__ u,
                          float* __restrict__ t, int npix, int H, int W, int C0, int Cm) {
  constexpr int LDZ = ldz(NS), NQ = NS / 4;  // a warpgroup's two widths
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int rank = conv_tma::cluster_rank(), slices = conv_tma::cluster_size();
  const int m0 = (blockIdx.x / slices) * kBM1, n0 = rank * NS;
  float* sv = reinterpret_cast<float*>(smem + kBaseC1<NS>);
  for (int i = tid; i < 3 * NS; i += kThreads) sv[i] = vec1[(i / NS) * slices * NS + n0 + i % NS];
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + kBaseC1<NS> + 3 * NS * 4;
  float2* xs = reinterpret_cast<float2*>(smem + kBaseC1<NS> + 3 * NS * 4 + 32);

  // Warpgroup wg: all 64 rows, features NS / 2 wg .. of the slice.
  const int nb0 = (NS / 2) * (tid / 128);
  const int chunks = (C0 + kKC - 1) / kKC;
  float acc0[NQ / 2], acc1[NQ / 2];
  mainloop<kBM1, NS, kStagesC1<NS>, NQ, NQ, PASSES, PASSES == 3>(
      f0, w1 + (long long)rank * chunks * 2 * NS * kKC, npix, H, W, C0, Taps{1, 1, 0, 0}, m0, smem, bars, 0, nb0,
      acc0, acc1);
  const int t4 = tid % 4;
  __syncthreads();  // both warpgroups are done with the ring
  float* z = reinterpret_cast<float*>(smem);
  store_pairs(acc0, z + quad_row() * LDZ, LDZ, nb0, t4, sv);
  store_pairs(acc1, z + quad_row() * LDZ, LDZ, nb0 + NQ, t4, sv);
  __syncthreads();  // a row's features come from both warpgroups

  // Quad tid / 4 owns row tid / 4.
  const int r = tid / 4, m = m0 + r;
  const float* zr = z + r * LDZ + 2 * t4;
  const float2 st = slice_stats<NS>(zr, t4, n0, Cm);
  if (t4 == 0) xs[r] = st;
  conv_tma::cluster_sync();
  const float2 mr = cluster_stats<NS>(st, static_cast<uint32_t>(__cvta_generic_to_shared(xs + r)), Cm);
  if (m < npix) {
    const float* ur = u + (long long)m * Cm + n0 + 2 * t4;
    float* tr = t + (long long)m * Cm + n0 + 2 * t4;
    constexpr int kBatch = NS / 32;  // pairs whose u loads go together
#pragma unroll 1
    for (int j0 = 0; j0 < NS / 8; j0 += kBatch) {
      float2 uv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)  // Cm % 4 == 0: a pair is all in or all out
        if (n0 + 8 * (j0 + j) + 2 * t4 < Cm) uv[j] = load_pair(ur + 8 * (j0 + j));
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int n = 8 * (j0 + j) + 2 * t4;
        if (n0 + n < Cm) {
          const float y0 = gelu_exact((zr[8 * (j0 + j)] - mr.x) * mr.y * sv[NS + n] + sv[2 * NS + n]);
          const float y1 =
              gelu_exact((zr[8 * (j0 + j) + 1] - mr.x) * mr.y * sv[NS + n + 1] + sv[2 * NS + n + 1]);
          store_pair(tr + 8 * (j0 + j), y0 + uv[j].x, y1 + uv[j].y);
        }
      }
    }
  }
  conv_tma::cluster_sync();  // no CTA leaves while a peer reads its statistics
}

// t (B, H, W, Cm); w2 (slices, 9 taps, ceil(Cm/32) chunks, 2 parts, N/8,
// 8, 8, 16 bytes of K) and vec2 (3, slices N), zero past Co; out (B, H, W,
// Co). Block x: slice x % slices of the 128-pixel tile x / slices, every
// feature of the slice (N / 2 + N / 2 wgmma widths, both products of a
// chunk at once); 3xTF32.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
neck_step2_wide_kernel(const float* __restrict__ t, const float* __restrict__ w2,
                       const float* __restrict__ vec2, float* __restrict__ out, int npix, int H, int W,
                       int Cm, int Co) {
  constexpr int LDZ = ldz(N), NH = N / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int rank = conv_tma::cluster_rank(), slices = conv_tma::cluster_size();
  const int m0 = (blockIdx.x / slices) * kBM2, n0 = rank * N;
  float* sv = reinterpret_cast<float*>(smem + kBaseW2<N>);
  for (int i = tid; i < 3 * N; i += kThreads) sv[i] = vec2[(i / N) * slices * N + n0 + i % N];
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + kBaseW2<N> + 3 * N * 4;
  float2* xs = reinterpret_cast<float2*>(smem + kBaseW2<N> + 3 * N * 4 + 32);

  const int arow = 64 * (tid / 128);
  const int chunks = (Cm + kKC - 1) / kKC;
  float acc0[NH / 2], acc1[NH / 2];
  mainloop<kBM2, N, 3, NH, NH, 3, true>(t, w2 + (long long)rank * 9 * chunks * 2 * N * kKC, npix, H, W, Cm,
                                        Taps{9, 3, -1, -1}, m0, smem, bars, arow, 0, acc0, acc1);
  const int t4 = tid % 4, row0 = arow + quad_row();
  __syncthreads();  // both warpgroups are done with the ring
  float* z = reinterpret_cast<float*>(smem);
  store_pairs(acc0, z + row0 * LDZ, LDZ, 0, t4, sv);
  store_pairs(acc1, z + row0 * LDZ, LDZ, NH, t4, sv);
  __syncwarp();  // a row's features come from the four threads of its quad
  float2 st[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st[r] = slice_stats<N>(z + (row0 + 8 * r) * LDZ + 2 * t4, t4, n0, Co);
    if (t4 == 0) xs[row0 + 8 * r] = st[r];
  }
  if (slices > 1) conv_tma::cluster_sync();
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + row0 + 8 * r;
    const float2 mr =
        cluster_stats<N>(st[r], static_cast<uint32_t>(__cvta_generic_to_shared(xs + row0 + 8 * r)), Co);
    if (m >= npix) continue;
    const float* zr = z + (row0 + 8 * r) * LDZ + 2 * t4;
    float* orow = out + (long long)m * Co + n0;
#pragma unroll 4
    for (int j = 0; j < N / 8; ++j) {
      const int n = 8 * j + 2 * t4;
      if (n0 + n < Co)  // Co % 4 == 0: a pair is all in or all out
        store_pair(orow + n, gelu_exact((zr[8 * j] - mr.x) * mr.y * sv[N + n] + sv[2 * N + n]),
                   gelu_exact((zr[8 * j + 1] - mr.x) * mr.y * sv[N + n + 1] + sv[2 * N + n + 1]));
    }
  }
  if (slices > 1) conv_tma::cluster_sync();  // no CTA leaves while a peer reads its statistics
}

// ---------------------------------------------------------------------------
// One pass (Cm <= kMid, Co <= kNB) on conv_tma.cuh's loop, persistent, t
// through device memory, operands of type T: bf16, or f32 at one TF32
// product a product (the TF32 entry).
//   * step1: a unit is a 64-pixel tile (4 rows x 16 columns); both consumer
//     warpgroups hold its 64 rows, each half of the kMid features. W1
//     (kW1Chunks chunks of kMid x 128 bytes, 144 KB: C0 <= kMaxC0<T>, 192
//     bf16 or 96 f32 channels) is brought once and stays in shared memory;
//     the A ring streams the tile's chunks. The epilogue on the registers:
//     bias, the LayerNorm's two sums over a row (each warpgroup's half
//     through shared memory), GELU, + u -> t. In bf16 the unit's u (48
//     registers of pairs) is read before its products, so its latency hides
//     behind them. In f32 it would be 96 registers beside the 96
//     accumulators, over the 168 a thread of a 384-thread block gets, so:
//     one lane a tile row asks for the unit's u to be brought into L2 (a
//     bulk prefetch) before the products; the GELUs are taken in place in
//     the accumulators; u then comes in four batches of 12 pairs, each
//     batch's loads issued together (the first before the LayerNorm's
//     sums), added and stored. On an H100 at 240x192 step1 took 0.125 ms
//     with the GELUs computed beside u's batch (256 bytes of spills) and
//     0.102 in place (36 bytes); the in-place form without the prefetch
//     took 0.142. t is written unrounded in f32: step2 rounds it where it
//     reads it.
//   * step2: a unit is a 128-pixel tile (8 rows x 16 columns), a warpgroup
//     each 64 rows by all kNB features, K = ceil(Cm / KC) chunks of the
//     3x3 (KC: 64 bf16 or 32 f32 channels, a 128-byte row), one 10 x 18
//     halo box a chunk serving its 9 taps (in f32 each tap's rows rounded to
//     TF32 after their ldmatrix), W2 through a ring of 8 stages (in f32
//     rounded to TF32 and packed once, packing.pack_sw128_tf32), the
//     features as one 96-wide wgmma (bf16) or two 48-wide ones (f32, kN2);
//     the epilogue: bias, LayerNorm, GELU -> out.
// What bounds the f32 steps on an H100 is the bytes: step1's f0, u and t
// (159 MB at 240x192, ~48 us at 3.35 TB/s), and what step2's
// multiprocessors take in, W2 for every tile (1.33 MB in f32) and 12 halo
// boxes of 23 KB (0.58 GB at 240x192, ~88 us at ~28 bytes a cycle an SM,
// above its products' 62 us at 495 TFLOP/s). In f32 a step1 with C0 >
// kMaxC0<float> and Cm <= kMid (no model of the repo has one) keeps
// conv_gemm.cuh's neck_step1_kernel at one pass, its W1 packed as that
// kernel reads it (kernels/fpn_neck.py::pack_neck); in bf16 it is refused.

constexpr int kW1Chunks = 3;  // step1's chunks of W1 held in shared memory
template <typename T>
using Neck1Loop = conv_tma::Loop<4, 1, 1, kMid, 96, 96, true, 4, 2, kW1Chunks, T>;
// step2's wgmma widths: bf16 one 96-wide product a K step; f32 two 48-wide
// ones on two accumulators, with which ptxas keeps the wgmmas in flight
// (one 96-wide accumulator chain had them serialised, C7513, and step2
// took 0.154 against 0.133 ms at 240x192 on an H100).
template <typename T>
constexpr int kN2 = std::is_same<T, float>::value ? kNB / 2 : kNB;
template <typename T>
using Neck2Loop = conv_tma::Loop<8, 3, 3, kNB, kN2<T>, kNB - kN2<T>, false, 2, 8, 0, T>;
// step1's widest input held in shared memory: 192 bf16 or 96 f32 channels.
template <typename T>
constexpr int kMaxC0 = kW1Chunks * Neck1Loop<T>::KC;
template <typename T>
constexpr int kNeck1Smem = Neck1Loop<T>::HEAD + 3 * kMid * 4 + 2 * 2 * 64 * 4;
template <typename T>
constexpr int kNeck2Smem = Neck2Loop<T>::HEAD + 3 * kNB * 4;
static_assert(kNeck1Smem<bf16> <= conv_tma::kSmemLimit && kNeck2Smem<bf16> <= conv_tma::kSmemLimit &&
                  kNeck1Smem<float> <= conv_tma::kSmemLimit && kNeck2Smem<float> <= conv_tma::kSmemLimit,
              "shared memory");

// The flattened pixel of tile row `row` of unit u, or -1 past the map.
__device__ __forceinline__ long long tile_pixel(const conv_tma::Geo& g, const conv_tma::Unit& u,
                                                int row) {
  const int h = u.h0 + row / conv_tma::kBW, x = u.w0 + row % conv_tma::kBW;
  if (u.b >= g.B || h >= g.H || x >= g.W) return -1;
  return ((long long)u.b * g.H + h) * g.W + x;
}

// f0 through fmap (B, H, W, C0, boxes of 16 x 4); w1 (1 tap, ceil(C0/KC)
// chunks, kMid/8, 8 rows, 128 bytes of K in the 128-byte swizzle; f32
// rounded to TF32); vec1 (3, kMid); u and t (B, H, W, Cm).
template <typename T>
__global__ void __launch_bounds__(conv_tma::kThreads, 1)
neck_step1_tma_kernel(const __grid_constant__ CUtensorMap fmap, const T* __restrict__ w1,
                      const float* __restrict__ vec1, const T* __restrict__ u,
                      T* __restrict__ t, int Cm, conv_tma::Geo g) {
  using L = Neck1Loop<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t ring = conv_tma::ring_base(smem), bars = ring + L::RING;
  float* sv = conv_tma::after_ring<L>(smem, ring);
  float* red = sv + 3 * kMid;  // (2 sums, 2 warpgroups, 64 rows)
  for (int i = tid; i < 3 * kMid; i += conv_tma::kThreads) sv[i] = vec1[i];
  conv_tma::init_bars<L>(bars);
  __syncthreads();
  if (tid >= conv_tma::kConsumers) {
    conv_tma::producer_regs();
    if (tid == conv_tma::kConsumers)
      conv_tma::produce<L>(&fmap, w1, g, [](int) { return Taps{1, 1, 0, 0}; }, ring, bars);
    return;
  }
  conv_tma::consumer_regs();
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32, t4 = lane % 4;
  const int nb0 = (kMid / 2) * wg, row0 = 16 * warp + lane / 4;
  const float inv_f = 1.0f / Cm;
  float acc0[48], acc1[48];
  uint32_t uv[2][24];  // bf16: the unit's u, as bf16 pairs in the accumulators' order
  float2 ub[12];       // f32: a batch of u, 12 pairs in the accumulators' order
  conv_tma::Cursor cur;
  mbar_wait(L::resident(bars), 0);
  for (int un = blockIdx.x; un < g.tiles; un += gridDim.x) {
    const conv_tma::Unit tile = conv_tma::unit_of<4>(g, un);
    const long long pix[2] = {tile_pixel(g, tile, row0), tile_pixel(g, tile, row0 + 8)};
    if constexpr (kF32) {
      // The tile's u into L2, a tile row (warp) at a time, while the
      // products run.
      if (wg == 0 && lane == 0 && tile.b < g.B && tile.h0 + warp < g.H)
        conv_tma::prefetch_l2(u + (((long long)tile.b * g.H + tile.h0 + warp) * g.W + tile.w0) * Cm,
                              (uint32_t)min(conv_tma::kBW, g.W - tile.w0) * Cm * sizeof(T));
    } else {
      // u of rows past the map and features past Cm: any valid pair, unused.
#pragma unroll
      for (int i = 0; i < 96; i += 2) {
        const int n = nb0 + 96 * (i / 48) + 8 * (i % 48 / 4) + 2 * t4, r = (i >> 1) & 1;
        const long long at = (pix[r] < 0 ? 0 : pix[r]) * Cm + (n < Cm ? n : 0);
        uv[i / 48][i % 48 / 2] = __ldg(reinterpret_cast<const unsigned*>(u + at));
      }
    }
    // f32: batch k of u (registers 24 (k % 2) .. + 23 of accumulator k / 2)
    // into ub, its loads issued together; for rows past the map and
    // features past Cm any valid pair, unused.
    const T* urow[2] = {u + (pix[0] < 0 ? 0 : pix[0]) * Cm, u + (pix[1] < 0 ? 0 : pix[1]) * Cm};
    auto load_batch = [&](int k) {
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int i = 24 * (k % 2) + 2 * j;
        const int n = nb0 + 96 * (k / 2) + 8 * (i / 4) + 2 * t4;
        ub[j] = __ldg(reinterpret_cast<const float2*>(urow[(i >> 1) & 1] + (n < Cm ? n : 0)));
      }
    };
    conv_tma::consume<L>(ring, bars, g.chunks, cur, 0, nb0, acc0, acc1);
    if constexpr (kF32) load_batch(0);
    float part[2] = {0.0f, 0.0f};
    auto add_bias = [&](float(&a)[48], int n0) {
#pragma unroll
      for (int i = 0; i < 48; i += 2) {
        const float2 bias = *reinterpret_cast<const float2*>(sv + n0 + 8 * (i / 4) + 2 * t4);
        a[i] += bias.x;
        a[i + 1] += bias.y;
        part[(i >> 1) & 1] += a[i] + a[i + 1];
      }
    };
    add_bias(acc0, nb0);
    add_bias(acc1, nb0 + 96);
    // A row's sums: its quad's, then the two warpgroups' halves in order.
    auto row_sums = [&](int which, float(&v)[2]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float q = quad_sum(v[r]);
        if (t4 == 0) red[(which * 2 + wg) * 64 + row0 + 8 * r] = q;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(conv_tma::kConsumers) : "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r)
        v[r] = red[(which * 2) * 64 + row0 + 8 * r] + red[(which * 2 + 1) * 64 + row0 + 8 * r];
    };
    row_sums(0, part);
    float mean[2] = {part[0] * inv_f, part[1] * inv_f}, sq[2] = {0.0f, 0.0f};
    auto square = [&](float(&a)[48], int n0) {
#pragma unroll
      for (int i = 0; i < 48; i += 2) {
        const int n = n0 + 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
        const float d0 = a[i] - mean[r], d1 = a[i + 1] - mean[r];
        sq[r] = fmaf(d0, n < Cm ? d0 : 0.0f, sq[r]);
        sq[r] = fmaf(d1, n + 1 < Cm ? d1 : 0.0f, sq[r]);
      }
    };
    square(acc0, nb0);
    square(acc1, nb0 + 96);
    row_sums(1, sq);
    const float rstd[2] = {rsqrtf(sq[0] * inv_f + kEps), rsqrtf(sq[1] * inv_f + kEps)};
    if constexpr (kF32) {
      // The GELUs first, in place, so that fewer registers are live beside
      // u's batch; then u's batches, added and stored.
      auto in_place = [&](float(&a)[48], int n0) {
#pragma unroll
        for (int i = 0; i < 48; i += 2) {
          const int n = n0 + 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
          const float2 ga = *reinterpret_cast<const float2*>(sv + kMid + n);
          const float2 be = *reinterpret_cast<const float2*>(sv + 2 * kMid + n);
          a[i] = gelu_exact((a[i] - mean[r]) * rstd[r] * ga.x + be.x);
          a[i + 1] = gelu_exact((a[i + 1] - mean[r]) * rstd[r] * ga.y + be.y);
        }
      };
      in_place(acc0, nb0);
      in_place(acc1, nb0 + 96);
      // Registers 24 (k % 2) .. + 23 of a (features from n0) + u's batch k.
      auto add_store = [&](float(&a)[48], int n0, int k) {
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const int i = 24 * (k % 2) + 2 * j;
          const int n = n0 + 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
          // Cm % 4 == 0: a pair is all in or all out.
          if (pix[r] >= 0 && n < Cm) store_pair(t + pix[r] * Cm + n, a[i] + ub[j].x, a[i + 1] + ub[j].y);
        }
      };
      add_store(acc0, nb0, 0);
      load_batch(1);
      add_store(acc0, nb0, 1);
      load_batch(2);
      add_store(acc1, nb0 + 96, 2);
      load_batch(3);
      add_store(acc1, nb0 + 96, 3);
    } else {
      auto store = [&](float(&a)[48], const uint32_t(&ua)[24], int n0) {
#pragma unroll
        for (int i = 0; i < 48; i += 2) {
          const int n = n0 + 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
          const float2 ga = *reinterpret_cast<const float2*>(sv + kMid + n);
          const float2 be = *reinterpret_cast<const float2*>(sv + 2 * kMid + n);
          const float2 up = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ua[i / 2]));
          const float y0 = gelu_exact((a[i] - mean[r]) * rstd[r] * ga.x + be.x) + up.x;
          const float y1 = gelu_exact((a[i + 1] - mean[r]) * rstd[r] * ga.y + be.y) + up.y;
          // Cm % 8 == 0: a pair is all in or all out.
          if (pix[r] >= 0 && n < Cm) store_pair(t + pix[r] * Cm + n, y0, y1);
        }
      };
      store(acc0, uv[0], nb0);
      store(acc1, uv[1], nb0 + 96);
    }
  }
}

// t through tmap (B, H, W, Cm, boxes of 18 x 10); w2 (9 taps, ceil(Cm/KC)
// chunks, kNB/8, 8 rows, 128 bytes of K in the 128-byte swizzle; f32
// rounded to TF32); vec2 (3, kNB); out (B, H, W, Co).
template <typename T>
__global__ void __launch_bounds__(conv_tma::kThreads, 1)
neck_step2_tma_kernel(const __grid_constant__ CUtensorMap tmap, const T* __restrict__ w2,
                      const float* __restrict__ vec2, T* __restrict__ out, int Co,
                      conv_tma::Geo g) {
  using L = Neck2Loop<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t ring = conv_tma::ring_base(smem), bars = ring + L::RING;
  float* sv = conv_tma::after_ring<L>(smem, ring);
  for (int i = tid; i < 3 * kNB; i += conv_tma::kThreads) sv[i] = vec2[i];
  conv_tma::init_bars<L>(bars);
  __syncthreads();
  if (tid >= conv_tma::kConsumers) {
    conv_tma::producer_regs();
    if (tid == conv_tma::kConsumers)
      conv_tma::produce<L>(&tmap, w2, g, [](int) { return Taps{9, 3, -1, -1}; }, ring, bars);
    return;
  }
  conv_tma::consumer_regs();
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32, t4 = lane % 4;
  const int row0 = 64 * wg + 16 * warp + lane / 4;
  const float inv_f = 1.0f / Co;
  constexpr int K0 = L::N0 / 2, K1 = L::N1 > 0 ? L::N1 / 2 : 1;
  float acc0[K0], acc1[K1];
  conv_tma::Cursor cur;
  for (int un = blockIdx.x; un < g.tiles; un += gridDim.x) {
    const conv_tma::Unit tile = conv_tma::unit_of<8>(g, un);
    conv_tma::consume<L>(ring, bars, g.chunks, cur, 4 * wg, 0, acc0, acc1);
    // Register i of an accumulator from feature n0 holds feature n0 + 8 (i /
    // 4) + 2 t4 + i % 2 of row (i / 2) % 2; `each` runs f over both
    // accumulators' pairs.
    auto each = [&](auto f) {
      auto pairs = [&](auto& a, int n0) {
#pragma unroll
        for (int i = 0; i < (int)(sizeof(a) / sizeof(float)); i += 2)
          f(a, i, n0 + 8 * (i / 4) + 2 * t4, (i >> 1) & 1);
      };
      pairs(acc0, 0);
      if constexpr (L::N1 > 0) pairs(acc1, L::N0);
    };
    float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
    each([&](auto& a, int i, int n, int r) {
      const float2 bias = *reinterpret_cast<const float2*>(sv + n);
      a[i] += bias.x;
      a[i + 1] += bias.y;
      sum[r] += a[i] + a[i + 1];
    });
    const float mean[2] = {quad_sum(sum[0]) * inv_f, quad_sum(sum[1]) * inv_f};
    each([&](auto& a, int i, int n, int r) {
      const float d0 = a[i] - mean[r], d1 = a[i + 1] - mean[r];
      sq[r] = fmaf(d0, n < Co ? d0 : 0.0f, sq[r]);
      sq[r] = fmaf(d1, n + 1 < Co ? d1 : 0.0f, sq[r]);
    });
    const float rstd[2] = {rsqrtf(quad_sum(sq[0]) * inv_f + kEps),
                           rsqrtf(quad_sum(sq[1]) * inv_f + kEps)};
    const long long pix[2] = {tile_pixel(g, tile, row0), tile_pixel(g, tile, row0 + 8)};
    each([&](auto& a, int i, int n, int r) {
      const float2 ga = *reinterpret_cast<const float2*>(sv + kNB + n);
      const float2 be = *reinterpret_cast<const float2*>(sv + 2 * kNB + n);
      const float y0 = gelu_exact((a[i] - mean[r]) * rstd[r] * ga.x + be.x);
      const float y1 = gelu_exact((a[i + 1] - mean[r]) * rstd[r] * ga.y + be.y);
      // Co % 4 == 0: a pair is all in or all out.
      if (pix[r] >= 0 && n < Co) store_pair(out + pix[r] * Co + n, y0, y1);
    });
  }
}

// ---------------------------------------------------------------------------
// The wide steps on conv_tma.cuh's loop (bf16, and f32 at one TF32 product a
// product): persistent grids of clusters, every CTA of a cluster walking the
// same units in the same order, CTA r the main loop of its slice's B (its
// producer reading w's slice r) and the epilogue on its accumulators; each
// row's statistics cross the cluster through conv_tma::StatExchange.

using Xchg1 = conv_tma::StatExchange<kBM1, conv_tma::kMaxCluster>;
using Xchg2 = conv_tma::StatExchange<kBM2, 2>;  // Co <= 384: two slices of 192

// step1 at a slice of NS features: both consumer warpgroups hold the
// unit's 64 rows, each NS / 2 of the features (two wgmma widths of NS / 4);
// W1's slice resident (CHUNKS chunks of it) or, CHUNKS 0, streamed through
// a B ring of 4 stages.
template <typename T, int NS, int CHUNKS>
using Wide1Loop = conv_tma::Loop<4, 1, 1, NS, NS / 4, NS / 4, true, 4, CHUNKS ? 2 : 4, CHUNKS, T>;
// What the kernel keeps after the rings: the slice's vectors, the row sums'
// halves (2 sums, 2 warpgroups, 64 rows), the exchange.
template <int NS>
constexpr int kWide1Tail = 3 * NS * 4 + 4 * kBM1 * 4 + Xchg1::BYTES;
template <typename T, int NS, int CHUNKS>
constexpr int kWide1Smem = Wide1Loop<T, NS, CHUNKS>::HEAD + kWide1Tail<NS>;
// The most chunks of W1's slice that stay in shared memory beside the rest.
template <typename T, int NS>
constexpr int kWide1Chunks =
    (conv_tma::kSmemLimit - kWide1Smem<T, NS, 1> + Wide1Loop<T, NS, 1>::B_BYTES) / Wide1Loop<T, NS, 1>::B_BYTES;
// kernels/fpn_neck.py::RESIDENT_CHUNKS.
static_assert(kWide1Chunks<bf16, 256> == 5 && kWide1Chunks<bf16, 384> == 3 && kWide1Chunks<float, 192> == 7 &&
                  kWide1Chunks<float, 256> == 5,
              "resident W1 chunks");
static_assert(kWide1Smem<bf16, 256, 0> <= conv_tma::kSmemLimit, "shared memory");

// step2 at N features: a warpgroup 4 rows of the 128-pixel unit by all N
// (N / 2 + N / 2), W2 through a B ring of 9 (N 128) or 7 (192) stages.
template <typename T, int N>
using Wide2Loop = conv_tma::Loop<8, 3, 3, N, N / 2, N / 2, false, 2, N == 128 ? 9 : 7, 0, T>;
template <typename T, int N>
constexpr int kWide2Smem = Wide2Loop<T, N>::HEAD + 3 * N * 4 + Xchg2::BYTES;
static_assert(kWide2Smem<float, 128> <= conv_tma::kSmemLimit && kWide2Smem<float, 192> <= conv_tma::kSmemLimit,
              "shared memory");

// A u pair as the epilogue loads it: two f32, or two bf16 in one word.
__device__ __forceinline__ float2 pair_of(float2 v) { return v; }
__device__ __forceinline__ float2 pair_of(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// f0 through fmap (B, H, W, C0, boxes of 16 x 4); w1 (slices, 1 tap,
// ceil(C0/KC) chunks, NS/8, 8 rows, 128 bytes of K in the 128-byte
// swizzle; f32 rounded to TF32); vec1 (3, slices NS), zero past Cm; u and t
// (B, H, W, Cm).
template <class L>
__global__ void __launch_bounds__(conv_tma::kThreads, 1)
neck_step1_cluster_tma_kernel(const __grid_constant__ CUtensorMap fmap, const typename L::T* __restrict__ w1,
                              const float* __restrict__ vec1, const typename L::T* __restrict__ u,
                              typename L::T* __restrict__ t, int Cm, conv_tma::Geo g) {
  using T = typename L::T;
  using UPair = typename std::conditional<std::is_same<T, float>::value, float2, uint32_t>::type;
  constexpr int NS = L::NB, NH = NS / 2, K = L::N0 / 2;  // a warpgroup's features; registers an accumulator
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t ring = conv_tma::ring_base(smem), bars = ring + L::RING;
  float* sv = conv_tma::after_ring<L>(smem, ring);
  float* red = sv + 3 * NS;
  const Xchg1 xc(red + 4 * kBM1);
  const int rank = xc.rank, slices = xc.slices, n0 = rank * NS;
  for (int i = tid; i < 3 * NS; i += conv_tma::kThreads) sv[i] = vec1[(i / NS) * slices * NS + n0 + i % NS];
  if (tid == 0) xc.init();
  conv_tma::init_bars<L>(bars);
  conv_tma::cluster_sync();  // every CTA's barriers are set before a peer stores to them
  if (tid >= conv_tma::kConsumers) {
    conv_tma::producer_regs();
    if (tid == conv_tma::kConsumers) {
      constexpr int kElems = L::B_BYTES / (int)sizeof(T);
      // As it starts a unit's loads, a unit or more ahead of the consumers,
      // the producer asks for the unit's u to be brought into L2: whole
      // tile rows (all of Cm), CTA r rows r, r + slices, ...
      auto prefetch_u = [&](const conv_tma::Unit& tile) {
        for (int row = rank; row < L::BH; row += slices)
          if (tile.b < g.B && tile.h0 + row < g.H)
            conv_tma::prefetch_l2(u + (((long long)tile.b * g.H + tile.h0 + row) * g.W + tile.w0) * Cm,
                                  (uint32_t)min(conv_tma::kBW, g.W - tile.w0) * Cm * sizeof(T));
      };
      conv_tma::produce<L>(&fmap, w1 + (long long)rank * g.chunks * kElems, g, [](int) { return Taps{1, 1, 0, 0}; },
                           ring, bars, conv_tma::cluster_index(), conv_tma::cluster_count(), prefetch_u);
    }
  } else {
    conv_tma::consumer_regs();
    const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32, t4 = lane % 4;
    const int nb0 = NH * wg, row0 = 16 * warp + lane / 4;
    const int nr = min(max(Cm - n0, 0), NS);  // this slice's real features
    float acc0[K], acc1[K];
    UPair ub[K / 2];  // u of one accumulator, in its order
    conv_tma::Cursor cur;
    if constexpr (L::B_RESIDENT) mbar_wait(L::resident(bars), 0);
    uint32_t it = 0;  // this CTA's units so far
    for (int un = conv_tma::cluster_index(); un < g.tiles; un += conv_tma::cluster_count(), ++it) {
      const conv_tma::Unit tile = conv_tma::unit_of<4>(g, un);
      const long long pix[2] = {tile_pixel(g, tile, row0), tile_pixel(g, tile, row0 + 8)};
      // u of accumulator a's pairs (features from nb), rows past the map and
      // features past Cm any valid pair, unused.
      auto load_u = [&](int nb) {
#pragma unroll
        for (int i = 0; i < K; i += 4) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n = n0 + nb + 8 * (i / 4) + 2 * t4;
            const long long at = (pix[r] < 0 ? 0 : pix[r]) * Cm + (n < Cm ? n : 0);
            ub[i / 4 * 2 + r] = __ldg(reinterpret_cast<const UPair*>(u + at));
          }
        }
      };
      conv_tma::consume<L>(ring, bars, g.chunks, cur, 0, nb0, acc0, acc1);
      if (tid == 0 && slices > 1) xc.expect(it);
      load_u(nb0);
      // z = acc + bias; register i holds feature nb + 8 (i / 4) + 2 t4 + i % 2
      // of row (i / 2) % 2, counted from the slice's first.
      float part[2] = {0.0f, 0.0f};
      auto add_bias = [&](float(&a)[K], int nb) {
#pragma unroll
        for (int i = 0; i < K; i += 2) {
          const float2 bias = *reinterpret_cast<const float2*>(sv + nb + 8 * (i / 4) + 2 * t4);
          a[i] += bias.x;
          a[i + 1] += bias.y;
          part[(i >> 1) & 1] += a[i] + a[i + 1];
        }
      };
      add_bias(acc0, nb0);
      add_bias(acc1, nb0 + L::N0);
      // A row's sums over the slice: its quad's, then the two warpgroups'
      // halves in order.
      auto row_sums = [&](int which, float(&v)[2]) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float q = quad_sum(v[r]);
          if (t4 == 0) red[(which * 2 + wg) * kBM1 + row0 + 8 * r] = q;
        }
        asm volatile("bar.sync 1, %0;\n" ::"n"(conv_tma::kConsumers) : "memory");
#pragma unroll
        for (int r = 0; r < 2; ++r)
          v[r] = red[(which * 2) * kBM1 + row0 + 8 * r] + red[(which * 2 + 1) * kBM1 + row0 + 8 * r];
      };
      row_sums(0, part);
      const float ml[2] = {nr > 0 ? part[0] / nr : 0.0f, nr > 0 ? part[1] / nr : 0.0f};
      float sq[2] = {0.0f, 0.0f};
      auto square = [&](float(&a)[K], int nb) {
#pragma unroll
        for (int i = 0; i < K; i += 2) {
          const int n = n0 + nb + 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
          const float d0 = a[i] - ml[r], d1 = a[i + 1] - ml[r];
          sq[r] = fmaf(d0, n < Cm ? d0 : 0.0f, sq[r]);
          sq[r] = fmaf(d1, n + 1 < Cm ? d1 : 0.0f, sq[r]);
        }
      };
      square(acc0, nb0);
      square(acc1, nb0 + L::N0);
      row_sums(1, sq);
      const float2 st[2] = {make_float2(part[0], sq[0]), make_float2(part[1], sq[1])};
      if (slices > 1) {
        // Peer j after this CTA from thread t4 of warpgroup j / 4.
        for (int j = 0; j < slices - 1; ++j)
          if (4 * wg + t4 == j)
#pragma unroll
            for (int r = 0; r < 2; ++r) xc.send(it, j, row0 + 8 * r, st[r]);
        xc.wait(it);
      }
      float mean[2], rstd[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 m = xc.combine(it, row0 + 8 * r, st[r], Cm, NS);
        mean[r] = m.x;
        rstd[r] = m.y;
      }
      // The GELUs in place, then + u and the stores, one accumulator at a
      // time (the second's u loads issued after the first's stores).
      auto in_place = [&](float(&a)[K], int nb) {
#pragma unroll
        for (int i = 0; i < K; i += 2) {
          const int n = nb + 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
          const float2 ga = *reinterpret_cast<const float2*>(sv + NS + n);
          const float2 be = *reinterpret_cast<const float2*>(sv + 2 * NS + n);
          a[i] = gelu_exact((a[i] - mean[r]) * rstd[r] * ga.x + be.x);
          a[i + 1] = gelu_exact((a[i + 1] - mean[r]) * rstd[r] * ga.y + be.y);
        }
      };
      auto add_store = [&](float(&a)[K], int nb) {
#pragma unroll
        for (int i = 0; i < K; i += 2) {
          const int n = n0 + nb + 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
          const float2 up = pair_of(ub[i / 4 * 2 + r]);
          // Cm % 4 (f32) or % 8 (bf16) == 0: a pair is all in or all out.
          if (pix[r] >= 0 && n < Cm) store_pair(t + pix[r] * Cm + n, a[i] + up.x, a[i + 1] + up.y);
        }
      };
      in_place(acc0, nb0);
      in_place(acc1, nb0 + L::N0);
      add_store(acc0, nb0);
      load_u(nb0 + L::N0);
      add_store(acc1, nb0 + L::N0);
    }
  }
  __syncwarp();
  conv_tma::cluster_sync();  // no CTA leaves while a peer may still store to it
}

// t through tmap (B, H, W, Cm, boxes of 18 x 10); w2 (slices, 9 taps,
// ceil(Cm/KC) chunks, N/8, 8 rows, 128 bytes of K in the 128-byte swizzle;
// f32 rounded to TF32); vec2 (3, slices N), zero past Co; out (B, H, W, Co).
// One slice: single CTAs; two (Co > 192): clusters of two.
template <class L>
__global__ void __launch_bounds__(conv_tma::kThreads, 1)
neck_step2_wide_tma_kernel(const __grid_constant__ CUtensorMap tmap, const typename L::T* __restrict__ w2,
                           const float* __restrict__ vec2, typename L::T* __restrict__ out, int Co,
                           conv_tma::Geo g) {
  using T = typename L::T;
  constexpr int N = L::NB, K = L::N0 / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t ring = conv_tma::ring_base(smem), bars = ring + L::RING;
  float* sv = conv_tma::after_ring<L>(smem, ring);
  const Xchg2 xc(sv + 3 * N);
  const int rank = xc.rank, slices = xc.slices, n0 = rank * N;
  for (int i = tid; i < 3 * N; i += conv_tma::kThreads) sv[i] = vec2[(i / N) * slices * N + n0 + i % N];
  if (tid == 0) xc.init();
  conv_tma::init_bars<L>(bars);
  conv_tma::cluster_sync();
  if (tid >= conv_tma::kConsumers) {
    conv_tma::producer_regs();
    if (tid == conv_tma::kConsumers) {
      constexpr int kElems = L::B_BYTES / (int)sizeof(T);
      conv_tma::produce<L>(&tmap, w2 + (long long)rank * 9 * g.chunks * kElems, g,
                           [](int) { return Taps{9, 3, -1, -1}; }, ring, bars, conv_tma::cluster_index(),
                           conv_tma::cluster_count());
    }
  } else {
    conv_tma::consumer_regs();
    const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32, t4 = lane % 4;
    const int row0 = 64 * wg + 16 * warp + lane / 4;
    const int nr = min(max(Co - n0, 0), N);
    float acc0[K], acc1[K];
    conv_tma::Cursor cur;
    uint32_t it = 0;
    for (int un = conv_tma::cluster_index(); un < g.tiles; un += conv_tma::cluster_count(), ++it) {
      const conv_tma::Unit tile = conv_tma::unit_of<8>(g, un);
      conv_tma::consume<L>(ring, bars, g.chunks, cur, 4 * wg, 0, acc0, acc1);
      if (tid == 0 && slices > 1) xc.expect(it);
      // Register i of an accumulator from feature nb holds feature nb + 8 (i
      // / 4) + 2 t4 + i % 2 of row (i / 2) % 2; `each` runs f over both
      // accumulators' pairs.
      auto each = [&](auto f) {
        auto pairs = [&](float(&a)[K], int nb) {
#pragma unroll
          for (int i = 0; i < K; i += 2) f(a, i, nb + 8 * (i / 4) + 2 * t4, (i >> 1) & 1);
        };
        pairs(acc0, 0);
        pairs(acc1, L::N0);
      };
      float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
      each([&](float(&a)[K], int i, int n, int r) {
        const float2 bias = *reinterpret_cast<const float2*>(sv + n);
        a[i] += bias.x;
        a[i + 1] += bias.y;
        sum[r] += a[i] + a[i + 1];
      });
      float ml[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] = quad_sum(sum[r]);
        ml[r] = nr > 0 ? sum[r] / nr : 0.0f;
      }
      each([&](float(&a)[K], int i, int n, int r) {
        const float d0 = a[i] - ml[r], d1 = a[i + 1] - ml[r];
        sq[r] = fmaf(d0, n0 + n < Co ? d0 : 0.0f, sq[r]);
        sq[r] = fmaf(d1, n0 + n + 1 < Co ? d1 : 0.0f, sq[r]);
      });
      const float2 st[2] = {make_float2(sum[0], quad_sum(sq[0])), make_float2(sum[1], quad_sum(sq[1]))};
      if (slices > 1) {
        for (int j = 0; j < slices - 1; ++j)
          if (t4 == j)
#pragma unroll
            for (int r = 0; r < 2; ++r) xc.send(it, j, row0 + 8 * r, st[r]);
        xc.wait(it);
      }
      float mean[2], rstd[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 m = xc.combine(it, row0 + 8 * r, st[r], Co, N);
        mean[r] = m.x;
        rstd[r] = m.y;
      }
      const long long pix[2] = {tile_pixel(g, tile, row0), tile_pixel(g, tile, row0 + 8)};
      each([&](float(&a)[K], int i, int n, int r) {
        const float2 ga = *reinterpret_cast<const float2*>(sv + N + n);
        const float2 be = *reinterpret_cast<const float2*>(sv + 2 * N + n);
        const float y0 = gelu_exact((a[i] - mean[r]) * rstd[r] * ga.x + be.x);
        const float y1 = gelu_exact((a[i + 1] - mean[r]) * rstd[r] * ga.y + be.y);
        // Co % 4 == 0: a pair is all in or all out.
        if (pix[r] >= 0 && n0 + n < Co) store_pair(out + pix[r] * Co + n0 + n, y0, y1);
      });
    }
  }
  __syncwarp();
  conv_tma::cluster_sync();  // no CTA leaves while a peer may still store to it
}

// Launches a persistent one-pass step on x (B, H, W, C) through its loop's
// tensor map.
template <class L, auto kernel, typename... Args>
cudaError_t launch_step(const typename L::T* x, int B, int H, int W, int C, int smem,
                        cudaStream_t stream, Args... args) {
  const conv_tma::Geo g = conv_tma::make_geo(B, H, W, C, L::BH, 1, L::KC);
  int grid = 0;
  cudaError_t e = conv_tma::persistent_grid<kernel>(smem, g.tiles, &grid);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  e = conv_tma::make_map<L>(&map, x, B, H, W, C);
  if (e != cudaSuccess) return e;
  kernel<<<grid, conv_tma::kThreads, smem, stream>>>(map, args..., g);
  return cudaGetLastError();
}

// Launches a wide step on x (B, H, W, C) through its loop's tensor map: a
// persistent grid of clusters of `slices` CTAs.
template <class L, auto kernel, typename... Args>
cudaError_t launch_wide(const typename L::T* x, int B, int H, int W, int C, int smem, int slices,
                        cudaStream_t stream, Args... args) {
  const conv_tma::Geo g = conv_tma::make_geo(B, H, W, C, L::BH, 1, L::KC);
  CUtensorMap map;
  cudaError_t e = conv_tma::make_map<L>(&map, x, B, H, W, C);
  if (e != cudaSuccess) return e;
  conv_tma::ClusterLaunch launch(dim3(slices), conv_tma::kThreads, smem, slices, stream);
  int clusters = 0;
  e = conv_tma::persistent_clusters<kernel>(launch.cfg, slices, g.tiles, &clusters);
  if (e != cudaSuccess) return e;
  launch.cfg.gridDim = dim3(clusters * slices);
  e = cudaLaunchKernelEx(&launch.cfg, kernel, map, args..., g);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Launches a conv_gemm.cuh cluster kernel: `slices` CTAs (a cluster) to
// each of `tiles` pixel tiles, along x.
template <auto kernel, typename... Args>
cudaError_t launch_gemm_cluster(size_t smem, int slices, long long tiles, cudaStream_t stream, Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  conv_tma::ClusterLaunch launch(dim3((unsigned)(slices * tiles)), kThreads, smem, slices, stream);
  e = cudaLaunchKernelEx(&launch.cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Routes.

enum Kind { kKindF32 = 0, kKindTF32 = 1, kKindBF16 = 2 };  // 3xTF32, one TF32 product, bf16
enum Route { kGemm = 0, kTma = 1, kTmaStreamed = 2 };     // conv_gemm.cuh's loop; conv_tma.cuh's

struct Step {
  int route, width, slices;
};

// The width of the slices of n features from `widths` (ascending): the
// least padding (slices x width), then the wider.
inline int pick_width(int n, std::initializer_list<int> widths) {
  int best = 0, best_pad = 0;
  for (int w : widths) {
    const int pad = (n + w - 1) / w * w;
    if (best == 0 || pad <= best_pad) {
      best = w;
      best_pad = pad;
    }
  }
  return best;
}

// Each step's route, slice width and slices for a kind and widths
// (kernels/fpn_neck.py::plan gives the same); false where none takes them.
//   step1: Cm <= kMid one slice of kMid: the TMA-fed kernel (bf16, TF32)
//     where W1 fits (C0 <= kMaxC0<T>), else conv_gemm.cuh's (3xTF32; TF32
//     at one pass; bf16 refused). Wider, a cluster: bf16 slices of 256 or
//     384 with W1's slice resident, else of 256 streamed; TF32 of 192 or
//     256 resident, else conv_gemm.cuh's at one pass; 3xTF32 of 256 or 384.
//   step2: Co <= kNB one slice of kNB; else N = 128 (Co <= 128) or 192,
//     ceil(Co / N) slices; conv_gemm.cuh's loop for 3xTF32, conv_tma.cuh's
//     for bf16 and TF32.
inline bool plan_neck(int kind, int C0, int Cm, int Co, Step& s1, Step& s2) {
  if (C0 <= 0 || Cm <= 0 || Co <= 0 || Cm > kMaxMid || Co > kMaxOut) return false;
  const int kc = kind == kKindBF16 ? 64 : 32, chunks = (C0 + kc - 1) / kc;
  auto wide = [&](int w, int route) { s1 = Step{route, w, (Cm + w - 1) / w}; };
  if (Cm <= kMid) {
    const int cap = kind == kKindBF16 ? kMaxC0<bf16> : kMaxC0<float>;
    if (kind == kKindF32 || (kind == kKindTF32 && C0 > cap)) {
      s1 = Step{kGemm, kMid, 1};
    } else if (C0 > cap) {
      return false;
    } else {
      s1 = Step{kTma, kMid, 1};
    }
  } else if (kind == kKindF32) {
    wide(pick_width(Cm, {256, 384}), kGemm);
  } else if (kind == kKindBF16) {
    const bool a = chunks <= kWide1Chunks<bf16, 256>, b = chunks <= kWide1Chunks<bf16, 384>;
    if (a && b) wide(pick_width(Cm, {256, 384}), kTma);
    else if (a) wide(256, kTma);
    else wide(256, kTmaStreamed);
  } else {
    const bool a = chunks <= kWide1Chunks<float, 192>, b = chunks <= kWide1Chunks<float, 256>;
    if (a && b) wide(pick_width(Cm, {192, 256}), kTma);
    else if (a) wide(192, kTma);
    else wide(pick_width(Cm, {256, 384}), kGemm);
  }
  const int route2 = kind == kKindF32 ? kGemm : kTma;
  if (Co <= kNB) {
    s2 = Step{route2, kNB, 1};
  } else {
    const int n = Co <= 128 ? 128 : 192;
    s2 = Step{route2, n, (Co + n - 1) / n};
  }
  return true;
}

// The entries' body, operands of type T: f32 (PASSES TF32 products a
// product: 3, or 1 for the TF32 entry) or bf16.
template <typename T, int PASSES>
int run_neck(const T* f0, const T* u, const T* w1, const float* vec1, const T* w2, const float* vec2, T* t,
             T* out, int B, int H, int W, int C0, int Cm, int Co, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kVec = 16 / (int)sizeof(T);  // channels a 16-byte copy
  const int kind = !kF32 ? kKindBF16 : PASSES == 3 ? kKindF32 : kKindTF32;
  Step s1, s2;
  if (B <= 0 || H <= 0 || W <= 0 || C0 % kVec || Cm % kVec || Co % 4 || H > 32767 || W > 32767 ||
      !plan_neck(kind, C0, Cm, Co, s1, s2))
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  if (npix > (1LL << 30)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaErrorInvalidValue;
  // step1
  if (s1.slices == 1 && s1.route == kTma) {
    e = launch_step<Neck1Loop<T>, neck_step1_tma_kernel<T>>(f0, B, H, W, C0, kNeck1Smem<T>, stream, w1, vec1, u,
                                                            t, Cm);
  } else if constexpr (kF32) {
    if (s1.slices == 1) {
      e = allow_smem(neck_step1_kernel<PASSES>, kSmem1);
      if (e != cudaSuccess) return (int)e;
      neck_step1_kernel<PASSES><<<(unsigned)((npix + kBM1 - 1) / kBM1), kThreads, kSmem1, stream>>>(
          f0, w1, vec1, u, t, (int)npix, H, W, C0, Cm);
      e = cudaGetLastError();
    } else if (s1.route == kGemm) {
      const long long tiles = (npix + kBM1 - 1) / kBM1;
      e = s1.width == 256 ? launch_gemm_cluster<neck_step1_cluster_kernel<256, PASSES>>(
                                kSmemC1<256>, s1.slices, tiles, stream, f0, w1, vec1, u, t, (int)npix, H, W, C0, Cm)
                          : launch_gemm_cluster<neck_step1_cluster_kernel<384, PASSES>>(
                                kSmemC1<384>, s1.slices, tiles, stream, f0, w1, vec1, u, t, (int)npix, H, W, C0, Cm);
    } else if (s1.width == 192) {
      using L = Wide1Loop<float, 192, kWide1Chunks<float, 192>>;
      e = launch_wide<L, neck_step1_cluster_tma_kernel<L>>(f0, B, H, W, C0, kWide1Smem<float, 192, L::B_CHUNKS>,
                                                           s1.slices, stream, w1, vec1, u, t, Cm);
    } else {
      using L = Wide1Loop<float, 256, kWide1Chunks<float, 256>>;
      e = launch_wide<L, neck_step1_cluster_tma_kernel<L>>(f0, B, H, W, C0, kWide1Smem<float, 256, L::B_CHUNKS>,
                                                           s1.slices, stream, w1, vec1, u, t, Cm);
    }
  } else {
    if (s1.route == kTmaStreamed) {
      using L = Wide1Loop<bf16, 256, 0>;
      e = launch_wide<L, neck_step1_cluster_tma_kernel<L>>(f0, B, H, W, C0, kWide1Smem<bf16, 256, 0>, s1.slices,
                                                           stream, w1, vec1, u, t, Cm);
    } else if (s1.width == 256) {
      using L = Wide1Loop<bf16, 256, kWide1Chunks<bf16, 256>>;
      e = launch_wide<L, neck_step1_cluster_tma_kernel<L>>(f0, B, H, W, C0, kWide1Smem<bf16, 256, L::B_CHUNKS>,
                                                           s1.slices, stream, w1, vec1, u, t, Cm);
    } else {
      using L = Wide1Loop<bf16, 384, kWide1Chunks<bf16, 384>>;
      e = launch_wide<L, neck_step1_cluster_tma_kernel<L>>(f0, B, H, W, C0, kWide1Smem<bf16, 384, L::B_CHUNKS>,
                                                           s1.slices, stream, w1, vec1, u, t, Cm);
    }
  }
  if (e != cudaSuccess) return (int)e;
  // step2
  if (s2.route == kTma) {
    if (s2.width == kNB)
      return (int)launch_step<Neck2Loop<T>, neck_step2_tma_kernel<T>>(t, B, H, W, Cm, kNeck2Smem<T>, stream, w2,
                                                                      vec2, out, Co);
    if (s2.width == 128)
      return (int)launch_wide<Wide2Loop<T, 128>, neck_step2_wide_tma_kernel<Wide2Loop<T, 128>>>(
          t, B, H, W, Cm, kWide2Smem<T, 128>, s2.slices, stream, w2, vec2, out, Co);
    return (int)launch_wide<Wide2Loop<T, 192>, neck_step2_wide_tma_kernel<Wide2Loop<T, 192>>>(
        t, B, H, W, Cm, kWide2Smem<T, 192>, s2.slices, stream, w2, vec2, out, Co);
  }
  if constexpr (kF32) {
    if (s2.width == kNB) {
      e = allow_smem(neck_step2_kernel<PASSES>, kSmem2);
      if (e != cudaSuccess) return (int)e;
      neck_step2_kernel<PASSES><<<(unsigned)((npix + kBM2 - 1) / kBM2), kThreads, kSmem2, stream>>>(
          t, w2, vec2, out, (int)npix, H, W, Cm, Co);
      return (int)cudaGetLastError();
    }
    const long long tiles = (npix + kBM2 - 1) / kBM2;
    return (int)(s2.width == 128 ? launch_gemm_cluster<neck_step2_wide_kernel<128>>(
                                       kSmemW2<128>, s2.slices, tiles, stream, t, w2, vec2, out, (int)npix, H, W,
                                       Cm, Co)
                                 : launch_gemm_cluster<neck_step2_wide_kernel<192>>(
                                       kSmemW2<192>, s2.slices, tiles, stream, t, w2, vec2, out, (int)npix, H, W,
                                       Cm, Co));
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The one-pass tiles (the flagship's widths), the widest Cm and Co, and the
// widest C0 of the one-pass step1 (its W1 held in shared memory), bf16 and
// TF32.
extern "C" int fpn_neck_l0_tile_mid() { return kMid; }
extern "C" int fpn_neck_l0_tile_out() { return kNB; }
extern "C" int fpn_neck_l0_max_mid() { return kMaxMid; }
extern "C" int fpn_neck_l0_max_out() { return kMaxOut; }
extern "C" int fpn_neck_l0_bf16_max_c0() { return kMaxC0<bf16>; }
extern "C" int fpn_neck_l0_tf32_max_c0() { return kMaxC0<float>; }

// plan_neck for kind (0 3xTF32, 1 TF32, 2 bf16) and widths: out = (route,
// width, slices) of step1, then of step2 (route 0 conv_gemm.cuh's loop, 1
// conv_tma.cuh's with W1 resident where step1, 2 with W1 streamed).
// Returns 1 where a route takes the widths, else 0.
extern "C" int fpn_neck_l0_plan(int kind, int C0, int Cm, int Co, int* out) {
  Step s1, s2;
  if (!plan_neck(kind, C0, Cm, Co, s1, s2)) return 0;
  const int v[6] = {s1.route, s1.width, s1.slices, s2.route, s2.width, s2.slices};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 1;
}

// f0 (B, H, W, C0), u and t (B, H, W, Cm), out (B, H, W, Co), all f32 and
// contiguous; C0 % 4 == 0, Cm % 4 == 0, Co % 4 == 0, Cm <= max_mid, Co <=
// max_out. w1, vec1, w2 and vec2 packed for plan(0, C0, Cm, Co)'s routes
// (kernels/fpn_neck.py::pack_neck). t is scratch. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int fpn_neck_l0_f32(const float* f0, const float* u, const float* w1, const float* vec1,
                               const float* w2, const float* vec2, float* t, float* out, int B, int H, int W,
                               int C0, int Cm, int Co, cudaStream_t stream) {
  return run_neck<float, 3>(f0, u, w1, vec1, w2, vec2, t, out, B, H, W, C0, Cm, Co, stream);
}

// As fpn_neck_l0_f32, the products as one TF32 product a product
// (matmul_precision "default" / "high"): f0 and t rounded to TF32 in
// registers; w1, w2 packed for plan(1, ...)'s routes (the TMA-fed kernels'
// packing.pack_sw128_tf32, rounded to TF32; conv_gemm.cuh's as the 3xTF32
// entry's, only their hi parts read).
extern "C" int fpn_neck_l0_tf32(const float* f0, const float* u, const float* w1, const float* vec1,
                                const float* w2, const float* vec2, float* t, float* out, int B, int H, int W,
                                int C0, int Cm, int Co, cudaStream_t stream) {
  return run_neck<float, 1>(f0, u, w1, vec1, w2, vec2, t, out, B, H, W, C0, Cm, Co, stream);
}

// As fpn_neck_l0_f32 with f0, u, t, out and the packed w1, w2 in bf16 (C0 %
// 8 == 0, Cm % 8 == 0), packed for plan(2, ...)'s routes.
extern "C" int fpn_neck_l0_bf16(const __nv_bfloat16* f0, const __nv_bfloat16* u, const __nv_bfloat16* w1,
                                const float* vec1, const __nv_bfloat16* w2, const float* vec2, __nv_bfloat16* t,
                                __nv_bfloat16* out, int B, int H, int W, int C0, int Cm, int Co,
                                cudaStream_t stream) {
  return run_neck<bf16, 3>(f0, u, w1, vec1, w2, vec2, t, out, B, H, W, C0, Cm, Co, stream);
}
