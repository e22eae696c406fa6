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
// Wider necks (the base and large backbones: Cm 512 / 768, Co 128 / 192)
// split a step's features into slices of kMid (step1) or kNB (step2), one
// slice a block (gridDim.y): the block stores its pre-LN sums plus the bias
// (f32) to a workspace, and ln_gelu_rows, a warp per pixel, takes the
// LayerNorm over all the features, the GELU and (step1) + u. The flagship's
// widths keep the one-pass kernels.
//
// bf16 (the JAX package's compute_dtype="bfloat16", as the Pallas kernel
// computes it): f0, u and the packed W1, W2 in bf16, products accumulated
// in f32, bias, LayerNorm, GELU and + u in f32; t rounded to bf16 before
// the 3x3 (fpn_neck.py:98), z0 written in bf16. A step whose features fit
// its tile runs on conv_tma.cuh's persistent, TMA-fed loop (below); a
// wider one the split form on conv_gemm.cuh's mainloop_bf16. One bf16
// product a product: 0.034 ms at 240x192 (0.040 ms at 256x208) at 989
// TFLOP/s dense bf16.

#include <cuda_runtime.h>

#include "conv_gemm.cuh"
#include "conv_tma.cuh"

namespace {

using namespace conv_gemm;

constexpr int kMid = 384;  // step1's features a block (one slice)
constexpr int kNB = 96;    // step2's features a block (one slice), one wgmma
constexpr int kMaxSlices = 4;
constexpr int kBM1 = 64, kBM2 = 128;  // pixels a block
template <typename T>
using R1 = typename RingFor<T, kBM1, kMid, 2>::type;
template <typename T>
using R2 = typename RingFor<T, kBM2, kNB, 2>::type;
constexpr int kLdz1 = ldz(kMid), kLdz2 = ldz(kNB);
constexpr int max_int(int a, int b) { return a > b ? a : b; }
// The ring (or the epilogue tile over it, where larger), then the bias, LN
// scale and LN bias, then the mbarriers.
template <typename T>
constexpr int kBase1 = max_int(R1<T>::BYTES, kBM1 * kLdz1 * 4);
template <typename T>
constexpr int kBase2 = max_int(R2<T>::BYTES, kBM2 * kLdz2 * 4);
template <typename T>
constexpr size_t kSmem1 = (size_t)kBase1<T> + 3 * kMid * 4 + 16;
template <typename T>
constexpr size_t kSmem2 = (size_t)kBase2<T> + 3 * kNB * 4 + 16;
static_assert(kBase1<float> == R1<float>::BYTES && kBase2<float> == R2<float>::BYTES,
              "epilogue tile");
static_assert(kSmem1<float> <= 232448 && 2 * (kSmem2<float> + 1024) <= 233472, "shared memory");
static_assert(kSmem1<bf16> <= 232448 && 2 * (kSmem2<bf16> + 1024) <= 233472, "shared memory");

// f0 (B, H, W, C0); w1 (slices, 1 tap, ceil(C0/32) chunks, parts, kMid/8,
// 8, 8, 16 bytes of K) and vec1 (3, slices kMid): b1, LN scale, LN bias,
// zero past Cm; u and t (B, H, W, Cm). With SUMS, block (x, y) stores
// slice y's pre-LN sums to ws (npix, slices kMid) and writes no t.
template <typename T, bool SUMS>
__global__ void __launch_bounds__(kThreads, 1)
neck_step1_kernel(const T* __restrict__ f0, const T* __restrict__ w1,
                  const float* __restrict__ vec1, const T* __restrict__ u,
                  T* __restrict__ t, float* __restrict__ ws, int npix, int H, int W, int C0,
                  int Cm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM1;
  const int slice = blockIdx.y, cmp = gridDim.y * kMid;
  float* sv = reinterpret_cast<float*>(smem + kBase1<T>);
  if constexpr (!SUMS)
    for (int i = tid; i < 3 * kMid; i += kThreads) sv[i] = vec1[i];
  const uint32_t bars =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + kBase1<T> + 3 * kMid * 4;

  // Warpgroup wg: all 64 rows, features 192 wg .. 192 wg + 191.
  const int nb0 = (kMid / 2) * (tid / 128);
  const int chunks = (C0 + kKC - 1) / kKC;
  const T* wb = w1 + (long long)slice * chunks * kParts<T> * kMid * kKC;
  float acc0[48], acc1[48];
  conv_mainloop<T, kBM1, kMid, 2, 96, 96>(f0, wb, npix, H, W, C0, Taps{1, 1, 0, 0}, m0, smem,
                                          bars, 0, nb0, acc0, acc1);
  const int t4 = tid % 4;
  if constexpr (SUMS) {
    const int m = m0 + quad_row();
    store_sums(acc0, ws, m, npix, cmp, slice * kMid + nb0, t4, vec1);
    store_sums(acc1, ws, m, npix, cmp, slice * kMid + nb0 + 96, t4, vec1);
    return;
  }

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
  const T* ur = u + (long long)m * Cm + 2 * t4;
  T* tr = t + (long long)m * Cm + 2 * t4;
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

// t (B, H, W, Cm); w2 (slices, 9 taps, ceil(Cm/32) chunks, parts, kNB/8, 8,
// 8, 16 bytes of K) and vec2 (3, slices kNB): b2, LN scale, LN bias, zero
// past Co; out (B, H, W, Co). With SUMS, block (x, y) stores slice y's
// pre-LN sums to ws (npix, slices kNB) and writes no out.
template <typename T, bool SUMS>
__global__ void __launch_bounds__(kThreads, 2)
neck_step2_kernel(const T* __restrict__ t, const T* __restrict__ w2,
                  const float* __restrict__ vec2, T* __restrict__ out, float* __restrict__ ws,
                  int npix, int H, int W, int Cm, int Co) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM2;
  const int slice = blockIdx.y, cop = gridDim.y * kNB;
  float* sv = reinterpret_cast<float*>(smem + kBase2<T>);
  if constexpr (!SUMS)
    for (int i = tid; i < 3 * kNB; i += kThreads) sv[i] = vec2[i];
  const uint32_t bars =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + kBase2<T> + 3 * kNB * 4;

  // Warpgroup wg: rows 64 wg .. 64 wg + 63, all features. Tap t reads
  // source pixel (i - 1 + t / 3, j - 1 + t % 3).
  const int arow = 64 * (tid / 128);
  const int chunks = (Cm + kKC - 1) / kKC;
  const T* wb = w2 + (long long)slice * 9 * chunks * kParts<T> * kNB * kKC;
  float acc[kNB / 2], none[1];
  conv_mainloop<T, kBM2, kNB, 2, kNB, 0>(t, wb, npix, H, W, Cm, Taps{9, 3, -1, -1}, m0, smem, bars,
                                         arow, 0, acc, none);
  const int t4 = tid % 4, row0 = arow + quad_row();
  if constexpr (SUMS) {
    store_sums(acc, ws, m0 + row0, npix, cop, slice * kNB, t4, vec2);
    return;
  }

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
    T* orow = out + (long long)m * Co;
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

// The split steps' second pass: warp w of block x takes pixel 8 x + w:
// out[m, :F] = GELU(LN(ws[m, :F])) (+ add[m, :F] where add is given), from
// the F of fp pre-LN sums a row; vec (3, fp): bias (added already), LN
// scale, LN bias.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_gelu_rows(const float* __restrict__ ws, const float* __restrict__ vec,
             const T* __restrict__ add, T* __restrict__ out, int npix, int F, int fp) {
  const int m = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (m >= npix) return;
  const float* z = ws + (long long)m * fp;
  float rstd;
  const float mean = warp_ln_stats(z, F, rstd);
  for (int n = lane; n < F; n += 32) {
    float y = gelu_exact((z[n] - mean) * rstd * vec[fp + n] + vec[2 * fp + n]);
    if (add != nullptr) y += load_one(add + (long long)m * F + n);
    store_one(out + (long long)m * F + n, y);
  }
}

template <typename T>
int run_neck(const T* f0, const T* u, const T* w1, const float* vec1, const T* w2,
             const float* vec2, T* t, T* out, float* ws, int B, int H, int W, int C0, int Cm,
             int Co, cudaStream_t stream) {
  constexpr int kVec = std::is_same<T, float>::value ? 4 : 8;  // channels a 16-byte copy
  const int s1 = (Cm + kMid - 1) / kMid, s2 = (Co + kNB - 1) / kNB;
  if (B <= 0 || H <= 0 || W <= 0 || C0 <= 0 || Cm <= 0 || Co <= 0 || C0 % kVec || Cm % kVec ||
      Co % 4 || s1 > kMaxSlices || s2 > kMaxSlices || H > 32767 || W > 32767 ||
      ((s1 > 1 || s2 > 1) && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  if (npix > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const unsigned grid1 = (unsigned)((npix + kBM1 - 1) / kBM1);
  const unsigned grid2 = (unsigned)((npix + kBM2 - 1) / kBM2);
  const unsigned rows = (unsigned)((npix + kThreads / 32 - 1) / (kThreads / 32));
  constexpr size_t smem1 = kSmem1<T>, smem2 = kSmem2<T>;
  cudaError_t e;
  if (s1 == 1) {
    e = allow_smem(neck_step1_kernel<T, false>, smem1);
    if (e != cudaSuccess) return (int)e;
    neck_step1_kernel<T, false><<<grid1, kThreads, smem1, stream>>>(f0, w1, vec1, u, t, ws,
                                                                      (int)npix, H, W, C0, Cm);
  } else {
    e = allow_smem(neck_step1_kernel<T, true>, smem1);
    if (e != cudaSuccess) return (int)e;
    neck_step1_kernel<T, true><<<dim3(grid1, s1), kThreads, smem1, stream>>>(
        f0, w1, vec1, u, t, ws, (int)npix, H, W, C0, Cm);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ln_gelu_rows<T><<<rows, kThreads, 0, stream>>>(ws, vec1, u, t, (int)npix, Cm, s1 * kMid);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (s2 == 1) {
    e = allow_smem(neck_step2_kernel<T, false>, smem2);
    if (e != cudaSuccess) return (int)e;
    neck_step2_kernel<T, false><<<grid2, kThreads, smem2, stream>>>(t, w2, vec2, out, ws,
                                                                      (int)npix, H, W, Cm, Co);
  } else {
    e = allow_smem(neck_step2_kernel<T, true>, smem2);
    if (e != cudaSuccess) return (int)e;
    neck_step2_kernel<T, true><<<dim3(grid2, s2), kThreads, smem2, stream>>>(
        t, w2, vec2, out, ws, (int)npix, H, W, Cm, Co);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ln_gelu_rows<T><<<rows, kThreads, 0, stream>>>(ws, vec2, nullptr, out, (int)npix, Co,
                                                   s2 * kNB);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, one pass (Cm <= kMid, Co <= kNB): both steps on conv_tma.cuh's loop,
// persistent, t through device memory.
//   * step1: a unit is a 64-pixel tile (4 rows x 16 columns); both consumer
//     warpgroups hold its 64 rows, each half of the kMid features. W1 (at
//     most kMaxC0 input channels, ceil(C0 / 64) chunks of kMid x 64) is
//     brought once and stays in shared memory; the A ring streams the
//     tile's chunks. The unit's u is read into registers before its
//     products, so its latency hides behind them. The epilogue on the
//     registers: bias, the LayerNorm's two sums over a row (each
//     warpgroup's half through shared memory), GELU, + u -> t.
//   * step2: a unit is a 128-pixel tile (8 rows x 16 columns), a warpgroup
//     each 64 rows by all kNB features, K = ceil(Cm / 64) chunks of the
//     3x3, one 10 x 18 halo box a chunk serving its 9 taps, W2 through a
//     ring of 8 stages; the epilogue: bias, LayerNorm, GELU -> out.

constexpr int kMaxC0 = 192;  // step1's widest input held in shared memory
using Neck1Loop = conv_tma::Loop<4, 1, 1, kMid, 96, 96, true, 4, 2, kMaxC0 / conv_tma::kKC>;
using Neck2Loop = conv_tma::Loop<8, 3, 3, kNB, kNB, 0, false, 2, 8>;
constexpr int kNeck1Smem = Neck1Loop::HEAD + 3 * kMid * 4 + 2 * 2 * 64 * 4;
constexpr int kNeck2Smem = Neck2Loop::HEAD + 3 * kNB * 4;
static_assert(kNeck1Smem <= conv_tma::kSmemLimit && kNeck2Smem <= conv_tma::kSmemLimit,
              "shared memory");

// The flattened pixel of tile row `row` of unit u, or -1 past the map.
__device__ __forceinline__ long long tile_pixel(const conv_tma::Geo& g, const conv_tma::Unit& u,
                                                int row) {
  const int h = u.h0 + row / conv_tma::kBW, x = u.w0 + row % conv_tma::kBW;
  if (u.b >= g.B || h >= g.H || x >= g.W) return -1;
  return ((long long)u.b * g.H + h) * g.W + x;
}

// f0 through fmap (B, H, W, C0, boxes of 16 x 4); w1 (1 tap, ceil(C0/64)
// chunks, kMid/8, 8 rows, 128 bytes of K in the 128-byte swizzle); vec1 (3,
// kMid); u and t (B, H, W, Cm).
__global__ void __launch_bounds__(conv_tma::kThreads, 1)
neck_step1_tma_kernel(const __grid_constant__ CUtensorMap fmap, const bf16* __restrict__ w1,
                      const float* __restrict__ vec1, const bf16* __restrict__ u,
                      bf16* __restrict__ t, int Cm, conv_tma::Geo g) {
  using L = Neck1Loop;
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
  uint32_t uv[2][24];  // the unit's u, as bf16 pairs in the accumulators' order
  conv_tma::Cursor cur;
  mbar_wait(L::resident(bars), 0);
  for (int un = blockIdx.x; un < g.tiles; un += gridDim.x) {
    const conv_tma::Unit tile = conv_tma::unit_of<4>(g, un);
    const long long pix[2] = {tile_pixel(g, tile, row0), tile_pixel(g, tile, row0 + 8)};
    // u of rows past the map and features past Cm: any valid pair, unused.
#pragma unroll
    for (int i = 0; i < 96; i += 2) {
      const int n = nb0 + 96 * (i / 48) + 8 * (i % 48 / 4) + 2 * t4, r = (i >> 1) & 1;
      const long long at = (pix[r] < 0 ? 0 : pix[r]) * Cm + (n < Cm ? n : 0);
      uv[i / 48][i % 48 / 2] = __ldg(reinterpret_cast<const unsigned*>(u + at));
    }
    conv_tma::consume<L>(ring, bars, g.chunks, cur, 0, nb0, acc0, acc1);
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

// t through tmap (B, H, W, Cm, boxes of 18 x 10); w2 (9 taps, ceil(Cm/64)
// chunks, kNB/8, 8 rows, 128 bytes of K in the 128-byte swizzle); vec2 (3,
// kNB); out (B, H, W, Co).
__global__ void __launch_bounds__(conv_tma::kThreads, 1)
neck_step2_tma_kernel(const __grid_constant__ CUtensorMap tmap, const bf16* __restrict__ w2,
                      const float* __restrict__ vec2, bf16* __restrict__ out, int Co,
                      conv_tma::Geo g) {
  using L = Neck2Loop;
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
  float acc[kNB / 2], none[1];
  conv_tma::Cursor cur;
  for (int un = blockIdx.x; un < g.tiles; un += gridDim.x) {
    const conv_tma::Unit tile = conv_tma::unit_of<8>(g, un);
    conv_tma::consume<L>(ring, bars, g.chunks, cur, 4 * wg, 0, acc, none);
    float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kNB / 2; i += 2) {
      const float2 bias = *reinterpret_cast<const float2*>(sv + 8 * (i / 4) + 2 * t4);
      acc[i] += bias.x;
      acc[i + 1] += bias.y;
      sum[(i >> 1) & 1] += acc[i] + acc[i + 1];
    }
    const float mean[2] = {quad_sum(sum[0]) * inv_f, quad_sum(sum[1]) * inv_f};
#pragma unroll
    for (int i = 0; i < kNB / 2; i += 2) {
      const int n = 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
      const float d0 = acc[i] - mean[r], d1 = acc[i + 1] - mean[r];
      sq[r] = fmaf(d0, n < Co ? d0 : 0.0f, sq[r]);
      sq[r] = fmaf(d1, n + 1 < Co ? d1 : 0.0f, sq[r]);
    }
    const float rstd[2] = {rsqrtf(quad_sum(sq[0]) * inv_f + kEps),
                           rsqrtf(quad_sum(sq[1]) * inv_f + kEps)};
    const long long pix[2] = {tile_pixel(g, tile, row0), tile_pixel(g, tile, row0 + 8)};
#pragma unroll
    for (int i = 0; i < kNB / 2; i += 2) {
      const int n = 8 * (i / 4) + 2 * t4, r = (i >> 1) & 1;
      const float2 ga = *reinterpret_cast<const float2*>(sv + kNB + n);
      const float2 be = *reinterpret_cast<const float2*>(sv + 2 * kNB + n);
      const float y0 = gelu_exact((acc[i] - mean[r]) * rstd[r] * ga.x + be.x);
      const float y1 = gelu_exact((acc[i + 1] - mean[r]) * rstd[r] * ga.y + be.y);
      // Co % 4 == 0: a pair is all in or all out.
      if (pix[r] >= 0 && n < Co) store_pair(out + pix[r] * Co + n, y0, y1);
    }
  }
}

// Launches a persistent one-pass step on x (B, H, W, C) through its loop's
// tensor map.
template <class L, auto kernel, typename... Args>
cudaError_t launch_step(const bf16* x, int B, int H, int W, int C, int smem, cudaStream_t stream,
                        Args... args) {
  const conv_tma::Geo g = conv_tma::make_geo(B, H, W, C, L::BH, 1);
  int grid = 0;
  cudaError_t e = conv_tma::persistent_grid<kernel>(smem, g.tiles, &grid);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  e = conv_tma::make_map<L>(&map, x, B, H, W, C);
  if (e != cudaSuccess) return e;
  kernel<<<grid, conv_tma::kThreads, smem, stream>>>(map, args..., g);
  return cudaGetLastError();
}

// The bf16 entry's body: each step on conv_tma.cuh's loop where its
// features fit one tile, else run_neck's split form with ln_gelu_rows.
int run_neck_bf16(const bf16* f0, const bf16* u, const bf16* w1, const float* vec1,
                  const bf16* w2, const float* vec2, bf16* t, bf16* out, float* ws, int B, int H,
                  int W, int C0, int Cm, int Co, cudaStream_t stream) {
  const int s1 = (Cm + kMid - 1) / kMid, s2 = (Co + kNB - 1) / kNB;
  if (B <= 0 || H <= 0 || W <= 0 || C0 <= 0 || Cm <= 0 || Co <= 0 || C0 % 8 || Cm % 8 || Co % 4 ||
      s1 > kMaxSlices || s2 > kMaxSlices || H > 32767 || W > 32767 ||
      ((s1 > 1 || s2 > 1) && ws == nullptr) || (s1 == 1 && C0 > kMaxC0))
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  if (npix > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const unsigned rows = (unsigned)((npix + kThreads / 32 - 1) / (kThreads / 32));
  cudaError_t e;
  if (s1 == 1) {
    e = launch_step<Neck1Loop, neck_step1_tma_kernel>(f0, B, H, W, C0, kNeck1Smem, stream, w1, vec1,
                                                      u, t, Cm);
  } else {
    constexpr size_t smem1 = kSmem1<bf16>;
    e = allow_smem(neck_step1_kernel<bf16, true>, smem1);
    if (e != cudaSuccess) return (int)e;
    neck_step1_kernel<bf16, true><<<dim3((unsigned)((npix + kBM1 - 1) / kBM1), s1), kThreads, smem1,
                                    stream>>>(f0, w1, vec1, u, t, ws, (int)npix, H, W, C0, Cm);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ln_gelu_rows<bf16><<<rows, kThreads, 0, stream>>>(ws, vec1, u, t, (int)npix, Cm, s1 * kMid);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  if (s2 == 1)
    return (int)launch_step<Neck2Loop, neck_step2_tma_kernel>(t, B, H, W, Cm, kNeck2Smem, stream,
                                                              w2, vec2, out, Co);
  constexpr size_t smem2 = kSmem2<bf16>;
  e = allow_smem(neck_step2_kernel<bf16, true>, smem2);
  if (e != cudaSuccess) return (int)e;
  neck_step2_kernel<bf16, true><<<dim3((unsigned)((npix + kBM2 - 1) / kBM2), s2), kThreads, smem2,
                                  stream>>>(t, w2, vec2, out, ws, (int)npix, H, W, Cm, Co);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ln_gelu_rows<bf16><<<rows, kThreads, 0, stream>>>(ws, vec2, nullptr, out, (int)npix, Co, s2 * kNB);
  return (int)cudaGetLastError();
}

}  // namespace

// The slice widths, and the widest Cm and Co (kMaxSlices slices).
extern "C" int fpn_neck_l0_tile_mid() { return kMid; }
extern "C" int fpn_neck_l0_tile_out() { return kNB; }
extern "C" int fpn_neck_l0_max_mid() { return kMaxSlices * kMid; }
extern "C" int fpn_neck_l0_max_out() { return kMaxSlices * kNB; }

// f0 (B, H, W, C0), u and t (B, H, W, Cm), out (B, H, W, Co), all f32 and
// contiguous; C0 % 4 == 0, Cm % 4 == 0, Co % 4 == 0, Cm <= max_mid, Co <=
// max_out. w1, vec1, w2 and vec2 as the kernels above take them
// (kernels/fpn_neck.py::pack_neck), with ceil(Cm / tile_mid) and
// ceil(Co / tile_out) slices. t is scratch; ws is scratch of B H W x the
// larger of the split steps' slices x tile widths floats where Cm > tile_mid
// or Co > tile_out (else may be null). Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int fpn_neck_l0_f32(const float* f0, const float* u, const float* w1,
                               const float* vec1, const float* w2, const float* vec2, float* t,
                               float* out, float* ws, int B, int H, int W, int C0, int Cm, int Co,
                               cudaStream_t stream) {
  return run_neck<float>(f0, u, w1, vec1, w2, vec2, t, out, ws, B, H, W, C0, Cm, Co, stream);
}

// As fpn_neck_l0_f32 with f0, u, t, out and the packed w1, w2 in bf16 (C0 %
// 8 == 0, Cm % 8 == 0).
extern "C" int fpn_neck_l0_bf16(const __nv_bfloat16* f0, const __nv_bfloat16* u,
                                const __nv_bfloat16* w1, const float* vec1,
                                const __nv_bfloat16* w2, const float* vec2, __nv_bfloat16* t,
                                __nv_bfloat16* out, float* ws, int B, int H, int W, int C0,
                                int Cm, int Co, cudaStream_t stream) {
  return run_neck_bf16(f0, u, w1, vec1, w2, vec2, t, out, ws, B, H, W, C0, Cm, Co, stream);
}

// The widest C0 of the bf16 one-pass step1 (its W1 stays in shared memory).
extern "C" int fpn_neck_l0_bf16_max_c0() { return kMaxC0; }

