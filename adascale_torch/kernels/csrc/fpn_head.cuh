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
// Design (one launch):
//   * A block owns one head at one phase for kBM = 128 low-resolution pixels
//     (flattened over B, H, W) and all of the head's features, padded to N
//     (a multiple of 8; the wrapper zero-pads the weights). 256 threads are
//     two warpgroups; warpgroup w owns pixel rows 64w..64w+63 and all N
//     features, so a row's LayerNorm sums are two quad shuffles. The blocks
//     of one pixel tile (all heads and phases) are adjacent in the grid, so
//     the tile's input is read from L2: x passes through L2 once per
//     (head, phase), 8 times (rough) or 16 times (precise).
//   * K is walked 32 input channels of one tap at a time through a
//     three-stage ring in shared memory. The A chunk (128 shifted rows x 32
//     channels) comes by cp.async, whose zero-fill gives the taps outside
//     the map, the channels past C and the pixels past the end. The B chunk
//     (the collapsed taps, N x 32, as a TF32 hi part and a lo part, 256 N
//     bytes) comes by one bulk copy (cp.async.bulk) that completes on an
//     mbarrier; the wrapper packed it once in wgmma's no-swizzle K-major
//     core-matrix order, so the copy is one contiguous run.
//   * The products are wgmma.m64nNk8.f32.tf32.tf32 with A from registers
//     and B from shared memory, N split as N0 + N1 (96 + 96 or 104 + 96).
//     Each A value is split in registers into a TF32 hi and lo with integer
//     rounding (cvt.rna.tf32 runs on the quarter-rate conversion pipe); B's
//     split was done by the wrapper. Per 8-deep K step: a_lo.b_hi,
//     a_hi.b_lo, a_hi.b_hi (a_lo.b_lo, ~2^-22 relative, is dropped).
//     Within each group of 8 channels, A's register slot s holds channel
//     2s (s < 4) or 2(s-4)+1, so a thread reads its two channels with one
//     8-byte load; the wrapper packs B's K order to match.
//   * The tensor core truncates its f32 accumulator after each product, a
//     bias that grows with K (1536 per phase at the flagship). So each
//     32-deep chunk's products go into a fresh register tile (scale-d 0 on
//     the first) that is added to the running sum with an ordinary f32 add:
//     one N half at a time, so a thread holds N/2 running sums, N0/2 fresh
//     and two 8-deep steps' A (hi and lo, 16 registers) at once.
//   * The epilogue stays in the block: the tile plus the bias goes to shared
//     memory over the ring and each thread reads back its two rows (so the
//     GELUs do not need the accumulators' registers); LayerNorm over the
//     head's real F features (mean, then biased variance, eps 1e-6; a row's
//     features lie in one quad, so each sum is two shuffles), exact erf
//     GELU, the projection to the head's M <= 4 channels, and the
//     interleaved (B, 2H, 2W, Mtot) write, each head at its own channel
//     offset.
//
// A wait on a copy that never lands traps instead of hanging the card.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_gemm.cuh"

namespace fpn_head {

using conv_gemm::allow_smem;
using conv_gemm::cp_async16;
using conv_gemm::cp_async_commit;
using conv_gemm::cp_async_wait;
using conv_gemm::gelu_exact;
using conv_gemm::kEps;

constexpr int kMaxHeads = 4;
constexpr int kMaxOut = 4;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // low-resolution pixels a block
constexpr int kKC = 32;        // input channels a stage
constexpr int kStages = 3;
constexpr int kLdA = kKC + 8;  // padded A row in floats: conflict-free 8-byte reads

struct HeadSizes {
  int F[kMaxHeads];
  int M[kMaxHeads];
  int moff[kMaxHeads];
};

template <int N>
struct Layout {
  static constexpr int N0 = (N / 2 + 7) / 8 * 8;  // the two wgmma widths
  static constexpr int N1 = N - N0;
  static constexpr int B_BYTES = N * kKC * 4;  // one of hi, lo
  static constexpr int A_BYTES = kBM * kLdA * 4;
  static constexpr int STAGE_BYTES = 2 * B_BYTES + A_BYTES;
  static constexpr int VEC_BYTES = (3 + kMaxOut) * N * 4;  // the head's epilogue vectors
  // Row stride of the epilogue's tile: 8 words mod 32 keeps the quad
  // layout's 8-byte stores conflict-free.
  static constexpr int LDZ = N + (40 - N % 32) % 32;
  static constexpr size_t SMEM_BYTES = (size_t)kStages * STAGE_BYTES + VEC_BYTES + 8 * kStages;
  static_assert(N % 8 == 0 && (N0 == 96 || N0 == 104) && N1 == 96, "head width");
  static_assert(kBM * LDZ * 4 <= kStages * STAGE_BYTES, "epilogue tile");
};

// v = hi + lo, both TF32: round to nearest (ties away) on the 13 bits TF32
// drops. The tensor core reads only the top 19 bits of an operand, so lo is
// passed rounded the same way without its mask.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

// The low word of a shared-memory matrix descriptor of a K-major operand
// without swizzle: core matrices of 8 rows x 16 bytes (128 contiguous
// bytes), the next along K 128 bytes on (leading byte offset, bits 16-29);
// the high word, which the wgmma wrappers add, holds the stride byte offset,
// 1024 bytes to the next 8 rows (a row group holds all 32 K of a chunk).
// Addresses and offsets are in 16-byte units, so adding one to the word
// moves the operand 16 bytes on.
__device__ __forceinline__ uint32_t smem_desc(uint32_t saddr) {
  return ((saddr & 0x3ffffu) >> 4) | ((128u >> 4) << 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most `pending` committed groups are still running.
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending) : "memory");
}
// Keeps the compiler from touching the registers across an async wgmma.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival that also expects `bytes` from the bulk copy it announces.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1 << 24)) __trap();
  }
}

// wgmma.m64nNk8.f32.tf32.tf32 on one warpgroup, A (64 x 8) from registers
// in the m16n8k8 fragment order of each warp's 16 rows, B (N x 8) from
// shared memory: d (64 x N, f32) += A . B, or d = A . B when scale_d is 0.
// Thread (g, t) of warp w holds d[4 j + e] = row 16 w + g + 8 (e / 2),
// column 8 j + 2 t + e % 2.
template <int K>
__device__ __forceinline__ void wgmma_n96(float (&d)[K], const uint32_t (&a)[4], uint32_t desc_b,
                                          int scale_d) {
  static_assert(K >= 48, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 h;\n.reg .b64 desc;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "mov.b32 h, 64;\n"
      "mov.b64 desc, {%52, h};\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
      "}, {%48,%49,%50,%51}, desc, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(desc_b), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void wgmma_n104(float (&d)[K], const uint32_t (&a)[4], uint32_t desc_b,
                                          int scale_d) {
  static_assert(K >= 52, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 h;\n.reg .b64 desc;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "mov.b32 h, 64;\n"
      "mov.b64 desc, {%56, h};\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51"
      "}, {%52,%53,%54,%55}, desc, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(desc_b), "r"(scale_d));
}

// d (64 x NW) of one warpgroup += A (64 x 8) . B (NW x 8), for the two
// widths the heads use.
template <int NW, int K>
__device__ __forceinline__ void wgmma(float (&d)[K], const uint32_t (&a)[4], uint32_t desc_b,
                                      int scale_d) {
  if constexpr (NW == 96) {
    wgmma_n96(d, a, desc_b, scale_d);
  } else {
    static_assert(NW == 104, "wgmma width");
    wgmma_n104(d, a, desc_b, scale_d);
  }
}

// part (replaced) = the 3xTF32 products of one 32-deep chunk for NW
// features, whose hi and lo B tiles start at descriptors hi and lo; As is
// this thread's first A element (row g, channel 2 t4). Each 8-deep step's A
// is read and split just before its products, into one of two register
// buffers: the step two back must be done with it, while the last step's
// products still run. Returns when all are done.
template <int NW, int K>
__device__ __forceinline__ void chunk_products(float (&part)[K], const float* As, uint32_t hi,
                                               uint32_t lo) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int k8 = 0; k8 < kKC / 8; ++k8) {
    uint32_t(&h)[4] = ah[k8 % 2];
    uint32_t(&l)[4] = al[k8 % 2];
    if (k8 >= 2) wgmma_wait<1>();
    const float2 v0 = *reinterpret_cast<const float2*>(As + 8 * k8);
    const float2 v1 = *reinterpret_cast<const float2*>(As + 8 * kLdA + 8 * k8);
    split_tf32(v0.x, h[0], l[0]);
    split_tf32(v1.x, h[1], l[1]);
    split_tf32(v0.y, h[2], l[2]);
    split_tf32(v1.y, h[3], l[3]);
    const uint32_t step = 16 * k8;  // 256 bytes a K step
    wgmma_fence();
    wgmma<NW>(part, l, hi + step, k8 > 0);
    wgmma<NW>(part, h, lo + step, 1);
    wgmma<NW>(part, h, hi + step, 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(part);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stores a warpgroup accumulator plus the bias, for features from n0: the
// thread's rows g and g + 8 go to zrow and zrow + 8 ld. Register i of thread
// t4 holds feature n0 + 8 (i / 4) + 2 t4 + i % 2 of row (i / 2) % 2.
template <int K>
__device__ __forceinline__ void store_pairs(const float (&a)[K], float* zrow, int ld, int n0,
                                            int t4, const float* bias) {
#pragma unroll
  for (int i = 0; i < K; i += 2) {
    const int n = n0 + 8 * (i / 4) + 2 * t4;
    *reinterpret_cast<float2*>(zrow + ((i >> 1) & 1) * 8 * ld + n) =
        make_float2(a[i] + bias[n], a[i + 1] + bias[n + 1]);
  }
}

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
  const int chunks = (C + kKC - 1) / kKC;
  const int nk = 4 * chunks;
  const float* wb = w + (long long)(head * 4 + phase) * nk * 2 * N * kKC;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // The head's bias, LN scale, LN bias (N each) and projection (kMaxOut x N)
  // for the epilogue, after the ring; then the ring's mbarriers.
  float* sv = reinterpret_cast<float*>(smem + kStages * L::STAGE_BYTES);
  for (int i = tid; i < 3 * N; i += kThreads) sv[i] = vec[head * 3 * N + i];
  for (int i = tid; i < kMaxOut * N; i += kThreads) sv[3 * N + i] = w2[head * kMaxOut * N + i];
  const uint32_t bars = sbase + kStages * L::STAGE_BYTES + L::VEC_BYTES;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The A pieces this thread copies: rows tid / 8 + 32 r, channels
  // 4 (tid % 8) .. + 3 of every chunk.
  constexpr int A_ITERS = kBM * (kKC / 4) / kThreads;
  const int q = tid % 8;
  int a_ij[A_ITERS];  // (i << 16) | j of each row's pixel
#pragma unroll
  for (int r = 0; r < A_ITERS; ++r) {
    const int rem = (m0 + tid / 8 + 32 * r) % (H * W);
    a_ij[r] = ((rem / W) << 16) | (rem % W);
  }
  auto load = [&](int kt, int s) {
    const int t = kt / chunks, c = (kt - t * chunks) * kKC + 4 * q;
    const int oy = pa - 1 + t / 2, ox = pb - 1 + t % 2;
    const uint32_t stage = sbase + s * L::STAGE_BYTES;
    if (tid == 0) bulk_load(stage, wb + (long long)kt * 2 * N * kKC, 2 * L::B_BYTES, bars + 8 * s);
    float* As = reinterpret_cast<float*>(smem + s * L::STAGE_BYTES + 2 * L::B_BYTES);
#pragma unroll
    for (int r = 0; r < A_ITERS; ++r) {
      const int m = m0 + tid / 8 + 32 * r;
      const int iy = (a_ij[r] >> 16) + oy, ix = (a_ij[r] & 0xffff) + ox;
      const bool ok = m < npix && iy >= 0 && iy < H && ix >= 0 && ix < W && c < C;
      const float* src = ok ? x + ((long long)(m + oy * W + ox) * C + c) : x;
      cp_async16(As + (tid / 8 + 32 * r) * kLdA + 4 * q, src, ok);
    }
  };

  const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int row0 = 64 * (tid / 128) + 16 * ((tid % 128) / 32) + g;  // and row0 + 8
  float acc0[N0 / 2], acc1[N1 / 2], part[N0 / 2];
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) acc0[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < N1 / 2; ++i) acc1[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) part[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    cp_async_wait<kStages - 2>();
    mbar_wait(bars + 8 * s, (kt / kStages) & 1);
    __syncthreads();  // chunk kt landed for all; chunk kt-1's stage is free
    const int next = kt + kStages - 1;
    if (next < nk) load(next, next % kStages);
    cp_async_commit();

    const float* As = reinterpret_cast<const float*>(smem + s * L::STAGE_BYTES + 2 * L::B_BYTES) +
                      row0 * kLdA + 2 * t4;
    const uint32_t hi = smem_desc(sbase + s * L::STAGE_BYTES), lo = hi + (L::B_BYTES >> 4);
    chunk_products<N0>(part, As, hi, lo);
#pragma unroll
    for (int i = 0; i < N0 / 2; ++i) acc0[i] += part[i];
    const uint32_t half = (N0 / 8) * (1024 >> 4);  // the second width's first row group
    chunk_products<N1>(part, As, hi + half, lo + half);
#pragma unroll
    for (int i = 0; i < N1 / 2; ++i) acc1[i] += part[i];
  }
  cp_async_wait<0>();

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
  store_pairs(acc0, z + row0 * L::LDZ, L::LDZ, 0, t4, sv);
  store_pairs(acc1, z + row0 * L::LDZ, L::LDZ, N0, t4, sv);
  __syncwarp();  // a row's features come from the four threads of its quad
  const float inv_f = 1.0f / F;
  const int hw = H * W;
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const float* zr = z + (row0 + 8 * r) * L::LDZ + 2 * t4;
    // z is zero past F.
    float sum = 0.0f;
#pragma unroll 5
    for (int j = 0; j < N / 8; ++j) sum += zr[8 * j] + zr[8 * j + 1];
    const float mean = quad_sum(sum) * inv_f;
    float sq = 0.0f;
#pragma unroll 5
    for (int j = 0; j < N / 8; ++j) {
      const int n = 8 * j + 2 * t4;
      const float d0 = zr[8 * j] - mean, d1 = zr[8 * j + 1] - mean;
      if (n < F) sq = fmaf(d0, d0, sq);
      if (n + 1 < F) sq = fmaf(d1, d1, sq);
    }
    const float rstd = rsqrtf(quad_sum(sq) * inv_f + kEps);
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
