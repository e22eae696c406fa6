// The implicit-GEMM convolution shared by the neck and head kernels
// (fpn_neck_l0.cu, and fpn_heads.cu and precise_heads.cu through
// fpn_head.cuh), f32 results from Hopper's tensor cores (sm_90a):
//
//   acc[m][n] = sum_{t, c} x[b, i + oy_t, j + ox_t, c] * w[t][c][n]
//
// where m = (b, i, j) walks the pixels of an NHWC map, t walks the taps of a
// window (a 1x1, a 3x3, or one phase of the heads' collapsed 2x2; the Taps
// table below), and a tap that falls outside the map reads zero (the
// convolution's zero padding). Each kernel follows it with a LayerNorm over
// the output features of one pixel and an exact GELU, so a block owns all
// features of its pixels.
//
// The main loop (mainloop):
//   * A block of 256 threads (two warpgroups) owns BM pixels (flattened over
//     B, H, W) and NB features. Warpgroup w computes 64 pixel rows from
//     `arow` by N0 + N1 features from `nb0`: the heads and the neck's 3x3
//     give each warpgroup its own rows and all features, the neck's 1x1 both
//     the same 64 rows and half the features each.
//   * K is walked 32 input channels of one tap at a time through a ring of
//     STAGES stages in shared memory. The A chunk (BM shifted rows x 32
//     channels) comes by cp.async, whose zero-fill gives the taps outside
//     the map, the channels past C and the pixels past the end. The B chunk
//     (NB x 32, as a TF32 hi part and a lo part) comes by one bulk copy
//     (cp.async.bulk) that completes on an mbarrier; the wrapper packed it
//     once in wgmma's no-swizzle K-major core-matrix order, so the copy is
//     one contiguous run.
//   * The products are wgmma.m64nNk8.f32.tf32.tf32 with A from registers and
//     B from shared memory, N = 96 or 104 a wgmma. Each A value is split in
//     registers into a TF32 hi and lo with integer rounding (cvt.rna.tf32
//     runs on the quarter-rate conversion pipe); B's split was done by the
//     wrapper. Per 8-deep K step: a_lo.b_hi, a_hi.b_lo, a_hi.b_hi (a_lo.b_lo,
//     ~2^-22 relative, is dropped). Within each group of 8 channels, A's
//     register slot s holds channel 2s (s < 4) or 2(s-4)+1, so a thread
//     reads its two channels with one 8-byte load; the wrapper packs B's K
//     order to match.
//   * The tensor core truncates its f32 accumulator after each product, a
//     bias that grows with K (3456 for the neck's 3x3). So each 32-deep
//     chunk's products go into a fresh register tile (scale-d 0 on the
//     first) that is added to the running sum with an ordinary f32 add: one
//     wgmma width at a time, so a thread holds (N0 + N1) / 2 running sums,
//     N0 / 2 fresh and two 8-deep steps' A (hi and lo, 16 registers).
//   * The epilogues read the tile back from shared memory (store_pairs over
//     the ring, then ln_stats a row at a time), so their GELUs do not need
//     the accumulators' registers.
//
// The bf16 main loop (mainloop_bf16; the wide neck and heads, whose
// features run in slices over chunks of flattened pixels; conv_tma.cuh has
// the one-pass kernels' loop) computes the same sums from bf16 operands, one wgmma.m64nNk16.f32.bf16.bf16 a 16-deep step (no split: a
// bf16 product is exact in f32). Its stage holds B (NB x 32, packed by the
// wrapper in the same core-matrix order, 8 bf16 a core-matrix row, K in its
// natural order) and A (BM x 32) laid out in core matrices too: one 16-byte
// cp.async (8 channels of one pixel) is one core-matrix row, so A is read
// by wgmma from shared memory through a descriptor like B, and no register
// holds it. cp.async writes through the generic proxy, so each thread
// fences its copies to the async proxy before the barrier that precedes the
// products. The products accumulate straight into the running sums, with
// no fresh register tile a 32-deep chunk: on an H100 the tile changed
// nothing that a bf16 result keeps (the rough heads at K = 1536 against f64
// on the bf16 operands: 1.982e-05 without it, 1.990e-05 with it) and cost
// 0.224 ms of 0.952 (PERF.md, Findings).
//
// A wait on a copy that never lands traps instead of hanging the card. x
// needs C % 4 == 0 (f32) or C % 8 == 0 (bf16) and 16-byte alignment (the
// wrappers check it).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace conv_gemm {

constexpr float kEps = 1e-6f;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kKC = 32;        // input channels a stage
constexpr int kLdA = kKC + 8;  // padded A row in floats: conflict-free 8-byte reads

// Tap t reads source pixel (i + oy0 + t / kw, j + ox0 + t % kw).
struct Taps {
  int count, kw, oy0, ox0;
};

// The ring of BM pixel rows by NB features.
template <int BM, int NB, int STAGES>
struct Ring {
  static constexpr int B_BYTES = NB * kKC * 4;  // one of hi, lo
  static constexpr int A_BYTES = BM * kLdA * 4;
  static constexpr int STAGE_BYTES = 2 * B_BYTES + A_BYTES;
  static constexpr int BYTES = STAGES * STAGE_BYTES + BM * 4;  // the stages, then a row table
  static constexpr int A_ITERS = BM * (kKC / 4) / kThreads;  // 16-byte A copies a thread
  static_assert(BM % 64 == 0 && NB % 8 == 0 && STAGES >= 2, "ring");
};

// Row stride of an epilogue tile of n features: 8 words mod 32 keeps the
// quad layout's 8-byte accesses conflict-free.
__host__ __device__ constexpr int ldz(int n) { return n + (40 - n % 32) % 32; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

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
// moves the operand 16 bytes on, and adding 64 moves it 8 rows on.
__device__ __forceinline__ uint32_t smem_desc(uint32_t saddr) {
  return ((saddr & 0x3ffffu) >> 4) | ((128u >> 4) << 16);
}
constexpr uint32_t kRowGroup = 1024 >> 4;  // descriptor step of 8 B rows

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
// widths the kernels use.
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
// products still run. after_first() runs once the first step's products
// are issued. Returns when all are done.
template <int NW, int K, class AfterFirst>
__device__ __forceinline__ void chunk_products(float (&part)[K], const float* As, uint32_t hi,
                                               uint32_t lo, AfterFirst after_first) {
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
    if (k8 == 0) after_first();
  }
  wgmma_wait<0>();
  fence_regs(part);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The first row of the 8 + 8 rows this thread holds in its warpgroup's
// accumulator, counted from the warpgroup's first row.
__device__ __forceinline__ int quad_row() {
  return 16 * ((threadIdx.x % 128) / 32) + threadIdx.x % 32 / 4;
}

// The implicit GEMM of one block, BM pixels from m0 by NB features, left in
// registers: acc0 (features nb0 .. nb0 + N0 - 1) and acc1 (the next N1; N1
// may be 0) of rows arow + quad_row() and 8 below it, with arow counted
// from m0. x is (B, H, W, C) with npix = B H W pixels; w is this block's B
// operand, for each of taps.count taps and ceil(C / 32) chunks (tap-major)
// a hi and a lo NB x 32 tile in core-matrix order (row group of 8, K group
// of 4, row, K), K permuted within each 8 as above, zero past C. smem holds
// the ring (Ring<BM, NB, STAGES>::BYTES); bars is the shared address of
// STAGES mbarriers, which this initialises. Anything the block stored to
// shared memory before the call is visible to all after it. Each chunk's
// successor STAGES - 1 on is loaded while the chunk's first products run.
template <int BM, int NB, int STAGES, int N0, int N1, int K0, int K1>
__device__ __forceinline__ void mainloop(const float* __restrict__ x, const float* __restrict__ w,
                                         int npix, int H, int W, int C, Taps taps, int m0,
                                         unsigned char* smem, uint32_t bars, int arow, int nb0,
                                         float (&acc0)[K0], float (&acc1)[K1]) {
  using R = Ring<BM, NB, STAGES>;
  static_assert(K0 == N0 / 2 && (N1 == 0 || K1 == N1 / 2) && N1 <= N0, "accumulators");
  const int tid = threadIdx.x;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // The table after the stages: (i << 16) | j of each row's pixel.
  int* a_ij = reinterpret_cast<int*>(smem + STAGES * R::STAGE_BYTES);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = tid; r < BM; r += kThreads) {
    const int rem = (m0 + r) % (H * W);
    a_ij[r] = ((rem / W) << 16) | (rem % W);
  }
  __syncthreads();

  // The A pieces this thread copies: rows tid / 8 + 32 r, channels
  // 4 (tid % 8) .. + 3 of every chunk.
  const int chunks = (C + kKC - 1) / kKC;
  const int nk = taps.count * chunks;
  const int q = tid % 8;
  auto load = [&](int kt) {
    if (kt >= nk) return;
    const int t = kt / chunks, c = (kt - t * chunks) * kKC + 4 * q;
    const int oy = taps.oy0 + t / taps.kw, ox = taps.ox0 + t % taps.kw;
    const int s = kt % STAGES;
    const uint32_t stage = sbase + s * R::STAGE_BYTES;
    if (tid == 0) bulk_load(stage, w + (long long)kt * 2 * NB * kKC, 2 * R::B_BYTES, bars + 8 * s);
    float* As = reinterpret_cast<float*>(smem + s * R::STAGE_BYTES + 2 * R::B_BYTES);
#pragma unroll
    for (int r = 0; r < R::A_ITERS; ++r) {
      const int m = m0 + tid / 8 + 32 * r, ij = a_ij[tid / 8 + 32 * r];
      const int iy = (ij >> 16) + oy, ix = (ij & 0xffff) + ox;
      const bool ok = m < npix && iy >= 0 && iy < H && ix >= 0 && ix < W && c < C;
      const float* src = ok ? x + ((long long)(m + oy * W + ox) * C + c) : x;
      cp_async16(As + (tid / 8 + 32 * r) * kLdA + 4 * q, src, ok);
    }
  };

  const int t4 = tid % 4;
  const int row = arow + quad_row();
  float part[N0 / 2];
#pragma unroll
  for (int i = 0; i < K0; ++i) acc0[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < K1; ++i) acc1[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < N0 / 2; ++i) part[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    cp_async_wait<STAGES - 2>();
    mbar_wait(bars + 8 * s, (kt / STAGES) & 1);
    __syncthreads();  // chunk kt landed for all; chunk kt-1's stage is free

    const float* As = reinterpret_cast<const float*>(smem + s * R::STAGE_BYTES + 2 * R::B_BYTES) +
                      row * kLdA + 2 * t4;
    const uint32_t hi = smem_desc(sbase + s * R::STAGE_BYTES) + (nb0 / 8) * kRowGroup;
    const uint32_t lo = hi + (R::B_BYTES >> 4);
    // The next load goes into chunk kt-1's stage; issuing it behind the
    // first products keeps its address work off the tensor cores' path.
    chunk_products<N0>(part, As, hi, lo, [&] {
      load(kt + STAGES - 1);
      cp_async_commit();
    });
#pragma unroll
    for (int i = 0; i < K0; ++i) acc0[i] += part[i];
    if constexpr (N1 > 0) {
      const uint32_t second = (N0 / 8) * kRowGroup;  // the second width's first row group
      chunk_products<N1>(part, As, hi + second, lo + second, [] {});
#pragma unroll
      for (int i = 0; i < K1; ++i) acc1[i] += part[i];
    }
  }
  cp_async_wait<0>();
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

// LayerNorm statistics of one row of an epilogue tile, held by a quad:
// thread t4 reads zr[8 j] and zr[8 j + 1] for j < NB / 8 (zr is the row plus
// 2 t4). Mean, then biased variance over the first F features (the row is
// zero past F); returns the mean and sets rstd = 1 / sqrt(var + eps).
template <int NB>
__device__ __forceinline__ float ln_stats(const float* zr, int F, int t4, float& rstd) {
  const float inv_f = 1.0f / F;
  float sum = 0.0f;
#pragma unroll 5
  for (int j = 0; j < NB / 8; ++j) sum += zr[8 * j] + zr[8 * j + 1];
  const float mean = quad_sum(sum) * inv_f;
  float sq = 0.0f;
#pragma unroll 5
  for (int j = 0; j < NB / 8; ++j) {
    const int n = 8 * j + 2 * t4;
    const float d0 = zr[8 * j] - mean, d1 = zr[8 * j + 1] - mean;
    if (n < F) sq = fmaf(d0, d0, sq);
    if (n + 1 < F) sq = fmaf(d1, d1, sq);
  }
  rstd = rsqrtf(quad_sum(sq) * inv_f + kEps);
  return mean;
}

// ---------------------------------------------------------------------------
// bf16 operands.

using bf16 = __nv_bfloat16;

// f32 -> bf16, round to nearest even, and back: what a cast to bf16 keeps.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float load_one(const float* p) { return *p; }
__device__ __forceinline__ float load_one(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Makes this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int BM, int NB, int STAGES>
struct RingBf16 {
  static constexpr int B_BYTES = NB * kKC * 2;
  static constexpr int A_BYTES = BM * kKC * 2;
  static constexpr int STAGE_BYTES = B_BYTES + A_BYTES;
  static constexpr int BYTES = STAGES * STAGE_BYTES + BM * 4;  // the stages, then a row table
  static constexpr int A_ITERS = BM * (kKC / 8) / kThreads;  // 16-byte A copies a thread
  static_assert(BM % 64 == 0 && NB % 8 == 0 && STAGES >= 2, "ring");
};

// The ring a main loop over operands of type T uses.
template <typename T, int BM, int NB, int STAGES>
struct RingFor {
  using type = Ring<BM, NB, STAGES>;
};
template <int BM, int NB, int STAGES>
struct RingFor<bf16, BM, NB, STAGES> {
  using type = RingBf16<BM, NB, STAGES>;
};
// Packed B parts a chunk: hi and lo for f32, one for bf16.
template <typename T>
constexpr int kParts = std::is_same<T, float>::value ? 2 : 1;

// Descriptor of a bf16 K-major operand without swizzle: core matrices of 8
// rows x 8 bf16, the next along K 128 bytes on; the wrappers' high word is
// the 512 bytes to the next 8 rows (4 core matrices of K a 32-deep chunk).
__device__ __forceinline__ uint32_t smem_desc_bf16(uint32_t saddr) {
  return ((saddr & 0x3ffffu) >> 4) | ((128u >> 4) << 16);
}
constexpr uint32_t kRowGroupBf16 = 512 >> 4;  // descriptor step of 8 rows
constexpr uint32_t kK16Bf16 = 256 >> 4;       // descriptor step of 16 K

// wgmma.m64nNk16.f32.bf16.bf16, A and B from shared memory: d (64 x N, f32)
// += A (64 x 16) . B (N x 16), or d = A . B when scale_d is 0; d's register
// order is the one of wgmma_n96.
template <int K>
__device__ __forceinline__ void wgmma_bf16_n96(float (&d)[K], uint32_t desc_a, uint32_t desc_b,
                                               int scale_d) {
  static_assert(K >= 48, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 h;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "mov.b32 h, 32;\n"
      "mov.b64 da, {%48, h};\n"
      "mov.b64 db, {%49, h};\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(desc_a), "r"(desc_b), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void wgmma_bf16_n104(float (&d)[K], uint32_t desc_a, uint32_t desc_b,
                                                int scale_d) {
  static_assert(K >= 52, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 h;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %54, 0;\n"
      "mov.b32 h, 32;\n"
      "mov.b64 da, {%52, h};\n"
      "mov.b64 db, {%53, h};\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51"
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(desc_a), "r"(desc_b), "r"(scale_d));
}

template <int NW, int K>
__device__ __forceinline__ void wgmma_bf16(float (&d)[K], uint32_t desc_a, uint32_t desc_b,
                                           int scale_d) {
  if constexpr (NW == 96) {
    wgmma_bf16_n96(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(NW == 104, "wgmma width");
    wgmma_bf16_n104(d, desc_a, desc_b, scale_d);
  }
}

// mainloop's contract with bf16 x and w: w holds, per tap and chunk, one
// NB x 32 bf16 tile in core-matrix order (row group of 8, K group of 8,
// row, K), zero past C; x needs C % 8 == 0.
template <int BM, int NB, int STAGES, int N0, int N1, int K0, int K1>
__device__ __forceinline__ void mainloop_bf16(const bf16* __restrict__ x,
                                              const bf16* __restrict__ w, int npix, int H,
                                              int W, int C, Taps taps, int m0,
                                              unsigned char* smem, uint32_t bars, int arow,
                                              int nb0, float (&acc0)[K0], float (&acc1)[K1]) {
  using R = RingBf16<BM, NB, STAGES>;
  static_assert(K0 == N0 / 2 && (N1 == 0 || K1 == N1 / 2) && N1 <= N0, "accumulators");
  const int tid = threadIdx.x;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int* a_ij = reinterpret_cast<int*>(smem + STAGES * R::STAGE_BYTES);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = tid; r < BM; r += kThreads) {
    const int rem = (m0 + r) % (H * W);
    a_ij[r] = ((rem / W) << 16) | (rem % W);
  }
  __syncthreads();

  // The A pieces this thread copies: rows tid / 4 + 64 r, channels
  // 8 (tid % 4) .. + 7 of every chunk, each one core-matrix row.
  const int chunks = (C + kKC - 1) / kKC;
  const int nk = taps.count * chunks;
  const int q = tid % 4;
  auto load = [&](int kt) {
    if (kt >= nk) return;
    const int t = kt / chunks, c = (kt - t * chunks) * kKC + 8 * q;
    const int oy = taps.oy0 + t / taps.kw, ox = taps.ox0 + t % taps.kw;
    const int s = kt % STAGES;
    const uint32_t stage = sbase + s * R::STAGE_BYTES;
    if (tid == 0) bulk_load(stage, w + (long long)kt * NB * kKC, R::B_BYTES, bars + 8 * s);
    unsigned char* As = smem + s * R::STAGE_BYTES + R::B_BYTES;
#pragma unroll
    for (int r = 0; r < R::A_ITERS; ++r) {
      const int row = tid / 4 + 64 * r;
      const int m = m0 + row, ij = a_ij[row];
      const int iy = (ij >> 16) + oy, ix = (ij & 0xffff) + ox;
      const bool ok = m < npix && iy >= 0 && iy < H && ix >= 0 && ix < W && c < C;
      const bf16* src = ok ? x + ((long long)(m + oy * W + ox) * C + c) : x;
      cp_async16(As + ((row >> 3) * 4 + q) * 128 + (row & 7) * 16, src, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < K0; ++i) acc0[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < K1; ++i) acc1[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    mbar_wait(bars + 8 * s, (kt / STAGES) & 1);
    __syncthreads();  // chunk kt landed for all; chunk kt-1's stage is free

    const uint32_t stage = sbase + s * R::STAGE_BYTES;
    const uint32_t a = smem_desc_bf16(stage + R::B_BYTES) + (arow / 8) * kRowGroupBf16;
    const uint32_t b = smem_desc_bf16(stage) + (nb0 / 8) * kRowGroupBf16;
    const uint32_t second = (N0 / 8) * kRowGroupBf16;  // the second width's first row group
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < kKC / 16; ++k16) {
      wgmma_bf16<N0>(acc0, a + k16 * kK16Bf16, b + k16 * kK16Bf16, 1);
      if constexpr (N1 > 0)
        wgmma_bf16<N1>(acc1, a + k16 * kK16Bf16, b + second + k16 * kK16Bf16, 1);
    }
    wgmma_commit();
    // The next load goes into chunk kt-1's stage, behind the products.
    load(kt + STAGES - 1);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
  }
  cp_async_wait<0>();
}

// The main loop for operands of type T (float: 3xTF32, bf16: one product).
template <typename T, int BM, int NB, int STAGES, int N0, int N1, int K0, int K1>
__device__ __forceinline__ void conv_mainloop(const T* __restrict__ x, const T* __restrict__ w,
                                              int npix, int H, int W, int C, Taps taps, int m0,
                                              unsigned char* smem, uint32_t bars, int arow,
                                              int nb0, float (&acc0)[K0], float (&acc1)[K1]) {
  if constexpr (std::is_same<T, float>::value)
    mainloop<BM, NB, STAGES, N0, N1>(x, w, npix, H, W, C, taps, m0, smem, bars, arow, nb0, acc0,
                                     acc1);
  else
    mainloop_bf16<BM, NB, STAGES, N0, N1>(x, w, npix, H, W, C, taps, m0, smem, bars, arow, nb0,
                                          acc0, acc1);
}

// Stores a warpgroup accumulator plus the bias to a row-major f32 (npix x
// ld) map of pre-LayerNorm sums, for features from n0 (columns n0 + ... of
// the map; the bias from bias[n0 + ...]): the thread's rows are m and m + 8.
template <int K>
__device__ __forceinline__ void store_sums(const float (&a)[K], float* __restrict__ ws, int m,
                                           int npix, long long ld, int n0, int t4,
                                           const float* __restrict__ bias) {
#pragma unroll
  for (int i = 0; i < K; i += 2) {
    const int n = n0 + 8 * (i / 4) + 2 * t4;
    const int r = m + ((i >> 1) & 1) * 8;
    if (r < npix)
      *reinterpret_cast<float2*>(ws + r * ld + n) =
          make_float2(a[i] + __ldg(bias + n), a[i + 1] + __ldg(bias + n + 1));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// LayerNorm statistics of one row of F pre-LN sums, held by a warp (lane l
// reads z[l], z[l + 32], ...): mean, then biased variance; sets rstd.
__device__ __forceinline__ float warp_ln_stats(const float* __restrict__ z, int F, float& rstd) {
  const int lane = threadIdx.x % 32;
  float sum = 0.0f;
  for (int n = lane; n < F; n += 32) sum += z[n];
  const float mean = warp_sum(sum) / F;
  float sq = 0.0f;
  for (int n = lane; n < F; n += 32) {
    const float d = z[n] - mean;
    sq = fmaf(d, d, sq);
  }
  rstd = rsqrtf(warp_sum(sq) / F + kEps);
  return mean;
}

// Opts a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace conv_gemm
