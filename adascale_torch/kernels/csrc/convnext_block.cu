// One ConvNeXt residual block in f32 for Hopper (sm_90a), NHWC:
//
//   out = x + scale * (W2 · GELU(W1 · LN(dwconv7x7(x) + dw_b) + b1) + b2)
//
// Replaces the Pallas TPU kernel adascale/ops/pallas/convnext_block.py::
// fused_convnext_block (pallas_call at :290, kernel body `_kernel` at :68).
// Same arithmetic: zero-padded depthwise 7x7 with bias, LayerNorm in f32
// (eps 1e-6, biased variance, two passes), Linear C->4C, exact erf GELU,
// Linear 4C->C, layer scale, residual add. No channel padding and no erf
// stand-in: those were TPU constraints.
//
// What bounds it: per pixel 2*49*C (depthwise) + 16*C^2 (the two
// projections) flops against 8*C bytes (x in, out written), so the block is
// bound by operations. As this kernel computes them (H100 SXM, 700 W: the
// projections as three TF32 products at 495/3 TFLOP/s, the depthwise at the
// 67 TFLOP/s f32 peak) that is 0.04-0.05 ms per block at every stage of a
// 1024x768 page; at the f32 SIMT peak alone, 0.10-0.12 ms.
//
// Design, three launches (four with split-K):
//   1. dw_ln_kernel<TH, TW, CH>: a block owns a TH x TW pixel tile and all C
//      channels. It walks C in chunks of 32 channels (lane = channel): the
//      tile's input rows with their 3-pixel halo and the chunk's 49 taps are
//      staged in shared memory through a two-stage cp.async ring; each
//      thread keeps its channel's taps in registers and slides a row window
//      over its warp's run of TH*TW/8 pixels, so an input value is loaded
//      once per row for 7 outputs. The pre-LN values stay in registers
//      (CH chunks x run), so the LayerNorm (two passes, warp shuffles) reads
//      nothing back; h = LN(...) goes to the workspace.
//   2. gemm_3xtf32_kernel (GELU epilogue): u = GELU(h · W1^T + b1), M = pixels,
//      N = 4C, K = C. The 4C hidden goes through device memory: at the first
//      rough stage that is 70.8 MB written and read, ~42 us at 3.35 TB/s,
//      against ~110 us of operations. A variant that kept it on chip for
//      C <= 192 (128-unit chunks through shared memory, GEMM 2 accumulating
//      C-wide in registers) was no faster on the card: the products' issue
//      rate, not the hidden's bytes, bounds these GEMMs. At C = 768 its
//      accumulators would not fit.
//   3. gemm_3xtf32_kernel (residual epilogue): out = x + (u · W2^T + b2) * scale,
//      N = C, K = 4C. When the output tiles alone would leave most of the
//      last wave of blocks idle (the late stages: 720-3328 pixels), K is
//      split across up to 8 blocks that write their partial sums to the
//      workspace, and reduce_kernel adds them in split order and applies the
//      epilogue, so the result does not depend on scheduling.
//
// The two products run on the tensor cores at f32 accuracy: mma.sync
// m16n8k8 TF32 with an error-compensated split of both operands,
// a = a_hi + a_lo, accumulating a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32
// (the a_lo*b_lo term, ~2^-22 relative, is dropped). mma.sync reaches only
// part of the card's 495 TFLOP/s TF32 rate (all of it needs wgmma), and
// three products divide what it reaches by three. A block owns 64 pixels x 96 or 128
// features with 8 warps as 2 x 4, K is staged 32 at a time through a
// three-stage cp.async ring, and each staged weight is reused across 64
// pixels. Both operands are K-contiguous (h and u row-major, W1 and W2 in
// nn.Linear's (out, in) layout), so the wrapper packs nothing.
//
// matmul_precision "default" / "high" (the JAX engine's
// jax.default_matmul_precision scope; XLA computes an f32 product on a GPU
// there as one TF32 pass) is the entry convnext_block_tf32, this file built
// with -DCONVNEXT_BLOCK_TF32 (a library of its own, compiled beside the
// others), with a Hopper design of its own (block_tf32.cuh): the depthwise
// + LN below, then the
// MLP on TF32 wgmma, both operands of each product rounded to TF32 (to
// nearest, ties away) and f32 sums: for C <= 192 one kernel with the 4C
// hidden on chip (GEMM 1 from shared memory, GELU, u rounded into
// registers, GEMM 2 with A from registers), wider two TMA-fed wgmma GEMMs
// with u through memory and a split of GEMM 2 chosen for one image (so the
// entry is batch-invariant). W1 and W2 come packed and rounded once per
// parameter set (kernels/packing.py::pack_block_tf32). It replaced these
// kernels run at one pass (gemm_tf32_kernel: mma.sync, operands rounded on
// every fragment load, u through memory): on mma.sync the products could
// not reach the 495 TFLOP/s TF32 rate, which only wgmma does. Bound: the
// projections at 495 TFLOP/s, a third of the 3xTF32 bound's products, the
// depthwise unchanged.
//
// C must be a multiple of 4 (16-byte copies), C <= 1536; pixels, channels
// and hidden units are masked.
//
// bf16 (the JAX package's compute_dtype="bfloat16"), two modes, each a
// template instantiation (no branch in the loops), both with the depthwise
// and LayerNorm in f32 and the MLP on Hopper's bf16 wgmma with f32 sums
// (block_bf16.cuh: a channel-parallel depthwise + LN writing h in bf16;
// the 4C hidden kept on chip in one kernel for C <= 192, two wgmma GEMMs
// with u in bf16 above; W1 and W2 packed once per parameter set by the
// wrapper):
//   * Pallas mode (x and out bf16; adascale/ops/pallas/convnext_block.py:
//     60-99, the JAX engine's use_pallas_backbone): the depthwise and LN in
//     f32 on f32 taps, h cast to bf16 for the up product, GELU in f32 on
//     the f32 sum plus bias, cast to bf16 for the down product, the
//     residual x + (y + b2) * scale in f32, then cast to bf16: the
//     residual stream between blocks is bf16;
//   * module mode (x and out f32; the Flax ConvNeXtBlockLayer at
//     dtype=bfloat16, adascale/models/convnext.py:53-88): rounded to bf16
//     where Flax rounds, after the input cast, the depthwise (on bf16 taps)
//     and its bias, the LN, each Dense and its bias, and inside the GELU as
//     XLA computes jax.nn.gelu on bf16 (gelu_bf16); the residual
//     x + y * scale stays f32.
// The bf16 entry points are this file built with -DCONVNEXT_BLOCK_BF16 and
// -DCONVNEXT_BLOCK_BF16_MODULE=0 or 1 (the Pallas or the module mode), two
// libraries of their own (kernels/convnext_block.py::build_bf16), so that
// the four compile in parallel; each holds only its own instantiations,
// and only they launch block_bf16.cuh's kernels (the f32 library includes
// it for the helpers block_tf32.cuh shares). C must be a multiple of 8 (16-byte
// copies of bf16). Bound: the projections at the 989 TFLOP/s dense bf16
// rate, the depthwise at the 67 TFLOP/s f32 peak: 0.012-0.02 ms a block at
// the stages of a 1024x768 page.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#ifdef CONVNEXT_BLOCK_BF16  // the bf16 libraries: the block in block_bf16.cuh
#include "block_bf16.cuh"
#else  // the f32 libraries: 3xTF32, or (CONVNEXT_BLOCK_TF32) the single-pass TF32 entry
#ifdef CONVNEXT_BLOCK_TF32
#include "block_tf32.cuh"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 1536;
constexpr float kEps = 1e-6f;

// GEMM tiling: 64-pixel row tiles, K staged 32 at a time through a
// three-stage ring (two blocks per SM).
constexpr int kBM = 64;
constexpr int kBK = 32;
constexpr int kLd = kBK + 8;  // padded shared row, in floats
constexpr int kStages = 3;
constexpr int kMaxSplits = 8;

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

using bf16 = __nv_bfloat16;

// f32 -> bf16 (round to nearest even) -> f32: what a cast to bf16 keeps.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// 1. Depthwise 7x7 + bias + LayerNorm.

template <int TH, int TW, int CH, typename XT>
struct DwTile {
  static constexpr int P = TH * TW;     // pixels of the tile
  static constexpr int R = P / 8;       // pixels of one warp's run (one row)
  static constexpr int SH = TH + 6, SW = TW + 6;
  // Bytes of one staged chunk: the input rows, then the chunk's 32 x 49 f32 taps.
  static constexpr int X_BYTES = SH * SW * 32 * (int)sizeof(XT);
  static constexpr int STAGE_BYTES = X_BYTES + 32 * 49 * 4;
  static constexpr size_t SMEM_BYTES = (size_t)2 * STAGE_BYTES;
  static_assert(TW % R == 0, "a warp's run stays in one row");
};

// CH: the most 32-channel chunks (C <= 32 * CH). Each thread keeps the
// pre-LN values of its channel in every chunk for its warp's R pixels in
// registers (CH * R of them), so the LayerNorm reads no shared memory.
// XT: x's type (float, or bf16 in the Pallas mode); HT: h's (float, or bf16
// for the bf16 GEMMs); ROUND: the module mode's bf16 roundings (x and the
// taps on load, the depthwise, its bias and their sum).
template <int TH, int TW, int CH, typename XT, typename HT, bool ROUND>
__global__ void __launch_bounds__(kThreads)
dw_ln_kernel(const XT* __restrict__ x, const float* __restrict__ dw_w,
             const float* __restrict__ dw_b, const float* __restrict__ ln_g,
             const float* __restrict__ ln_b, HT* __restrict__ h, int H, int W, int C) {
  using T = DwTile<TH, TW, CH, XT>;
  constexpr int R = T::R, SW = T::SW;
  constexpr int CPP = 16 / (int)sizeof(XT);  // channels a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];  // [2][STAGE_BYTES]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const long long b = blockIdx.z;
  const XT* xb = x + b * H * W * C;
  const int p0 = warp * R;             // first pixel of this warp's run
  const int py = p0 / TW, px0 = p0 % TW;
  const int chunks = (C + 31) / 32;

  auto load = [&](int cc, int s) {
    unsigned char* dst = smem_raw + s * T::STAGE_BYTES;
    for (int idx = tid; idx < T::SH * SW * (32 / CPP); idx += kThreads) {
      const int pix = idx / (32 / CPP), q = idx % (32 / CPP);
      const int sy = pix / SW, sx = pix - sy * SW;
      const int iy = y0 - 3 + sy, ix = x0 - 3 + sx;
      const int c = cc * 32 + CPP * q;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && c < C;
      const XT* src = ok ? xb + ((long long)iy * W + ix) * C + c : x;
      cp_async16(dst + (pix * 32 + CPP * q) * (int)sizeof(XT), src, ok);
    }
    // dw_w is (C, 49): the chunk's taps are one contiguous run.
    const int n_taps = (min(C, cc * 32 + 32) - cc * 32) * 49;  // a multiple of 4
    float* taps = reinterpret_cast<float*>(dst + T::X_BYTES);
    for (int v = tid; v < n_taps / 4; v += kThreads)
      cp_async16(taps + 4 * v, dw_w + (long long)cc * 32 * 49 + 4 * v, true);
  };

  float d[CH][R];
  load(0, 0);
  cp_async_commit();
#pragma unroll
  for (int cc = 0; cc < CH; ++cc) {
#pragma unroll
    for (int r = 0; r < R; ++r) d[cc][r] = 0.0f;
    if (cc < chunks) {
      if (cc + 1 < chunks) {
        load(cc + 1, (cc + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk cc landed for every thread
      const int c = cc * 32 + lane;
      if (c < C) {
        const unsigned char* stage = smem_raw + (cc & 1) * T::STAGE_BYTES;
        const XT* src = reinterpret_cast<const XT*>(stage);
        // Lane l reads tap word 49 l + t: bank 17 l + t, no conflicts.
        const float* taps = reinterpret_cast<const float*>(stage + T::X_BYTES) + lane * 49;
        float wr[49];
#pragma unroll
        for (int t = 0; t < 49; ++t) wr[t] = ROUND ? round_bf16(taps[t]) : taps[t];
        const float bias = dw_b[c];
#pragma unroll
        for (int r = 0; r < R; ++r) d[cc][r] = ROUND ? 0.0f : bias;
#pragma unroll
        for (int ky = 0; ky < 7; ++ky) {
          const XT* row = src + ((py + ky) * SW + px0) * 32 + lane;
          float in[R + 6];
#pragma unroll
          for (int j = 0; j < R + 6; ++j) {
            in[j] = to_f32(row[j * 32]);
            if constexpr (ROUND) in[j] = round_bf16(in[j]);
          }
#pragma unroll
          for (int kx = 0; kx < 7; ++kx)
#pragma unroll
            for (int r = 0; r < R; ++r) d[cc][r] = fmaf(in[r + kx], wr[ky * 7 + kx], d[cc][r]);
        }
        if constexpr (ROUND) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            d[cc][r] = round_bf16(round_bf16(d[cc][r]) + round_bf16(bias));
        }
      }
      __syncthreads();  // stage (cc & 1) is free for chunk cc + 2
    }
  }

  // LayerNorm of this warp's pixels over the C channels held by its lanes.
  const float inv_c = 1.0f / C;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int iy = y0 + py, ix = x0 + px0 + r;
    float s = 0.0f;
#pragma unroll
    for (int cc = 0; cc < CH; ++cc) s += d[cc][r];  // zero past C
    const float mean = warp_sum(s) * inv_c;
    float q = 0.0f;
#pragma unroll
    for (int cc = 0; cc < CH; ++cc) {
      const float e = cc * 32 + lane < C ? d[cc][r] - mean : 0.0f;
      q = fmaf(e, e, q);
    }
    const float rstd = rsqrtf(warp_sum(q) * inv_c + kEps);
    if (iy >= H || ix >= W) continue;
    HT* out = h + ((b * H + iy) * W + ix) * C;
#pragma unroll
    for (int cc = 0; cc < CH; ++cc) {
      const int c = cc * 32 + lane;
      if (c < C) store_one(out + c, (d[cc][r] - mean) * rstd * ln_g[c] + ln_b[c]);
    }
  }
}

template <int TH, int TW, int CH, typename XT, typename HT, bool ROUND>
cudaError_t launch_dw_ln(const XT* x, const float* dw_w, const float* dw_b, const float* ln_g,
                         const float* ln_b, HT* h, int B, int H, int W, int C,
                         cudaStream_t stream) {
  constexpr size_t smem = DwTile<TH, TW, CH, XT>::SMEM_BYTES;
  auto kernel = dw_ln_kernel<TH, TW, CH, XT, HT, ROUND>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, dw_w, dw_b, ln_g, ln_b, h, H, W, C);
  return cudaGetLastError();
}

template <typename XT, typename HT, bool ROUND>
cudaError_t run_dw_ln(const XT* x, const float* dw_w, const float* dw_b, const float* ln_g,
                      const float* ln_b, HT* h, int B, int H, int W, int C,
                      cudaStream_t stream) {
  // Tiles shrink as C grows: each thread holds 32 pre-LN values (48 at
  // C > 1024).
  if (C <= 128)
    return launch_dw_ln<4, 16, 4, XT, HT, ROUND>(x, dw_w, dw_b, ln_g, ln_b, h, B, H, W, C, stream);
  if (C <= 256)
    return launch_dw_ln<2, 16, 8, XT, HT, ROUND>(x, dw_w, dw_b, ln_g, ln_b, h, B, H, W, C, stream);
  if (C <= 512)
    return launch_dw_ln<2, 8, 16, XT, HT, ROUND>(x, dw_w, dw_b, ln_g, ln_b, h, B, H, W, C, stream);
  if (C <= 1024)
    return launch_dw_ln<1, 8, 32, XT, HT, ROUND>(x, dw_w, dw_b, ln_g, ln_b, h, B, H, W, C, stream);
  return launch_dw_ln<1, 8, 48, XT, HT, ROUND>(x, dw_w, dw_b, ln_g, ln_b, h, B, H, W, C, stream);
}

// ---------------------------------------------------------------------------
// 2-3. The projections: 3xTF32 tensor-core GEMMs, C[M, N] = A[M, K] · B[N, K]^T.

enum Epilogue { kGelu = 0, kResidual = 1, kPartial = 2 };

// v rounded to TF32: to nearest (ties away) on the 13 bits TF32 drops, with
// integer ops (cvt.rna.tf32 runs on the quarter-rate conversion pipe).
__device__ __forceinline__ uint32_t round_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32. The tensor core reads only the top 19 bits of an
// operand, so lo is passed rounded the same way without its mask.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
struct GemmTile {
  static constexpr int BM = kBM;
  static constexpr int WM = BM / 2, WN = BN / 4;  // warp tile, 8 warps as 2 x 4
  static constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles per warp
  static constexpr int STAGE = (BM + BN) * kLd;    // floats
  static constexpr size_t SMEM_BYTES = (size_t)kStages * STAGE * sizeof(float);
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile");
};

// One K stage (32) of products for a warp: part = A[rows, 32] · B[cols,
// 32]^T over MT m16 tiles and NT n8 tiles, into a fresh tile (see gemm_body
// for the fragment order and why the tile is fresh), as the 3xTF32 split of
// both operands (f32 accuracy, matmul_precision "highest"). A and B point
// at the warp's first row of A and of B; lda and kLd are their row strides
// in floats.
template <int MT, int NT>
__device__ __forceinline__ void mma_stage(const float* __restrict__ As, int lda,
                                          const float* __restrict__ Bs, float (&part)[MT][NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(Bs + (j * 8 + g) * kLd + kk + 2 * t);
      split_tf32(v.x, bh[j][0], bl[j][0]);
      split_tf32(v.y, bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float2 v0 = *reinterpret_cast<const float2*>(As + (i * 16 + g) * lda + kk + 2 * t);
      const float2 v1 = *reinterpret_cast<const float2*>(As + (i * 16 + g + 8) * lda + kk + 2 * t);
      uint32_t ah[4], al[4];
      split_tf32(v0.x, ah[0], al[0]);
      split_tf32(v1.x, ah[1], al[1]);
      split_tf32(v0.y, ah[2], al[2]);
      split_tf32(v1.y, ah[3], al[3]);
      // The small products first, then hi * hi.
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ah, bh[j][0], bh[j][1]);
    }
  }
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z) owns output columns
// [BN * x, BN * (x + 1)), rows [kBM * y, kBM * (y + 1)) and the K range
// [k_span * z, k_span * (z + 1)). A is (M, K) and B is (N, K), row-major;
// K and N are multiples of 4.
//   kGelu:     out[m, n] = GELU(acc + bias[n])
//   kResidual: out[m, n] = x[m, n] + (acc + bias[n]) * scale[n]
//   kPartial:  out[z][m, n] = acc
//
// Fragments: the m16n8k8 slots t and t + 4 of thread (g, t) take the
// physical k = 2t and 2t + 1 of each group of 8, in A and B alike (the sum
// over k is the same), so each is one 8-byte shared load; rows of kLd = 40
// floats make those loads conflict-free.
//
// The tensor core rounds its f32 accumulator toward zero after each mma, a
// bias that grows with K; so each K stage (32) is summed into a fresh
// register tile and added to the running sum with an ordinary f32 add.
template <int BN, int EPI>
__global__ void __launch_bounds__(kThreads, 2) gemm_3xtf32_kernel(const float* __restrict__ A, const float* __restrict__ Bw,
                                   int M, int N, int K, int k_span,
                                   const float* __restrict__ bias, const float* __restrict__ x,
                                   const float* __restrict__ scale, float* __restrict__ out) {
  using T = GemmTile<BN>;
  constexpr int BM = T::BM, MT = T::MT, NT = T::NT;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_span;
  const int k_end = min(K, k_begin + k_span);
  const int nk = (k_end - k_begin + kBK - 1) / kBK;

  auto load = [&](int kt, int s) {
    float* As = smem + s * T::STAGE;
    float* Bs = As + BM * kLd;
    const int kc0 = k_begin + kt * kBK;
#pragma unroll
    for (int idx = tid; idx < BM * (kBK / 4); idx += kThreads) {
      const int row = idx / (kBK / 4), q = idx % (kBK / 4);
      const long long m = m0 + row;
      const int k = kc0 + 4 * q;
      const bool ok = m < M && k < k_end;
      cp_async16(As + row * kLd + 4 * q, ok ? A + m * K + k : A, ok);
    }
#pragma unroll
    for (int idx = tid; idx < BN * (kBK / 4); idx += kThreads) {
      const int row = idx / (kBK / 4), q = idx % (kBK / 4);
      const int n = n0 + row;
      const int k = kc0 + 4 * q;
      const bool ok = n < N && k < k_end;
      cp_async16(Bs + row * kLd + 4 * q, ok ? Bw + (long long)n * K + k : Bw, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

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

    const float* As = smem + (kt % kStages) * T::STAGE + (wm * T::WM) * kLd;
    const float* Bs = As - (wm * T::WM) * kLd + BM * kLd + (wn * T::WN) * kLd;
    float part[MT][NT][4];
    mma_stage<MT, NT>(As, kLd, Bs, part);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  float* dst = EPI == kPartial ? out + (long long)blockIdx.z * M * N : out;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * T::WM + i * 16 + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * T::WN + j * 8 + 2 * t;  // even; N % 4 == 0
        if (n >= N) continue;
        float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        const long long o = m * N + n;
        if (EPI == kGelu) {
          v0 = gelu_exact(v0 + bias[n]);
          v1 = gelu_exact(v1 + bias[n + 1]);
        } else if (EPI == kResidual) {
          const float2 xv = *reinterpret_cast<const float2*>(x + o);
          v0 = xv.x + (v0 + bias[n]) * scale[n];
          v1 = xv.y + (v1 + bias[n + 1]) * scale[n + 1];
        }
        *reinterpret_cast<float2*>(dst + o) = make_float2(v0, v1);
      }
    }
  }
}

// Adds the split partials in split order, then the residual epilogue.
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float4* __restrict__ partial, const float4* __restrict__ x,
              const float* __restrict__ bias, const float* __restrict__ scale,
              float4* __restrict__ out, long long n4, int C, int splits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  float4 s = partial[i];
  for (int k = 1; k < splits; ++k) {
    const float4 p = partial[k * n4 + i];
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  const int c = (int)((4 * i) % C);
  const float4 xv = x[i];
  out[i] = make_float4(xv.x + (s.x + bias[c]) * scale[c], xv.y + (s.y + bias[c + 1]) * scale[c + 1],
                       xv.z + (s.z + bias[c + 2]) * scale[c + 2],
                       xv.w + (s.w + bias[c + 3]) * scale[c + 3]);
}

template <int BN, int EPI>
cudaError_t launch_gemm(const float* A, const float* Bw, int M, int N, int K, int splits,
                        int k_span, const float* bias, const float* x, const float* scale,
                        float* out, cudaStream_t stream) {
  constexpr size_t smem = GemmTile<BN>::SMEM_BYTES;
  const auto kernel = gemm_3xtf32_kernel<BN, EPI>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + kBM - 1) / kBM, splits);
  kernel<<<grid, kThreads, smem, stream>>>(A, Bw, M, N, K, k_span, bias, x, scale, out);
  return cudaGetLastError();
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Adds `splits` partials of the (M, C) output in split order, then the
// residual epilogue: reduce_kernel on the stream.
cudaError_t reduce_splits(const float* partial, const float* x, const float* b2,
                          const float* scale, float* out, long long M, int C, int splits,
                          cudaStream_t stream) {
  const long long n4 = M * C / 4;
  reduce_kernel<<<(unsigned)cdiv(n4, kThreads), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<const float4*>(x), b2, scale,
      reinterpret_cast<float4*>(out), n4, C, splits);
  return cudaGetLastError();
}

// Share of the card's block slots (two per SM) that `blocks` blocks keep
// busy over the waves they need.
double wave_use(long long blocks, int sms) {
  const long long slots = 2LL * sms;
  return (double)blocks / (double)(cdiv(blocks, slots) * slots);
}

// Tile and split choices for M pixels at width C on a card with `sms` SMs.
// The late stages have few tiles, so the choice that wastes the least of
// the last wave wins: GEMM 1 between 128- and 96-wide column tiles, GEMM 2
// among 1..8 K splits (a split costs its partials' round trip, so a small
// penalty per split breaks near ties).
struct Plan {
  int bn1;     // GEMM 1 columns per block (N = 4C)
  int bn2;     // GEMM 2 columns per block (N = C)
  int splits;  // GEMM 2 K splits
  int k_span;  // GEMM 2 K per split
};

Plan make_plan(long long M, int C, int sms) {
  Plan p;
  const long long mt = cdiv(M, kBM);
  p.bn1 = wave_use(mt * cdiv(4 * C, 96), sms) > wave_use(mt * cdiv(4 * C, 128), sms) + 0.05 ? 96
                                                                                            : 128;
  p.bn2 = C % 128 == 0 ? 128 : 96;
  const long long tiles2 = mt * cdiv(C, p.bn2);
  const int chunks = (int)cdiv(4 * C, kBK);
  int best = 1;
  double best_score = -1.0;
  for (int s = 1; s <= kMaxSplits && s <= std::max(1, chunks / 4); ++s) {
    const double score = wave_use(tiles2 * s, sms) - 0.03 * (s - 1);
    if (score > best_score) best = s, best_score = score;
  }
  const int per = (int)cdiv(chunks, best);
  p.splits = (int)cdiv(chunks, per);
  p.k_span = per * kBK;
  return p;
}

#ifndef CONVNEXT_BLOCK_TF32  // the 3xTF32 entry's GEMMs
cudaError_t run_gemm1(const float* h, const float* w1, const float* b1, float* u, int M, int C,
                      const Plan& p, cudaStream_t stream) {
  const int N = 4 * C, K = C;
  if (p.bn1 == 128)
    return launch_gemm<128, kGelu>(h, w1, M, N, K, 1, K, b1, nullptr, nullptr, u, stream);
  return launch_gemm<96, kGelu>(h, w1, M, N, K, 1, K, b1, nullptr, nullptr, u, stream);
}

template <int BN>
cudaError_t gemm2_tiles(const float* u, const float* w2, const float* b2, const float* x,
                        const float* scale, float* partial, float* out, int M, int C,
                        const Plan& p, cudaStream_t stream) {
  const int N = C, K = 4 * C;
  if (p.splits == 1)
    return launch_gemm<BN, kResidual>(u, w2, M, N, K, 1, K, b2, x, scale, out, stream);
  return launch_gemm<BN, kPartial>(u, w2, M, N, K, p.splits, p.k_span, nullptr, nullptr, nullptr,
                                   partial, stream);
}

cudaError_t run_gemm2(const float* u, const float* w2, const float* b2, const float* x,
                      const float* scale, float* partial, float* out, int M, int C,
                      const Plan& p, cudaStream_t stream) {
  cudaError_t e = p.bn2 == 128
                      ? gemm2_tiles<128>(u, w2, b2, x, scale, partial, out, M, C, p, stream)
                      : gemm2_tiles<96>(u, w2, b2, x, scale, partial, out, M, C, p, stream);
  if (e != cudaSuccess || p.splits == 1) return e;
  return reduce_splits(partial, x, b2, scale, out, M, C, p.splits, stream);
}

#endif  // CONVNEXT_BLOCK_TF32

// The shapes both f32 entries take: C % 4 == 0, C <= kMaxC, and the grids'
// limits.
bool valid_f32(int B, int H, int W, int C, int sms) {
  return B > 0 && H > 0 && W > 0 && C > 0 && C <= kMaxC && C % 4 == 0 && H <= 65535 && B <= 65535 &&
         sms > 0;
}

}  // namespace

#endif  // CONVNEXT_BLOCK_BF16

#ifdef CONVNEXT_BLOCK_BF16

// Floats of scratch that convnext_block_bf16 needs for this shape: h in
// bf16 (M x C halves), then the two-GEMM form's u in bf16 and its GEMM 2
// split partials in f32.
extern "C" long long convnext_block_bf16_workspace(int B, int H, int W, int C, int sms) {
  const long long M = (long long)B * H * W;
  return M * C / 2 + block_bf16::workspace_floats(M, C, block_bf16::plan((long long)H * W, C, sms));
}

// The packed layout the library reads for width C: the fused form's wgmma
// width (kernels/packing.py::pack_block_bf16 packs W1 and W2 as one buffer
// of hidden chunks), or 0 for the two-GEMM form (W1 and W2 each in
// 128 x 64 tiles).
extern "C" int convnext_block_bf16_fused_width(int C) {
  return C <= block_bf16::kFusedMaxC ? block_bf16::fused_width(C) : 0;
}

// The rest of that layout, which kernels/convnext_block.py::build_bf16
// holds against packing.py at load: the fused form's widest C and hidden
// units a chunk, then the two-GEMM form's tile (output columns by K), into
// out[0..3].
extern "C" void convnext_block_bf16_layout(int* out) {
  out[0] = block_bf16::kFusedMaxC;
  out[1] = block_bf16::kNH;
  out[2] = block_bf16::kBN;
  out[3] = block_bf16::kBK;
}

// Fills the module mode's GELU table (convnext_block_bf16_gelu_entries()
// bf16 values at table) on stream and adds to *bad (device memory) the
// bf16 values whose lookup differs from the GELU it stands for; the caller
// launches the block only where that count is 0. Returns
// cudaGetLastError().
extern "C" int convnext_block_bf16_gelu_entries() { return block_bf16::kGeluTable; }
extern "C" int convnext_block_bf16_gelu_table(uint16_t* table, unsigned* bad, cudaStream_t stream) {
  return (int)block_bf16::make_gelu_table(table, bad, stream);
}

// The block in bf16, in the library's mode (CONVNEXT_BLOCK_BF16_MODULE):
// the Pallas mode's x and out (B, H, W, C) are bf16, the module mode's f32.
// C % 8 == 0; w1 and w2 bf16, packed for C as
// convnext_block_bf16_fused_width(C) says (the fused form reads w1 alone);
// dw_w the depthwise taps packed tap-major, (49, C) f32; the vectors f32,
// as convnext_block_f32 takes them; gelu_table the module mode's GELU table
// (convnext_block_bf16_gelu_table; unread in the Pallas mode); workspace
// holds
// convnext_block_bf16_workspace(B, H, W, C, sms) floats. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int convnext_block_bf16(const void* x, const float* dw_w, const float* dw_b,
                                   const float* ln_g, const float* ln_b,
                                   const block_bf16::bf16* w1, const float* b1,
                                   const block_bf16::bf16* w2, const float* b2,
                                   const float* scale, const uint16_t* gelu_table,
                                   float* workspace, void* out, int B, int H, int W, int C,
                                   int sms, cudaStream_t stream) {
  using block_bf16::bf16;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > block_bf16::kMaxC || C % 8 || H > 65535 ||
      B > 65535 ||
      sms <= 0)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  if (block_bf16::cdiv(M, block_bf16::kBM) > 65535) return (int)cudaErrorInvalidValue;
  const block_bf16::Plan p = block_bf16::plan((long long)H * W, C, sms);
#if CONVNEXT_BLOCK_BF16_MODULE
  return (int)block_bf16::run_block<true, float>(
      static_cast<const float*>(x), dw_w, dw_b, ln_g, ln_b, w1, b1, w2, b2, scale, gelu_table,
      workspace, static_cast<float*>(out), B, H, W, C, sms, p, stream);
#else
  return (int)block_bf16::run_block<false, bf16>(
      static_cast<const bf16*>(x), dw_w, dw_b, ln_g, ln_b, w1, b1, w2, b2, scale, gelu_table,
      workspace, static_cast<bf16*>(out), B, H, W, C, sms, p, stream);
#endif
}

#else

#ifndef CONVNEXT_BLOCK_TF32

// Floats of scratch that convnext_block_f32 needs for this shape on a card
// with `sms` multiprocessors: h (M x C), the hidden u (M x 4C), then the
// GEMM 2 split partials.
extern "C" long long convnext_block_f32_workspace(int B, int H, int W, int C, int sms) {
  const long long M = (long long)B * H * W;
  const Plan p = make_plan(M, C, sms);
  return M * C * (5 + (p.splits > 1 ? p.splits : 0));
}

// x and out are (B, H, W, C) f32, contiguous, 16-byte aligned; workspace
// holds convnext_block_f32_workspace(B, H, W, C, sms) floats. The weights are
// in PyTorch's layouts: dw_w (C, 1, 7, 7), w1 (4C, C), w2 (C, 4C); the
// vectors have C entries, b1 has 4C. The projections at f32 accuracy
// (3xTF32), matmul_precision "highest".
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int convnext_block_f32(const float* x, const float* dw_w, const float* dw_b,
                                  const float* ln_g, const float* ln_b, const float* w1,
                                  const float* b1, const float* w2, const float* b2,
                                  const float* scale, float* workspace, float* out, int B,
                                  int H, int W, int C, int sms, cudaStream_t stream) {
  if (!valid_f32(B, H, W, C, sms)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  if (cdiv(M, kBM) > 65535) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, C, sms);
  float* h = workspace;
  float* u = h + M * C;
  float* partial = u + M * 4 * C;
  cudaError_t e =
      run_dw_ln<float, float, false>(x, dw_w, dw_b, ln_g, ln_b, h, B, H, W, C, stream);
  if (e == cudaSuccess) e = run_gemm1(h, w1, b1, u, (int)M, C, p, stream);
  if (e == cudaSuccess) e = run_gemm2(u, w2, b2, x, scale, partial, out, (int)M, C, p, stream);
  return (int)e;
}

#else

// Floats of scratch that convnext_block_tf32 needs for this shape on a card
// with `sms` multiprocessors: h (M x C), then, for the two-GEMM form
// (C > 192), u (M x 4C) and GEMM 2's split partials.
extern "C" long long convnext_block_tf32_workspace(int B, int H, int W, int C, int sms) {
  const long long M = (long long)B * H * W;
  return M * C + block_tf32::workspace_floats(M, C, block_tf32::plan((long long)H * W, C, sms));
}

// The packed layout convnext_block_tf32 reads for width C: the fused form's
// wgmma width (kernels/packing.py::pack_block_tf32 packs W1 and W2 as one
// buffer of hidden chunks), or 0 for the two-GEMM form.
extern "C" int convnext_block_tf32_fused_width(int C) {
  return C <= block_tf32::kFusedMaxC ? block_tf32::fused_width(C) : 0;
}

// The rest of that layout, which kernels/convnext_block.py::build holds
// against packing.py at load: the fused form's widest C and its hidden
// units a chunk at the widths 96, 128 and 192, then the two-GEMM form's tile
// (output columns by K), into out[0..5].
extern "C" void convnext_block_tf32_layout(int* out) {
  out[0] = block_tf32::kFusedMaxC;
  out[1] = block_tf32::fused_hidden(96);
  out[2] = block_tf32::fused_hidden(128);
  out[3] = block_tf32::fused_hidden(192);
  out[4] = block_tf32::kBN;
  out[5] = block_tf32::kBK;
}

// As convnext_block_f32, the projections as one TF32 product a product
// (matmul_precision "default" / "high"): both operands rounded to TF32 (to
// nearest, ties away), f32 sums, on block_tf32.cuh's MLP. w1 and w2 are
// packed for C as convnext_block_tf32_fused_width(C) says
// (kernels/packing.py::pack_block_tf32; the fused form reads w1 alone);
// workspace holds convnext_block_tf32_workspace(B, H, W, C, sms) floats;
// u_out is null when serving, or M x 4C floats that receive the GELU's
// output u before its rounding to TF32 (the operand of the second product,
// which round_tf32 makes of it bit for bit): the fused form keeps u on chip
// and writes it only there. Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int convnext_block_tf32(const float* x, const float* dw_w, const float* dw_b,
                                   const float* ln_g, const float* ln_b, const float* w1,
                                   const float* b1, const float* w2, const float* b2,
                                   const float* scale, float* workspace, float* out, float* u_out,
                                   int B, int H, int W, int C, int sms, cudaStream_t stream) {
  if (!valid_f32(B, H, W, C, sms)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  const block_tf32::Plan p = block_tf32::plan((long long)H * W, C, sms);
  if (!p.fused && cdiv(M, block_tf32::kBM) > 65535) return (int)cudaErrorInvalidValue;
  float* h = workspace;
  // The depthwise + LN: run_dw_ln's tiles for C <= 192 (named here, so that
  // this library builds only those), the row strips above.
  cudaError_t e =
      C <= 128   ? launch_dw_ln<4, 16, 4, float, float, false>(x, dw_w, dw_b, ln_g, ln_b, h, B, H, W, C, stream)
      : p.fused ? launch_dw_ln<2, 16, 8, float, float, false>(x, dw_w, dw_b, ln_g, ln_b, h, B, H, W, C, stream)
                : block_tf32::run_dw_ln_rows(x, dw_w, dw_b, ln_g, ln_b, h, B, H, W, C, stream);
  if (e != cudaSuccess) return (int)e;
  auto reduce = [&](const float* partial, int splits) {
    return reduce_splits(partial, x, b2, scale, out, M, C, splits, stream);
  };
  return (int)block_tf32::run_mlp(h, w1, b1, w2, b2, scale, x, h + M * C, out, u_out, M, C, p,
                                  reduce, stream);
}

#endif  // CONVNEXT_BLOCK_TF32

#endif  // CONVNEXT_BLOCK_BF16
