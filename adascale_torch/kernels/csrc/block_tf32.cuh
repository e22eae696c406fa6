// The ConvNeXt block's single-pass TF32 entry for Hopper (sm_90a), NHWC
// (convnext_block.cu's convnext_block_tf32: matmul_precision "default" /
// "high", the JAX engine's jax.default_matmul_precision scope, under which
// XLA computes an f32 product on a GPU as one TF32 pass):
//
//   h = LN(dwconv7x7(x) + dw_b)                        (convnext_block.cu's dw_ln_kernel)
//   out = x + scale * (W2 . GELU(W1 . h + b1) + b2)    (the MLP, below)
//
// both operands of each product rounded to TF32 (to nearest, ties away:
// conv_gemm::round_tf32, utils/precision.py::round_tf32), sums in f32, the
// depthwise, LayerNorm, exact-erf GELU and residual in f32. It is the
// single-pass counterpart of the Pallas TPU kernel
// adascale/ops/pallas/convnext_block.py::fused_convnext_block (`_kernel` at
// :68), on block_bf16.cuh's structure. It replaced the 3xTF32 kernels run
// at one pass (gemm_tf32_kernel: mma.sync m16n8k8, each operand fragment
// rounded on every load, u through memory, a split plan chosen for the
// batch), 6.18 ms of device time for both passes of a page on an H100
// against 3.11 ms for this design (PERF.md).
//
// What bounds it: 16 C^2 flops a pixel of products at the H100's 495
// TFLOP/s dense TF32, and 2 x 49 C of depthwise at 67 TFLOP/s f32: 0.632 ms
// for both passes of a 1024x768 page. Beside them, 4C exact-erf GELUs a
// pixel on the f32 pipes, about as long as the products at C = 96; the
// fused form overlaps one warpgroup's GELUs with the other's products.
//
// Two forms, by C, as in bf16:
//   * fused (C <= kFusedMaxC; tiny's stages 0-1): one launch,
//     mlp_fused_tf32_kernel. A block owns 128 pixels: two consumer
//     warpgroups of 64 rows and a producer warpgroup (setmaxnreg: 40
//     registers for it, 232 for the consumers, which hold up to C / 2 = 96
//     output sums, a chunk's sums and its u). Each warpgroup brings its 64
//     h rows from the workspace through registers, rounds them to TF32 and
//     stores them in wgmma's core-matrix layout. The hidden units are walked
//     in chunks of fused_hidden(CP) (64, or 32 at CP = 192, where two stages
//     of f32 W1 and W2 chunks must fit beside 96 KB of h), in order; one
//     thread of the producer brings each chunk's W1 rows and W2 columns
//     (packed and rounded once per parameter set) by one bulk copy on a ring
//     of full and empty mbarriers. Per chunk a warpgroup runs GEMM 1,
//     wgmma.m64nNk8.tf32 with A (h) and B (W1) from shared memory; adds b1
//     and takes the GELU in f32; rounds u to TF32 into registers in the A
//     fragment order of GEMM 2, wgmma.m64nCPk8 with A from registers,
//     accumulating the C-wide output over every chunk; one warpgroup's
//     GELUs run on the f32 pipes while the other's products run. u never
//     leaves the SM (a check may ask the kernel to write it: u_out). The
//     residual epilogue follows the last chunk. (Running the next chunk's
//     GEMM 1 under this chunk's GELUs, in a second register tile, needs
//     more than the 168 registers a thread of a 384-thread block gets:
//     ptxas spilled and serialised the wgmmas, and on an H100 the fused
//     kernels took 1.20 ms for both passes against 0.75, PERF.md.)
//   * two GEMMs (wider C: the output sums would not fit):
//     gemm_tf32_wgmma_kernel twice, u through the workspace in f32 (the
//     GELU's output before its rounding). A block owns 128 pixel rows by
//     128 columns, with two consumer warpgroups and a producer warpgroup;
//     K is staged 32 deep (one 128-byte row of f32) through a ring of
//     kStages: A (h, or u) by TMA in the 128-byte swizzle, B (packed once,
//     in the same swizzle, rounded) by a bulk copy, on the stage's full
//     mbarrier. A goes to registers by ldmatrix and is rounded there (RS
//     wgmma). GEMM 1 takes the GELU epilogue, GEMM 2 the residual, or (few
//     output tiles: plan, chosen for one image) splits K and writes f32
//     partials that convnext_block.cu's reduce_kernel adds in split order.
//
// Where the roundings go: wgmma reads an f32 operand from shared memory by
// dropping its low 13 bits, a truncation, so everything it reads from
// there is rounded before it lands (the packed weights; the fused form's
// h on its way in); what lands unrounded (the two-GEMM form's A) is read
// into registers and rounded.
//
// The accumulator-to-A trick: a thread's GEMM 1 sums of k8 step q hold
// hidden units 8 q + 2 t and 8 q + 2 t + 1 (rows g and g + 8), while a
// TF32 A fragment of thread (g, t) holds K slots t and t + 4. So u's
// register a0 = unit 2 t, a2 = unit 2 t + 1 of each 8, and W2's K is packed
// permuted within each 8 to match: slot s holds unit packing.KSLOT[s],
// (0, 2, 4, 6, 1, 3, 5, 7), as conv_gemm.cuh packs x's channels.
//
// The tensor core truncates its f32 accumulator after each product, a
// bias that grows with K. The two-GEMM form sums each 32-deep stage into a
// fresh register tile and adds it to the running sum in f32, as the f32
// kernels do; the fused form's GEMM 1 starts each chunk afresh (K = CP <=
// 192) and its GEMM 2 accumulates K = 4C <= 768 in place (there are no
// registers for a second 96-wide tile): chip_smoke.py's phase tf32 holds
// it against the TF32 twin stage by stage.
//
// Both forms are batch-invariant: a pixel's sums run in one order wherever
// its row falls and whatever B is (the fused form walks the chunks in
// order; the split plan of GEMM 2 is chosen for one image, H W pixels).

#pragma once

#include "block_bf16.cuh"

namespace block_tf32 {

using block_bf16::cdiv;
using block_bf16::desc;
using block_bf16::kK16;
using block_bf16::launch_prepare;
using block_bf16::warpgroup_sync;
using conv_gemm::fence_regs;
using conv_gemm::gelu_exact;
using conv_gemm::mbar_wait;
using conv_gemm::round_tf32;
using conv_tma::desc_sw128;
using conv_tma::keep_regs;
using conv_tma::kK16Sw128;
using conv_tma::mbar_arrive;
using conv_tma::mbar_expect;

constexpr int kBM = 128;                         // pixel rows a block: two warpgroups of 64
constexpr int kConsumers = conv_tma::kConsumers;  // the two consumer warpgroups
constexpr int kThreads = conv_tma::kThreads;      // and a producer warpgroup
constexpr int kFusedMaxC = 192;                  // the widest C of the fused form
constexpr int kBN = 128;                         // two-GEMM form: output columns a block
constexpr int kBK = 32;                          // two-GEMM form: K a stage (128 bytes of f32)
constexpr int kStages = 6;
constexpr int kMaxSplits = 8;
constexpr int kSmemLimit = 232448;               // dynamic shared memory a block may use

enum Epilogue { kGelu = 0, kResidual = 1, kPartial = 2 };

// The fused form's wgmma width for C (C <= kFusedMaxC, as in bf16): GEMM 2's
// N and GEMM 1's K; and its hidden units a chunk at that width.
__host__ __device__ constexpr int fused_width(int c) { return block_bf16::fused_width(c); }
__host__ __device__ constexpr int fused_hidden(int cp) { return cp <= 128 ? 64 : 32; }

// wgmma.mma_async m64nNk8 TF32 with f32 sums; d's register order is the one
// of conv_gemm.cuh's wgmma_n96 (thread (g, t) of warp w holds d[4 j + e] =
// row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2); an A fragment in
// registers holds rows g and g + 8 by K t and t + 4 of thread (g, t).

// d (64 x 32) += A (64 x 8) . B (32 x 8)^T, both TF32 from shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A (64 x 8) . B (64 x 8)^T, both TF32 from shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 96) += A (64 x 8, TF32 in registers) . B (96 x 8)^T from shared memory.
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
      "}, {%48,%49,%50,%51}, %52, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128) += A (64 x 8, TF32 in registers) . B (128 x 8)^T from shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 192) += A (64 x 8, TF32 in registers) . B (192 x 8)^T from shared memory.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
      "}, {%96,%97,%98,%99}, %100, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t db, int scale_d) {
  if constexpr (N == 96) {
    wgmma_rs_n96(d, a, db, scale_d);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db, scale_d);
  } else {
    static_assert(N == 192, "wgmma width");
    wgmma_rs_n192(d, a, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, da, db, scale_d);
  } else {
    static_assert(N == 64, "wgmma width");
    wgmma_ss_n64(d, da, db, scale_d);
  }
}

// ---------------------------------------------------------------------------
// The depthwise 7x7 + bias + LayerNorm -> h (f32) for C > kFusedMaxC.
//
// convnext_block.cu's dw_ln_kernel walks C 32 channels at a time through a
// shared-memory ring, one chunk after another; at the late stages (C = 384
// and 768 on 60x48 and 30x24 pixels) that is 16-24 chunks a block in few
// blocks, and the chain of waits bounds it (on an H100: 39 and 80 us a
// block, more than both GEMMs, PERF.md). Here a block owns one strip of
// kDwStrip pixels of a row and all C channels at once: thread i takes the
// channel pairs i, i + DP, ... (NP of them), reads each input pair of the 7
// rows straight from global memory (L1 and L2 serve the rows' reuse) and
// uses it at once for the up to 7 outputs it touches. Each channel's sum
// runs as dw_ln_kernel's (the bias, then ky-major, kx-minor fused products,
// zeros past the map's edges); the LayerNorm's sums over C meet across the
// block's warps in a shared table in a fixed order, so a pixel's h does not
// depend on where it falls or on B.
constexpr int kDwStrip = 8;
constexpr int kDwMaxWarps = 12;  // 384 threads: the pairs of C <= 768, or half of C <= 1536's

template <int NP>
__global__ void __launch_bounds__(32 * kDwMaxWarps)
dw_ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ dw_w,
                  const float* __restrict__ dw_b, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, float* __restrict__ h, int H, int W, int C) {
  __shared__ float tab[kDwMaxWarps][kDwStrip];
  const int DP = blockDim.x, warps = DP / 32, lane = threadIdx.x % 32, wx = threadIdx.x / 32;
  const int sw = (W + kDwStrip - 1) / kDwStrip;
  const long long strip = blockIdx.x;
  const int b = (int)(strip / ((long long)H * sw)), rem = (int)(strip % ((long long)H * sw));
  const int y = rem / sw, x0 = rem % sw * kDwStrip;
  const float* xb = x + (long long)b * H * W * C;
  const float inv_c = 1.0f / C;

  float d[NP][2][kDwStrip];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int c = 2 * (threadIdx.x + k * DP);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int r = 0; r < kDwStrip; ++r) d[k][e][r] = 0.0f;
    if (c >= C) continue;
    const float bias0 = __ldg(dw_b + c), bias1 = __ldg(dw_b + c + 1);
#pragma unroll
    for (int r = 0; r < kDwStrip; ++r) {
      d[k][0][r] = bias0;
      d[k][1][r] = bias1;
    }
#pragma unroll 1
    for (int ky = 0; ky < 7; ++ky) {
      const int iy = y - 3 + ky;
      const bool row_ok = iy >= 0 && iy < H;
      const float* xr = xb + (long long)min(max(iy, 0), H - 1) * W * C + c;
      float2 wk[7];
#pragma unroll
      for (int kx = 0; kx < 7; ++kx)
        wk[kx] = make_float2(__ldg(dw_w + (long long)c * 49 + ky * 7 + kx),
                             __ldg(dw_w + (long long)(c + 1) * 49 + ky * 7 + kx));
      // Each input pair is loaded once and used at once by the up to 7
      // outputs it touches (output r takes input r + kx, kx ascending). The
      // loads read a clamped pixel and the zero padding is selected after
      // them: a branch around a load would end the unrolled loop's basic
      // block and serialise the loads.
#pragma unroll
      for (int j = 0; j < kDwStrip + 6; ++j) {
        const int ix = x0 - 3 + j;
        const bool ok = row_ok && ix >= 0 && ix < W;
        float2 v = __ldg(reinterpret_cast<const float2*>(xr + (long long)min(max(ix, 0), W - 1) * C));
        if (!ok) v = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int kx = 6; kx >= 0; --kx) {
          const int r = j - kx;
          if (r < 0 || r >= kDwStrip) continue;
          d[k][0][r] = fmaf(v.x, wk[kx].x, d[k][0][r]);
          d[k][1][r] = fmaf(v.y, wk[kx].y, d[k][1][r]);
        }
      }
    }
  }

  // The strip's sums over C: this thread's pairs, its warp, then the
  // block's warps in order.
  auto strip_sum = [&](float (&v)[kDwStrip]) {
#pragma unroll
    for (int r = 0; r < kDwStrip; ++r) {
      const float s = conv_gemm::warp_sum(v[r]);
      if (lane == 0) tab[wx][r] = s;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kDwStrip; ++r) {
      float s = 0.0f;
      for (int w = 0; w < warps; ++w) s += tab[w][r];
      v[r] = s;
    }
    __syncthreads();
  };
  float mean[kDwStrip], rstd[kDwStrip];
#pragma unroll
  for (int r = 0; r < kDwStrip; ++r) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NP; ++k) s += d[k][0][r] + d[k][1][r];  // zero past C
    mean[r] = s;
  }
  strip_sum(mean);
#pragma unroll
  for (int r = 0; r < kDwStrip; ++r) {
    mean[r] *= inv_c;
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      if (2 * (threadIdx.x + k * DP) >= C) continue;
      const float e0 = d[k][0][r] - mean[r], e1 = d[k][1][r] - mean[r];
      q = fmaf(e0, e0, q);
      q = fmaf(e1, e1, q);
    }
    rstd[r] = q;
  }
  strip_sum(rstd);
#pragma unroll
  for (int r = 0; r < kDwStrip; ++r) rstd[r] = rsqrtf(rstd[r] * inv_c + conv_gemm::kEps);
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int c = 2 * (threadIdx.x + k * DP);
    if (c >= C) continue;
    const float g0 = __ldg(ln_g + c), g1 = __ldg(ln_g + c + 1);
    const float o0 = __ldg(ln_b + c), o1 = __ldg(ln_b + c + 1);
    float* out = h + (((long long)b * H + y) * W + x0) * C + c;
#pragma unroll
    for (int r = 0; r < kDwStrip; ++r)
      if (x0 + r < W)
        *reinterpret_cast<float2*>(out + (long long)r * C) =
            make_float2((d[k][0][r] - mean[r]) * rstd[r] * g0 + o0, (d[k][1][r] - mean[r]) * rstd[r] * g1 + o1);
  }
}

// One block a strip: C / 2 channel pairs over up to 384 threads (two pairs
// a thread past C = 768), in whole warps.
inline cudaError_t run_dw_ln_rows(const float* x, const float* dw_w, const float* dw_b,
                                  const float* ln_g, const float* ln_b, float* h, int B, int H, int W,
                                  int C, cudaStream_t stream) {
  const int np = C / 2 <= 32 * kDwMaxWarps ? 1 : 2;
  const int dp = (int)cdiv(cdiv(C / 2, np), 32) * 32;
  const long long strips = (long long)B * H * cdiv(W, kDwStrip);
  if (np == 1)
    dw_ln_rows_kernel<1><<<(unsigned)strips, dp, 0, stream>>>(x, dw_w, dw_b, ln_g, ln_b, h, H, W, C);
  else
    dw_ln_rows_kernel<2><<<(unsigned)strips, dp, 0, stream>>>(x, dw_w, dw_b, ln_g, ln_b, h, H, W, C);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fused form.

template <int CP>
struct Fused {
  static constexpr int NH = fused_hidden(CP);
  static constexpr int W_BYTES = 2 * 4 * NH * CP;  // a chunk: W1 (NH x CP), then W2 (CP x NH)
  static constexpr int H_BYTES = 4 * kBM * CP;     // the block's h rows
  static constexpr int FIT = (kSmemLimit - H_BYTES - 128) / W_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  // The ring, h, the barriers.
  static constexpr int SMEM = STAGES * W_BYTES + H_BYTES + 16 * STAGES;
  static_assert(STAGES >= 2, "ring");
  static_assert(CP % 16 == 0 && (4 * NH) % 32 == 0, "tile");
};

// h (M, C) f32 (the LayerNorm's output, unrounded), x and out (M, C)
// row-major; wpack: per chunk of NH hidden units, W1's rows (NH x CP, K =
// the input channels) as (NH / 8, CP / 4, 8, 4) core matrices, then W2's
// columns of those units (CP x NH, K = the hidden units, slot s of each 8
// holding unit KSLOT[s]) as (CP / 8, NH / 4, 8, 4), TF32 values, zero past C
// and 4C. Block x owns pixel rows [128 x, 128 x + 128). STORE_U: u_out (M,
// 4C) receives each GELU output before its rounding to TF32 (what
// round_tf32 turns into GEMM 2's operand, bit for bit).
template <int CP, bool STORE_U>
__global__ void __launch_bounds__(kThreads, 1)
mlp_fused_tf32_kernel(const float* __restrict__ h, const float* __restrict__ wpack,
                      const float* __restrict__ b1, const float* __restrict__ b2,
                      const float* __restrict__ scale, const float* __restrict__ x,
                      float* __restrict__ out, float* __restrict__ u_out, long long M, int C) {
  using F = Fused<CP>;
  constexpr int S = F::STAGES, NH = F::NH, KG = CP / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t htile = sbase + S * F::W_BYTES;
  const uint32_t full = htile + F::H_BYTES, empty = full + 8 * S;
  const int chunks = (4 * C + NH - 1) / NH;
  const long long m0 = (long long)blockIdx.x * kBM;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      conv_gemm::mbar_init(full + 8 * s, 1);
      conv_gemm::mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread walks the chunks
    conv_tma::producer_regs();
    if (tid == kConsumers) {
      for (int j = 0; j < chunks; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty + 8 * s, (j / S - 1) & 1);
        conv_gemm::bulk_load(sbase + s * F::W_BYTES, wpack + (long long)j * (F::W_BYTES / 4),
                             F::W_BYTES, full + 8 * s);
      }
    }
    return;
  }
  conv_tma::consumer_regs();

  const int wg = tid / 128, lt = tid % 128, lane = tid % 32, warp = lt / 32;
  const int g = lane / 4, t4 = lane % 4;
  // This warpgroup's 64 h rows, rounded to TF32, as 8 row groups of KG core
  // matrices: 32 consecutive pieces are eight rows by four K groups (64
  // contiguous bytes of each row read, 512 contiguous bytes written).
  // The loads read a clamped element and the zero padding is selected after
  // them (a branch around a load in an unrolled loop would serialise the
  // loads).
  unsigned char* hs = smem + S * F::W_BYTES + wg * 64 * CP * 4;
#pragma unroll 4
  for (int idx = lt; idx < 64 * KG; idx += 128) {
    const int q = idx >> 5;
    const int kg = q % (KG / 4) * 4 + (idx & 3), r = (idx >> 2) & 7, rg = q / (KG / 4);
    const long long m = m0 + 64 * wg + rg * 8 + r;
    const int k = kg * 4;
    float4 v = __ldg(reinterpret_cast<const float4*>(h + (m < M ? m : M - 1) * C + (k < C ? k : C - 4)));
    if (m >= M || k >= C) v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<uint4*>(hs + (rg * KG + kg) * 128 + r * 16) =
        make_uint4(round_tf32(v.x), round_tf32(v.y), round_tf32(v.z), round_tf32(v.w));
  }
  conv_gemm::fence_proxy_async();
  warpgroup_sync(1 + wg);

  const uint64_t da = desc(htile + wg * 64 * CP * 4, 32 * CP);
  float acc2[CP / 2], acc1[NH / 2];
  uint32_t ua[NH / 2];
#pragma unroll
  for (int i = 0; i < CP / 2; ++i) acc2[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) acc1[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) ua[i] = 0u;
  const long long row = m0 + 64 * wg + 16 * warp + g;

  for (int j = 0; j < chunks; ++j) {
    const int s = j % S;
    mbar_wait(full + 8 * s, (j / S) & 1);
    const uint32_t w1 = sbase + s * F::W_BYTES;
    const uint64_t db1 = desc(w1, 32 * CP), db2 = desc(w1 + F::W_BYTES / 2, 32 * NH);
    // The operands are settled before the warpgroup's wgmmas start and
    // untouched until they end (else ptxas serialises the wgmmas).
    fence_regs(acc1);
    conv_gemm::wgmma_fence();
#pragma unroll
    for (int k = 0; k < CP / 8; ++k) wgmma_ss<NH>(acc1, da + k * kK16, db1 + k * kK16, k > 0);
    conv_gemm::wgmma_commit();
    fence_regs(acc1);
    conv_gemm::wgmma_wait<0>();
    fence_regs(acc1);
    // Registers i .. i + 3 (k8 step i / 4) hold hidden units n, n + 1 of
    // row g, then of row g + 8 (n = 8 (i / 4) + 2 t4 of the chunk); GEMM
    // 2's A fragment of that step takes them as (g, n), (g + 8, n), (g, n +
    // 1), (g + 8, n + 1). Every unit is computed without a branch around
    // it, even past 4C (its W2 column is zero, and b1 is read at a clamped
    // index).
#pragma unroll
    for (int i = 0; i < NH / 2; i += 4) {
      const int n = j * NH + 8 * (i / 4) + 2 * t4;
      const int nc = n < 4 * C ? n : 4 * C - 2;
      const float c0 = __ldg(b1 + nc), c1 = __ldg(b1 + nc + 1);
      const float u0 = gelu_exact(acc1[i] + c0), u1 = gelu_exact(acc1[i + 1] + c1);
      const float u2 = gelu_exact(acc1[i + 2] + c0), u3 = gelu_exact(acc1[i + 3] + c1);
      ua[i] = round_tf32(u0);
      ua[i + 1] = round_tf32(u2);
      ua[i + 2] = round_tf32(u1);
      ua[i + 3] = round_tf32(u3);
      if constexpr (STORE_U) {
        if (n < 4 * C) {
          if (row < M) *reinterpret_cast<float2*>(u_out + row * 4 * C + n) = make_float2(u0, u1);
          if (row + 8 < M) *reinterpret_cast<float2*>(u_out + (row + 8) * 4 * C + n) = make_float2(u2, u3);
        }
      }
    }
    keep_regs(ua);
    fence_regs(acc2);
    conv_gemm::wgmma_fence();
#pragma unroll
    for (int k = 0; k < NH / 8; ++k) wgmma_rs<CP>(acc2, ua + 4 * k, db2 + k * kK16, 1);
    conv_gemm::wgmma_commit();
    fence_regs(acc2);
    conv_gemm::wgmma_wait<0>();  // ua is free, and the stage: one arrival a warp
    fence_regs(acc2);
    keep_regs(ua);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // The residual: every load at a clamped index, each store where it lands
  // inside the map (no branch around a load).
#pragma unroll
  for (int i = 0; i < CP / 2; i += 2) {
    const int n = 8 * (i / 4) + 2 * t4, nc = n < C ? n : C - 2;
    const long long m = row + 8 * ((i / 2) % 2), mc = m < M ? m : M - 1;
    const float2 xv = __ldg(reinterpret_cast<const float2*>(x + mc * C + nc));
    const float2 bv = make_float2(__ldg(b2 + nc), __ldg(b2 + nc + 1));
    const float2 sv = make_float2(__ldg(scale + nc), __ldg(scale + nc + 1));
    const float2 v = make_float2(xv.x + (acc2[i] + bv.x) * sv.x, xv.y + (acc2[i + 1] + bv.y) * sv.y);
    if (m < M && n < C) *reinterpret_cast<float2*>(out + m * C + n) = v;
  }
}

// ---------------------------------------------------------------------------
// The two-GEMM form.

struct GemmRing {
  static constexpr int A_BYTES = kBM * kBK * 4;
  static constexpr int B_BYTES = kBN * kBK * 4;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // The ring (from a 1024-byte boundary: the swizzle's period), then its
  // full and empty barriers.
  static constexpr int SMEM = 1024 + kStages * STAGE + 16 * kStages;
  static_assert(SMEM <= kSmemLimit, "shared memory");
};

// C[M, N] = A[M, K] . B[N, K]^T, both rounded to TF32, f32 sums, and the
// epilogue:
//   kGelu:     out[m, n] = GELU(acc + bias[n]), f32 (GEMM 2's A, unrounded)
//   kResidual: out[m, n] = x[m, n] + (acc + bias[n]) * scale[n]
//   kPartial:  out[z][m, n] = acc
// Block (x, y, z) owns columns [128 x, +128), rows [128 y, +128) and the K
// chunks [span z, span (z + 1)). A (M, K), row-major f32, comes through the
// tensor map tmap_a (boxes of 32 K x 128 rows, 128-byte swizzle); Bp holds,
// per 128-column tile and 32-deep K chunk, 128 rows of 128 bytes in the
// 128-byte swizzle (packing.pack_sw128_tf32), TF32 values, zero past N and
// K. K and N are multiples of 4.
template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_a, const float* __restrict__ Bp,
                       long long M, int N, int K, int span, const float* __restrict__ bias,
                       const float* __restrict__ x, const float* __restrict__ scale,
                       float* __restrict__ out) {
  using R = GemmRing;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t sbase = conv_tma::ring_base(smem);
  const uint32_t full = sbase + kStages * R::STAGE, empty = full + 8 * kStages;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kchunks = (K + kBK - 1) / kBK;
  const int kc0 = blockIdx.z * span;
  const int nk = min(kchunks, kc0 + span) - kc0;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      conv_gemm::mbar_init(full + 8 * s, 1);
      conv_gemm::mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues every copy
    conv_tma::producer_regs();
    if (tid == kConsumers) {
      const float* Bt = Bp + (long long)blockIdx.x * kchunks * (kBN * kBK);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = conv_tma::claim<kStages>(empty, (uint32_t)kt);
        const uint32_t st = sbase + s * R::STAGE, bar = full + 8 * s;
        mbar_expect(bar, R::STAGE);
        conv_tma::tma_load_2d(st, &tmap_a, (kc0 + kt) * kBK, (int)m0, bar);
        conv_tma::bulk_copy(st + R::A_BYTES, Bt + (long long)(kc0 + kt) * (kBN * kBK), R::B_BYTES, bar);
      }
    }
    return;
  }
  conv_tma::consumer_regs();

  const int wg = tid / 128, lane = tid % 32, warp = tid % 128 / 32;
  const int g = lane / 4, t4 = lane % 4;
  // This lane's ldmatrix row of the stage's A: row 64 wg + 16 warp + 8
  // (lane / 8 % 2) + lane % 8, 16-byte piece 2 q + lane / 16 of k8 step q
  // (the box is in TMA's 128-byte swizzle: piece j of row r sits at j ^ r %
  // 8).
  const int arow = 64 * wg + 16 * warp + 8 * (lane / 8 % 2) + lane % 8;
  const int kgrp = lane / 16;
  float acc[kBN / 2], part[kBN / 2];
  uint32_t a[16];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = part[i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint32_t st = sbase + s * R::STAGE;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      conv_tma::ldmatrix_x4(a + 4 * q, st + arow * 128 + (((2 * q + kgrp) ^ (arow & 7)) << 4));
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = round_tf32(__uint_as_float(a[i]));
    const uint64_t db = desc_sw128(st + R::A_BYTES);
    keep_regs(a);
    fence_regs(part);
    conv_gemm::wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q) wgmma_rs<kBN>(part, a + 4 * q, db + q * kK16Sw128, q > 0);
    conv_gemm::wgmma_commit();
    keep_regs(a);
    fence_regs(part);
    conv_gemm::wgmma_wait<0>();
    fence_regs(part);
    if (lane == 0) mbar_arrive(empty + 8 * s);  // the stage is free: one arrival a warp
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
  }

  // Every load at a clamped index, each store where it lands inside the
  // output (no branch around a load).
  const long long row = m0 + 64 * wg + 16 * warp + g;
#pragma unroll
  for (int i = 0; i < kBN / 2; i += 2) {
    const int n = n0 + 8 * (i / 4) + 2 * t4, nc = n < N ? n : N - 2;
    const long long m = row + 8 * ((i / 2) % 2), mc = m < M ? m : M - 1;
    long long o = m * N + n;
    float2 v = make_float2(acc[i], acc[i + 1]);
    if constexpr (EPI == kGelu) {
      const float2 bv = make_float2(__ldg(bias + nc), __ldg(bias + nc + 1));
      v = make_float2(gelu_exact(v.x + bv.x), gelu_exact(v.y + bv.y));
    } else if constexpr (EPI == kResidual) {
      const float2 xv = __ldg(reinterpret_cast<const float2*>(x + mc * N + nc));
      const float2 bv = make_float2(__ldg(bias + nc), __ldg(bias + nc + 1));
      const float2 sv = make_float2(__ldg(scale + nc), __ldg(scale + nc + 1));
      v = make_float2(xv.x + (v.x + bv.x) * sv.x, xv.y + (v.y + bv.y) * sv.y);
    } else {
      o += (long long)blockIdx.z * M * N;
    }
    if (m < M && n < N) *reinterpret_cast<float2*>(out + o) = v;
  }
}

// ---------------------------------------------------------------------------
// Host side.

// The MLP's form and GEMM 2's K split for width C, chosen for one image of
// hw pixels (never for the batch: a split order that moved with B would
// round differently alone and in a batch) on a card with `sms` SMs, one
// block an SM. The split count minimises a model of GEMM 2's time on an
// H100: each wave of blocks takes its 32-deep K chunks at ~0.7 us each (a
// chunk's 32 KB at ~28 bytes a cycle into the SM) plus ~2 us, and a split
// adds the reduction's launch (~3 us) and the partials' round trip (8 bytes
// an output a split, at ~3 TB/s).
struct Plan {
  bool fused;
  int splits;  // GEMM 2 K splits
  int span;    // GEMM 2 K chunks a split
};

inline Plan plan(long long hw, int C, int sms) {
  if (C <= kFusedMaxC) return {true, 1, 0};
  const long long tiles = cdiv(hw, kBM) * cdiv(C, kBN), slots = sms;
  const int chunks = (int)cdiv(4LL * C, kBK);
  int best = 1;
  double best_us = 1e30;
  for (int s = 1; s <= kMaxSplits && s <= chunks; ++s) {
    const double waves = (double)cdiv(tiles * s, slots);
    const double us = waves * (0.7 * cdiv(chunks, s) + 2.0) +
                      (s > 1 ? 3.0 + 8.0 * hw * C * s / 3.0e6 : 0.0);
    if (us < best_us) best = s, best_us = us;
  }
  const int per = (int)cdiv(chunks, best);
  return {false, (int)cdiv(chunks, per), per};
}

// Floats of workspace after h for the MLP: u (M x 4C) and the split
// partials, for the two-GEMM form.
inline long long workspace_floats(long long M, int C, const Plan& p) {
  if (p.fused) return 0;
  return M * 4 * C + (p.splits > 1 ? M * C * p.splits : 0);
}

template <int CP, bool STORE_U>
cudaError_t launch_fused(const float* h, const float* wpack, const float* b1, const float* b2,
                         const float* scale, const float* x, float* out, float* u_out, long long M,
                         int C, cudaStream_t stream) {
  auto kernel = mlp_fused_tf32_kernel<CP, STORE_U>;
  cudaError_t e = launch_prepare<mlp_fused_tf32_kernel<CP, STORE_U>>(Fused<CP>::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)cdiv(M, kBM), kThreads, Fused<CP>::SMEM, stream>>>(h, wpack, b1, b2, scale, x,
                                                                         out, u_out, M, C);
  return cudaGetLastError();
}

template <int CP>
cudaError_t launch_fused(const float* h, const float* wpack, const float* b1, const float* b2,
                         const float* scale, const float* x, float* out, float* u_out, long long M,
                         int C, cudaStream_t stream) {
  if (u_out != nullptr)
    return launch_fused<CP, true>(h, wpack, b1, b2, scale, x, out, u_out, M, C, stream);
  return launch_fused<CP, false>(h, wpack, b1, b2, scale, x, out, nullptr, M, C, stream);
}

// The tensor map of a row-major (M, K) f32 matrix in boxes of 32 K x 128
// rows with the 128-byte swizzle, zeros past its edges.
inline cudaError_t make_tmap(CUtensorMap* map, const float* A, long long M, int K) {
  const auto encode = conv_tma::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 4};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(A), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int EPI>
cudaError_t launch_gemm(const float* A, const float* Bp, long long M, int N, int K, int splits,
                        int span, const float* bias, const float* x, const float* scale, float* out,
                        cudaStream_t stream) {
  auto kernel = gemm_tf32_wgmma_kernel<EPI>;
  cudaError_t e = launch_prepare<gemm_tf32_wgmma_kernel<EPI>>(GemmRing::SMEM);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  e = make_tmap(&map, A, M, K);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)cdiv(N, kBN), (unsigned)cdiv(M, kBM), splits);
  kernel<<<grid, kThreads, GemmRing::SMEM, stream>>>(map, Bp, M, N, K, span, bias, x, scale, out);
  return cudaGetLastError();
}

// The MLP on h (M, C), the depthwise + LN's output, in the plan's form: w1
// and w2 packed as it reads them (the fused form's one pack in w1). The
// workspace after h (ws) holds workspace_floats(M, C, p) floats; u_out:
// null, or M x 4C floats that receive u (the GELU's f32 output before its
// rounding to TF32): the fused form writes them only there, the two-GEMM
// form keeps u there in place of the workspace's. reduce is convnext_block.cu's
// split reduction (the partials in split order, then the residual).
template <class Reduce>
cudaError_t run_mlp(const float* h, const float* w1, const float* b1, const float* w2,
                    const float* b2, const float* scale, const float* x, float* ws, float* out,
                    float* u_out, long long M, int C, const Plan& p, Reduce reduce,
                    cudaStream_t stream) {
  if (p.fused) {
    switch (fused_width(C)) {
      case 96: return launch_fused<96>(h, w1, b1, b2, scale, x, out, u_out, M, C, stream);
      case 128: return launch_fused<128>(h, w1, b1, b2, scale, x, out, u_out, M, C, stream);
      default: return launch_fused<192>(h, w1, b1, b2, scale, x, out, u_out, M, C, stream);
    }
  }
  float* u = u_out != nullptr ? u_out : ws;
  float* partial = ws + M * 4 * C;
  const int chunks = (int)cdiv(4LL * C, kBK);
  cudaError_t e = launch_gemm<kGelu>(h, w1, M, 4 * C, C, 1, (int)cdiv(C, kBK), b1, nullptr, nullptr,
                                     u, stream);
  if (e != cudaSuccess) return e;
  if (p.splits == 1)
    return launch_gemm<kResidual>(u, w2, M, C, 4 * C, 1, chunks, b2, x, scale, out, stream);
  e = launch_gemm<kPartial>(u, w2, M, C, 4 * C, p.splits, p.span, nullptr, nullptr, nullptr,
                            partial, stream);
  if (e != cudaSuccess) return e;
  return reduce(partial, p.splits);
}

}  // namespace block_tf32
