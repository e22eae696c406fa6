// The ConvNeXt block in bf16 for Hopper (sm_90a), NHWC, the body of the
// block's bf16 libraries (convnext_block.cu built with
// -DCONVNEXT_BLOCK_BF16; the f32 library includes this file only for the
// helpers block_tf32.cuh shares, and launches none of its kernels):
//
//   h = LN(dwconv7x7(x) + dw_b)                        (dw_ln_pairs_kernel)
//   out = x + scale * (W2 . GELU(W1 . h + b1) + b2)    (the MLP, below)
//
// It is the bf16 counterpart of the Pallas TPU kernel
// adascale/ops/pallas/convnext_block.py::fused_convnext_block (`_kernel` at
// :68, which runs dw -> LN -> MLP -> residual in one body and never writes
// h or the 4C hidden u to memory). h goes through device memory in bf16
// (2 C bytes a pixel each way); u does only where that is cheaper than
// keeping it on chip.
//
// What bounds it: 16 C^2 flops a pixel for the two products against, where
// u goes through device memory, 16 C bytes a pixel for its bf16 write and
// read: at the H100's 989 TFLOP/s dense bf16 and 3.35 TB/s (295 flops a
// byte) the hidden's bytes cost more than its products while C < 295, and
// less above. So two forms, by C:
//
//   * fused (C <= kFusedMaxC; tiny's stages 0-1, C = 96 / 192; base's 128;
//     large's 192): one launch, mlp_fused_kernel. A block owns 128
//     pixels: two consumer warpgroups of 64 rows each and one producer warp.
//     The warpgroup's h rows (all C) sit in shared memory. The hidden units
//     are walked in chunks of kNH = 64, in order; the producer warp brings
//     each chunk's W1 rows and W2 columns, packed once per parameter set,
//     by one bulk copy on a ring of mbarriers (full: the copy landed;
//     empty: the 8 consumer warps are done with it). Per chunk a
//     warpgroup runs GEMM 1, wgmma m64n64k16 with A (h) and B (W1) from
//     shared memory; adds b1 and takes the GELU in f32 on the f32 sums;
//     rounds u to bf16 into registers in the A-fragment order of the next
//     wgmma (the accumulator's layout is that order); and runs GEMM 2,
//     wgmma m64nCk16 with A from those registers, accumulating the C-wide
//     output in registers over every chunk. u never leaves the SM. The
//     residual epilogue follows the last chunk. C is padded to the wgmma
//     width fused_width(C) (zero W1 columns and W2 rows).
//   * two GEMMs (wider C: the accumulators would not fit; with the producer
//     warp a block's threads get 168 registers, and at C = 256 the fused
//     form spilled): gemm_wgmma_kernel twice, u through device memory in
//     bf16. A block owns 128 pixel rows (two consumer warpgroups) by 128
//     columns, two blocks an SM; K is staged 64 deep through a ring of
//     kStages, A (h, or u) by TMA with the 128-byte swizzle and B (packed
//     once) by one bulk copy, both on the stage's mbarrier, kAhead chunks
//     loaded ahead. GEMM 1 takes the GELU epilogue; GEMM 2 the residual, or
//     (few output tiles: plan) splits K and writes f32 partials that
//     reduce_bf16_kernel adds in split order.
//
// Both forms are batch-invariant: a pixel's sums run in the same order
// wherever its row falls and whatever B is (the fused form walks the chunks
// in order; the split plan of GEMM 2 is chosen for one image, H W pixels).
// The operands are K-major bf16. The weights and the fused form's h rows
// use wgmma's no-swizzle core-matrix layout (8 rows x 16 bytes a core
// matrix, the next along K 128 bytes on): cp.async writes one core-matrix
// row a copy, four threads a row and eight rows a warp, 512 contiguous
// bytes, and a bulk copy brings a packed tile as it lies in device memory
// (kernels/packing.py::pack_core_kmajor). The two-GEMM form's A comes by
// TMA in the 128-byte swizzle (desc_sw128): on an H100 that took GEMM 1 of
// 60x48x384 from 27 to 18 us against cp.async into core matrices.
//
// The roundings are the block's (convnext_block.cu): the Pallas mode's GELU
// exact in f32 on the f32 sum plus bias, then bf16, its residual x + (y +
// b2) * scale in f32, then the output type; the module mode rounds where
// Flax does (gelu_bf16, residual_pair).

#pragma once

#include "conv_gemm.cuh"
#include "conv_tma.cuh"

namespace block_bf16 {

using conv_gemm::bf16;
using conv_gemm::round_bf16;
using conv_tma::bulk_copy;
using conv_tma::desc_sw128;
using conv_tma::encode_tiled;
using conv_tma::keep_regs;
using conv_tma::kK16Sw128;
using conv_tma::mbar_arrive;
using conv_tma::mbar_expect;
using conv_tma::tma_load_2d;

constexpr int kBM = 128;                        // pixel rows a block: two warpgroups of 64
constexpr int kConsumers = 256;                 // the two consumer warpgroups
constexpr int kNH = 64;                         // hidden units a chunk (fused form)
constexpr int kMaxC = 1536;                     // the widest C the block takes
constexpr int kFusedMaxC = 192;                 // the widest C of the fused form
constexpr int kFusedThreads = kConsumers + 32;  // and one producer warp
constexpr int kBN = 128;                        // two-GEMM form: output columns a block
constexpr int kBK = 64;                         // two-GEMM form: K a stage
constexpr int kStages = 3;
constexpr int kAhead = 2;                       // chunks loaded ahead of the one computed
constexpr int kMaxSplits = 8;
constexpr int kSmemLimit = 232448;              // dynamic shared memory a block may use

enum Epilogue { kGelu = 0, kResidual = 1, kPartial = 2 };

__host__ __device__ inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Opts the kernel in to `smem` bytes of dynamic shared memory, once a device
// (a launch then pays nothing for it).
template <auto kernel>
cudaError_t launch_prepare(int smem) {
  static unsigned done;  // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 32 && (__atomic_load_n(&done, __ATOMIC_ACQUIRE) >> dev & 1u))) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < 32) __atomic_fetch_or(&done, 1u << dev, __ATOMIC_RELEASE);
  return e;
}

// The fused form's wgmma width for C (C <= kFusedMaxC): GEMM 2's N and
// GEMM 1's K.
__host__ __device__ constexpr int fused_width(int c) {
  return c <= 96 ? 96 : c <= 128 ? 128 : 192;
}

// Shared-memory descriptor of a K-major bf16 operand without swizzle: core
// matrices of 8 rows x 16 bytes, the next along K 128 bytes on (leading
// byte offset), the next 8 rows `sbo` bytes on (stride byte offset).
// Adding kK16 moves it 16 K (256 bytes) on.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t sbo) {
  return (uint64_t)(((saddr & 0x3ffffu) >> 4) | ((128u >> 4) << 16)) | ((uint64_t)(sbo >> 4) << 32);
}
constexpr uint64_t kK16 = 256 >> 4;

// An f32 pair read once: the empty asm stands for a change of the value, so
// the compiler keeps it in registers instead of reading it again for each
// use (left to itself it re-read the depthwise taps for every product).
__device__ __forceinline__ float2 load_once(const float* p) {
  float2 v = *reinterpret_cast<const float2*>(p);
  asm volatile("" : "+f"(v.x), "+f"(v.y));
  return v;
}

// Barrier `id` (1 + warpgroup) over one warpgroup's 128 threads.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma.mma_async m64nNk16 bf16 with f32 sums; d's register order is the one of
// conv_gemm.cuh's wgmma_n96 (thread (g, t) of warp w holds d[4 j + e] = row
// 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2).

// d (64 x 64) += A (64 x 16) . B (64 x 16)^T, both from shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128) += A (64 x 16) . B (128 x 16)^T, both from shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 96) += A (64 x 16, bf16 pairs in registers) . B (96 x 16)^T from shared memory.
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
      "}, {%48,%49,%50,%51}, %52, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128) += A (64 x 16, bf16 pairs in registers) . B (128 x 16)^T from shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
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

// d (64 x 192) += A (64 x 16, bf16 pairs in registers) . B (192 x 16)^T from shared memory.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
      "}, {%96,%97,%98,%99}, %100, p, 1, 1, 0;\n}\n"
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

// Copies rows [row0, row0 + ROWS) x columns [k0, k0 + KP) of the row-major
// (M, ld) bf16 matrix A by cp.async into the core-matrix tile s (row group,
// K group of KP / 8, row, K in group), zero past row M and column kend; the
// `lanes` threads from `id` share it. 32 consecutive pieces are eight rows
// by four K groups: 64 contiguous bytes of each row read, 512 contiguous
// bytes written.
template <int ROWS, int KP>
__device__ __forceinline__ void load_tile(unsigned char* s, const bf16* __restrict__ A,
                                          long long row0, int k0, long long M, int ld, int kend,
                                          int id, int lanes) {
  constexpr int KG = KP / 8;
  static_assert(ROWS % 8 == 0 && KG % 4 == 0, "tile");
#pragma unroll 4
  for (int idx = id; idx < ROWS * KG; idx += lanes) {
    const int q = idx >> 5;
    const int kg = q % (KG / 4) * 4 + (idx & 3), r = (idx >> 2) & 7, rg = q / (KG / 4);
    const long long m = row0 + rg * 8 + r;
    const int k = k0 + kg * 8;
    const bool ok = m < M && k < kend;
    conv_gemm::cp_async16(s + (rg * KG + kg) * 128 + r * 16, ok ? A + m * ld + k : A, ok);
  }
}

// jax.nn.gelu(x, approximate=False) on a bf16 x as XLA computes it: 0.5 x
// erfc(-x s), s = sqrt(1/2) in bf16, each product and the erfc rounded to
// bf16.
__device__ __forceinline__ float gelu_bf16(float v) {
  const float e = round_bf16(erfcf(round_bf16(-v * 0.70703125f)));
  return round_bf16(0.5f * v * e);
}

// gelu_bf16 is a function of one bf16 value, and a table holds it where it
// is not simpler: for |z| in [2^-12, 2^4), kGeluTable bf16 values (8 KB),
// by sign, binade and mantissa. Below, erfc rounds to 1 and the GELU is
// z / 2 (rounded: below the normal range halving drops a bit); from 16 on, erfc rounds to 2 (z > 0: the GELU is z) or to 0 (z <
// 0: -0; -inf gives NaN). The library checks the table and these rules
// against gelu_bf16 on the card for all 65536 bf16 values before the first
// launch (gelu_table_check_kernel). A lookup is some ten instructions where
// gelu_bf16 (erfcf and five roundings) is some sixty.
constexpr int kGeluExp0 = 127 - 12;  // the biased exponent of the table's first binade
constexpr int kGeluBinades = 16;
constexpr int kGeluTable = 2 * kGeluBinades * 128;

__device__ __forceinline__ float gelu_bf16_lookup(const uint16_t* tab, float z) {
  const uint32_t bits = __float_as_uint(z) >> 16, e = (bits >> 7) & 0xffu, neg = bits >> 15;
  const uint32_t i = e - kGeluExp0;  // past the table: large
  const uint32_t idx = (neg * kGeluBinades + (i < kGeluBinades ? i : 0u)) * 128 + (bits & 0x7fu);
  const float t = __uint_as_float((uint32_t)tab[idx] << 16);
  const float far = neg ? (e == 0xffu ? __uint_as_float(0x7fc00000u) : -0.0f) : z;
  return i < kGeluBinades ? t : (e < kGeluExp0 ? round_bf16(0.5f * z) : far);
}

// The bf16 value of table entry idx.
__device__ __forceinline__ float gelu_table_input(int idx) {
  const uint32_t neg = idx / (kGeluBinades * 128), e = kGeluExp0 + idx / 128 % kGeluBinades;
  return __uint_as_float((neg << 31) | (e << 23) | ((uint32_t)(idx % 128) << 16));
}

__global__ void gelu_table_fill_kernel(uint16_t* tab) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < kGeluTable) tab[idx] = (uint16_t)(__float_as_uint(gelu_bf16(gelu_table_input(idx))) >> 16);
}

// Counts the bf16 values whose lookup is not gelu_bf16's (NaN matches NaN).
__global__ void gelu_table_check_kernel(const uint16_t* tab, unsigned* bad) {
  const uint32_t bits = blockIdx.x * blockDim.x + threadIdx.x;
  if (bits >= 65536u) return;
  const float z = __uint_as_float(bits << 16);
  const float want = gelu_bf16(z), got = gelu_bf16_lookup(tab, z);
  if (__float_as_uint(want) != __float_as_uint(got) && !(want != want && got != got)) atomicAdd(bad, 1u);
}

// Copies the table to shared memory (16-byte cp.async, not yet waited).
__device__ __forceinline__ void copy_gelu_table(uint16_t* dst, const uint16_t* tab, int id, int lanes) {
  for (int i = id; i < kGeluTable / 8; i += lanes) conv_gemm::cp_async16(dst + 8 * i, tab + 8 * i, true);
}

// u before its bf16 cast, from GEMM 1's f32 sum v and the bias b: the Pallas
// mode's exact GELU in f32, or the module mode's Flax roundings (the sum
// and the bias each to bf16, their sum, then XLA's bf16 GELU, looked up in
// tab).
template <bool MODULE>
__device__ __forceinline__ float gelu_up(float v, float b, const uint16_t* tab) {
  if constexpr (MODULE) return gelu_bf16_lookup(tab, round_bf16(round_bf16(v) + round_bf16(b)));
  return conv_gemm::gelu_exact(v + b);
}

// u's bf16 pair (v0 + b[n], v1 + b[n + 1]) as one register, the low half
// the first. Callers compute every pair without a branch around it, even
// past the real units (their W2 columns are zero): a branch a pair ends a
// basic block, and the compiler then runs a thread's GELUs one after
// another instead of interleaving their chains (on an H100 that cost the
// fused kernel a third of its time).
template <bool MODULE>
__device__ __forceinline__ uint32_t gelu_pair(float v0, float v1, const float* __restrict__ b, int n,
                                              const uint16_t* tab) {
  const __nv_bfloat162 u = __floats2bfloat162_rn(gelu_up<MODULE>(v0, __ldg(b + n), tab),
                                                 gelu_up<MODULE>(v1, __ldg(b + n + 1), tab));
  return *reinterpret_cast<const uint32_t*>(&u);
}

// out[o], out[o + 1] (features n, n + 1) from GEMM 2's f32 sums: the Pallas
// mode x + (v + b2) * scale in f32, then its type (bf16); the module mode
// rounds v + b2 as Flax's Dense does (v and the bias to bf16, their sum) and
// keeps the residual in f32.
template <bool MODULE, typename XT>
__device__ __forceinline__ void residual_pair(float v0, float v1, long long o, int n,
                                              const float* __restrict__ b2,
                                              const XT* __restrict__ x,
                                              const float* __restrict__ scale, XT* __restrict__ out) {
  float y0 = v0 + b2[n], y1 = v1 + b2[n + 1];
  if constexpr (MODULE) {
    y0 = round_bf16(round_bf16(v0) + round_bf16(b2[n]));
    y1 = round_bf16(round_bf16(v1) + round_bf16(b2[n + 1]));
  }
  const float2 xv = conv_gemm::load_pair(x + o);
  conv_gemm::store_pair(out + o, xv.x + y0 * scale[n], xv.y + y1 * scale[n + 1]);
}

// ---------------------------------------------------------------------------
// The depthwise 7x7 + bias + LayerNorm -> h (bf16), for every C.
//
// A thread owns NP channel pairs (p, p + DP, ...) of one strip of DW
// pixels along a row: threadIdx.x walks the channel pairs, threadIdx.y the
// TR strips of a group, TR rows down one column of strips, and the block
// walks the groups (gridDim.x apart). A group's input, with its 3-pixel
// halo and all C channels, is first copied to shared memory in bf16 (zeros
// outside the map; an f32 x, the module mode's, rounded on the way, as the
// module mode rounds it anyway), so that a thread's inputs are shared loads
// and a group waits for one copy. A tap pair (taps packed tap-major by the
// wrapper) is one 8-byte read feeding 2 DW products; an input pair is read
// once and used at once by the up to 7 outputs it touches. TILE (C <= 64
// NP): a warp owns a strip, all of its channels (NP passes of 32 pairs), so
// that the LayerNorm's sums are warp shuffles with no barrier, and the taps
// sit in shared memory. Else a strip's channel pairs spread over warps,
// their sums meet in a shared table in a fixed order, and each thread reads
// its taps through the L1 cache. Each channel's sum runs as
// convnext_block.cu's dw_ln_kernel runs it (the bias, then ky-major,
// kx-minor fused products), with the same roundings: ROUND (the module
// mode) rounds x and the taps, and the depthwise, its bias and their sum,
// to bf16.
template <int NP, int DW, bool TILE>
struct DwLn {
  // Channel pairs a thread's x walks: all C / 2 pairs over NP passes, in
  // whole warps; strips a block (TILE: 8 warps, else up to 384 threads);
  // the input tile's bytes; the shared memory (TILE: the taps as 49 rows
  // of all channels; the LN table; the tile).
  static int pairs_x(int C) { return TILE ? 32 : (int)cdiv(cdiv(C / 2, NP), 32) * 32; }
  static int strips(int C) { return TILE ? 8 : pairs_x(C) >= 384 ? 1 : 384 / pairs_x(C); }
  static int tile_bytes(int C) { return (strips(C) + 6) * (DW + 6) * C * 2; }
  static int smem(int C) {
    const int floats = (TILE ? 49 * 64 * NP : 0) + strips(C) * (pairs_x(C) / 32) * DW;
    return (floats + 3) / 4 * 4 * (int)sizeof(float) + tile_bytes(C);
  }
};

template <int NP, int DW, bool TILE, typename XT, bool ROUND>
__global__ void __launch_bounds__(TILE ? 256 : 384, TILE ? 2 : 1)
dw_ln_pairs_kernel(const XT* __restrict__ x, const float* __restrict__ dw_t,
                   const float* __restrict__ dw_b, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, bf16* __restrict__ h, int B, int H, int W,
                   int C) {
  static_assert(!TILE || std::is_same<XT, bf16>::value || ROUND, "an f32 tile is rounded");
  // TILE: the taps [49][ld]; then the [TR][warps][DW] sums; then (TILE) the
  // input tile [TR + 6][DW + 6][C], bf16.
  extern __shared__ __align__(16) float dsm[];
  const int DP = blockDim.x, TR = blockDim.y, warps = DP / 32, ld = TILE ? 2 * DP * NP : 0;
  const int tid = threadIdx.y * DP + threadIdx.x, nt = DP * TR;
  const int lane = threadIdx.x % 32, wx = threadIdx.x / 32;
  float* taps = dsm;
  float* tab = dsm + 49 * ld + threadIdx.y * warps * DW;
  bf16* tile = reinterpret_cast<bf16*>(dsm + (49 * ld + TR * warps * DW + 3) / 4 * 4);
  const int sw = (W + DW - 1) / DW;  // strips a row
  const int th = (H + TR - 1) / TR;  // TILE: tiles down a column
  const long long groups = (long long)B * th * sw;
  const float inv_c = 1.0f / C;

  // TILE: the taps (packed tap-major, (49, C), by the wrapper) copied 16
  // bytes at a time, zero past C.
  auto load_taps = [&] {
    const int per = ld / 4;
    for (int i = tid; i < 49 * per; i += nt) {
      const int t = i / per, c = 4 * (i - t * per);
      conv_gemm::cp_async16(taps + t * ld + c, c < C ? dw_t + (long long)t * C + c : dw_t, c < C);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  };
  // The strip's sums over C: this thread's pairs, its warp, then the
  // strip's warps in order, the same for every pixel and every B.
  auto strip_sum = [&](float (&v)[DW]) {
    if constexpr (TILE) {  // one warp a strip
#pragma unroll
      for (int r = 0; r < DW; ++r) v[r] = conv_gemm::warp_sum(v[r]);
      return;
    }
#pragma unroll
    for (int r = 0; r < DW; ++r) {
      const float s = conv_gemm::warp_sum(v[r]);
      if (lane == 0) tab[wx * DW + r] = s;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < DW; ++r) {
      float s = 0.0f;
      for (int w = 0; w < warps; ++w) s += tab[w * DW + r];
      v[r] = s;
    }
    __syncthreads();
  };

  if constexpr (TILE) {
    load_taps();
    __syncthreads();
  }
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    int b, y, x0;
    bool live;
    {
      b = (int)(grp / ((long long)th * sw));
      const int rem = (int)(grp % ((long long)th * sw));
      const int y0 = rem % th * TR;
      x0 = rem / th * DW;
      y = y0 + threadIdx.y;
      live = y < H;
      // The tile's input rows y0 - 3 .. y0 + TR + 2, columns x0 - 3 .. x0 +
      // DW + 2, 8 channels a copy, zero outside the map, once every warp is
      // done with the last group's.
      __syncthreads();
      const int per = C / 8, cols = DW + 6;
      const XT* xs = x + (long long)b * H * W * C;
      for (int i = tid; i < (TR + 6) * cols * per; i += nt) {
        const int pix = i / per, q = i - pix * per;
        const int iy = y0 - 3 + pix / cols, ix = x0 - 3 + pix % cols;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
        bf16* dst = tile + (long long)pix * C + 8 * q;
        const XT* src = ok ? xs + ((long long)iy * W + ix) * C + 8 * q : x;
        if constexpr (std::is_same<XT, bf16>::value) {
          conv_gemm::cp_async16(dst, src, ok);
        } else {
          float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
          if (ok) lo = reinterpret_cast<const float4*>(src)[0], hi = reinterpret_cast<const float4*>(src)[1];
          __nv_bfloat162 v[4] = {__floats2bfloat162_rn(lo.x, lo.y), __floats2bfloat162_rn(lo.z, lo.w),
                                 __floats2bfloat162_rn(hi.x, hi.y), __floats2bfloat162_rn(hi.z, hi.w)};
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
        }
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }

    float d[NP][2][DW];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int c = 2 * (threadIdx.x + k * DP);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < DW; ++r) d[k][e][r] = 0.0f;
      if (!live || c >= C) continue;
      const float bias0 = __ldg(dw_b + c), bias1 = __ldg(dw_b + c + 1);
#pragma unroll
      for (int r = 0; r < DW; ++r) {
        d[k][0][r] = ROUND ? 0.0f : bias0;
        d[k][1][r] = ROUND ? 0.0f : bias1;
      }
      // A thread's taps: from shared memory (TILE), else straight from the
      // packed (49, C) taps through the L1 cache, read once a row.
      const float* tp = TILE ? taps + c : dw_t + c;
      const int tstride = TILE ? ld : C;
#pragma unroll
      for (int ky = 0; ky < 7; ++ky) {
        const bf16* trow = tile + (threadIdx.y + ky) * (DW + 6) * C + c;
        float2 wk[7];
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          wk[kx] = load_once(tp + (ky * 7 + kx) * tstride);
          if constexpr (ROUND) wk[kx] = make_float2(round_bf16(wk[kx].x), round_bf16(wk[kx].y));
        }
        // Each input pair is loaded once and used at once by the up to 7
        // outputs it touches (output r takes input r + kx, kx ascending).
#pragma unroll
        for (int j = 0; j < DW + 6; ++j) {
          const float2 v = conv_gemm::load_pair(trow + j * C);
#pragma unroll
          for (int kx = 6; kx >= 0; --kx) {
            const int r = j - kx;
            if (r < 0 || r >= DW) continue;
            d[k][0][r] = fmaf(v.x, wk[kx].x, d[k][0][r]);
            d[k][1][r] = fmaf(v.y, wk[kx].y, d[k][1][r]);
          }
        }
      }
      if constexpr (ROUND) {
#pragma unroll
        for (int r = 0; r < DW; ++r) {
          d[k][0][r] = round_bf16(round_bf16(d[k][0][r]) + round_bf16(bias0));
          d[k][1][r] = round_bf16(round_bf16(d[k][1][r]) + round_bf16(bias1));
        }
      }
    }

    float mean[DW], rstd[DW];
#pragma unroll
    for (int r = 0; r < DW; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < NP; ++k) s += d[k][0][r] + d[k][1][r];  // zero past C
      mean[r] = s;
    }
    strip_sum(mean);
#pragma unroll
    for (int r = 0; r < DW; ++r) {
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
    if (!live) continue;
#pragma unroll
    for (int r = 0; r < DW; ++r) rstd[r] = rsqrtf(rstd[r] * inv_c + conv_gemm::kEps);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int c = 2 * (threadIdx.x + k * DP);
      if (c >= C) continue;
      const float g0 = __ldg(ln_g + c), g1 = __ldg(ln_g + c + 1);
      const float o0 = __ldg(ln_b + c), o1 = __ldg(ln_b + c + 1);
      bf16* out = h + (((long long)b * H + y) * W + x0) * C + c;
#pragma unroll
      for (int r = 0; r < DW; ++r)
        if (x0 + r < W)
          conv_gemm::store_pair(out + (long long)r * C, (d[k][0][r] - mean[r]) * rstd[r] * g0 + o0,
                                (d[k][1][r] - mean[r]) * rstd[r] * g1 + o1);
    }
  }
}

// One launch over all strips: as many blocks as the card holds at once (at
// most one a group of strips), each walking groups gridDim.x apart.
template <int NP, int DW, bool TILE, typename XT, bool ROUND>
cudaError_t launch_dw_ln(const XT* x, const float* dw_t, const float* dw_b, const float* ln_g,
                         const float* ln_b, bf16* h, int B, int H, int W, int C, int sms,
                         cudaStream_t stream) {
  using D = DwLn<NP, DW, TILE>;
  auto kernel = dw_ln_pairs_kernel<NP, DW, TILE, XT, ROUND>;
  const dim3 block(D::pairs_x(C), D::strips(C));
  const int smem = D::smem(C);
  cudaError_t e = launch_prepare<dw_ln_pairs_kernel<NP, DW, TILE, XT, ROUND>>(kSmemLimit);
  if (e != cudaSuccess) return e;
  // Blocks an SM, by C (the grid's size only; any grid is right), found once.
  static int per_sm_by_c[kMaxC / 8 + 1];
  int per_sm = per_sm_by_c[C / 8];
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block.x * block.y, smem);
    if (e != cudaSuccess) return e;
    per_sm_by_c[C / 8] = per_sm;
  }
  const long long groups = (long long)B * cdiv(H, block.y) * cdiv(W, DW);
  const long long grid = groups < (long long)sms * per_sm ? groups : (long long)sms * per_sm;
  kernel<<<(unsigned)(grid > 0 ? grid : 1), block, smem, stream>>>(x, dw_t, dw_b, ln_g, ln_b, h, B,
                                                                  H, W, C);
  return cudaGetLastError();
}

// Up to 192 channels, a warp a strip of 8 pixels (2 or 3 passes of 32
// pairs); up to 768, one pair a thread over strips of 8; wider, two pairs a
// thread (a pass each) over strips of 4.
template <typename XT, bool ROUND>
cudaError_t run_dw_ln(const XT* x, const float* dw_t, const float* dw_b, const float* ln_g,
                      const float* ln_b, bf16* h, int B, int H, int W, int C, int sms,
                      cudaStream_t stream) {
  if (C <= 128)
    return launch_dw_ln<2, 8, true, XT, ROUND>(x, dw_t, dw_b, ln_g, ln_b, h, B, H, W, C, sms,
                                               stream);
  if (C <= 192)
    return launch_dw_ln<3, 8, true, XT, ROUND>(x, dw_t, dw_b, ln_g, ln_b, h, B, H, W, C, sms,
                                               stream);
  if (C <= 768)
    return launch_dw_ln<1, 8, false, XT, ROUND>(x, dw_t, dw_b, ln_g, ln_b, h, B, H, W, C, sms,
                                                stream);
  return launch_dw_ln<2, 4, false, XT, ROUND>(x, dw_t, dw_b, ln_g, ln_b, h, B, H, W, C, sms,
                                              stream);
}

// ---------------------------------------------------------------------------
// The fused form.

template <int CP>
struct Fused {
  static constexpr int W_BYTES = 4 * kNH * CP;  // a chunk: W1 (kNH x CP), then W2 (CP x kNH)
  static constexpr int H_BYTES = 2 * kBM * CP;  // the block's h rows
  static constexpr int T_BYTES = 2 * kGeluTable;  // the module mode's GELU table
  static constexpr int STAGES = (kSmemLimit - H_BYTES - T_BYTES - 64) / W_BYTES < 4
                                    ? (kSmemLimit - H_BYTES - T_BYTES - 64) / W_BYTES
                                    : 4;
  // The ring, h, the table, the barriers.
  static constexpr int SMEM = STAGES * W_BYTES + H_BYTES + T_BYTES + 16 * STAGES;
  static_assert(STAGES >= 2, "ring");
};

// h (M, C) and x, out (M, C) row-major; wpack: per chunk of kNH hidden
// units, W1's rows (kNH x CP, K = the input channels) as (8, CP / 8, 8, 8)
// core matrices, then W2's columns of those units (CP x kNH, K = the hidden
// units) as (CP / 8, 8, 8, 8), zero past C and 4C. Block x owns pixel rows
// [128 x, 128 x + 128).
template <int CP, bool MODULE, typename XT>
__global__ void __launch_bounds__(kFusedThreads, 1)
mlp_fused_kernel(const bf16* __restrict__ h, const bf16* __restrict__ wpack,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 const float* __restrict__ scale, const XT* __restrict__ x, XT* __restrict__ out,
                 long long M, int C, const uint16_t* __restrict__ gelu_table) {
  using F = Fused<CP>;
  constexpr int S = F::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t htile = sbase + S * F::W_BYTES;
  const uint32_t full = htile + F::H_BYTES + F::T_BYTES, empty = full + 8 * S;
  uint16_t* gtab = reinterpret_cast<uint16_t*>(smem + S * F::W_BYTES + F::H_BYTES);
  const int chunks = (4 * C + kNH - 1) / kNH;
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

  if (tid >= kConsumers) {  // the producer warp: one thread walks the chunks
    if (tid == kConsumers) {
      for (int j = 0; j < chunks; ++j) {
        const int s = j % S;
        if (j >= S) conv_gemm::mbar_wait(empty + 8 * s, (j / S - 1) & 1);
        conv_gemm::bulk_load(sbase + s * F::W_BYTES, wpack + (long long)j * (F::W_BYTES / 2),
                             F::W_BYTES, full + 8 * s);
      }
    }
    return;
  }

  const int wg = tid / 128, lane = tid % 32, warp = tid % 128 / 32;
  const int g = lane / 4, t4 = lane % 4;
  // This warpgroup's 64 h rows: 8 row groups of CP / 8 core matrices.
  load_tile<64, CP>(smem + S * F::W_BYTES + wg * 128 * CP, h, m0 + 64 * wg, 0, M, C, C, tid % 128,
                    128);
  // Each warpgroup copies all of the table (the same bytes), so that its
  // own barrier covers it.
  if constexpr (MODULE) copy_gelu_table(gtab, gelu_table, tid % 128, 128);
  conv_gemm::cp_async_commit();
  conv_gemm::cp_async_wait<0>();
  conv_gemm::fence_proxy_async();
  warpgroup_sync(1 + wg);

  const uint64_t da = desc(htile + wg * 128 * CP, 16 * CP);
  float acc2[CP / 2], acc1[kNH / 2];
  uint32_t ua[kNH / 4];
#pragma unroll
  for (int i = 0; i < CP / 2; ++i) acc2[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kNH / 2; ++i) acc1[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kNH / 4; ++i) ua[i] = 0u;

  for (int j = 0; j < chunks; ++j) {
    const int s = j % S;
    conv_gemm::mbar_wait(full + 8 * s, (j / S) & 1);
    const uint32_t w1 = sbase + s * F::W_BYTES;
    const uint64_t db1 = desc(w1, 16 * CP), db2 = desc(w1 + F::W_BYTES / 2, 16 * kNH);
    // The operands are settled before the warpgroup's wgmmas start and
    // untouched until they end (else ptxas serialises the wgmmas).
    conv_gemm::fence_regs(acc1);
    conv_gemm::wgmma_fence();
#pragma unroll
    for (int k = 0; k < CP / 16; ++k) wgmma_ss_n64(acc1, da + k * kK16, db1 + k * kK16, k > 0);
    conv_gemm::wgmma_commit();
    conv_gemm::fence_regs(acc1);
    conv_gemm::wgmma_wait<0>();
    conv_gemm::fence_regs(acc1);
    // Register i holds hidden unit 8 (i / 4) + 2 t4 + i % 2 of the chunk, so
    // the pairs of k-step q are ua[4 q .. 4 q + 3]: the A fragment of a
    // m64nNk16 wgmma (rows g and g + 8, K 2 t4 and 2 t4 + 8).
#pragma unroll
    for (int i = 0; i < kNH / 2; i += 2) {
      const int n = j * kNH + 8 * (i / 4) + 2 * t4;
      ua[i / 2] = gelu_pair<MODULE>(acc1[i], acc1[i + 1], b1, n < 4 * C ? n : 4 * C - 2, gtab);
    }
    keep_regs(ua);
    conv_gemm::fence_regs(acc2);
    conv_gemm::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kNH / 16; ++k) wgmma_rs<CP>(acc2, ua + 4 * k, db2 + k * kK16, 1);
    conv_gemm::wgmma_commit();
    conv_gemm::fence_regs(acc2);
    conv_gemm::wgmma_wait<0>();  // ua is free, and the stage: one arrival a warp
    conv_gemm::fence_regs(acc2);
    keep_regs(ua);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  const long long row = m0 + 64 * wg + 16 * warp + g;
#pragma unroll
  for (int i = 0; i < CP / 2; i += 2) {
    const int n = 8 * (i / 4) + 2 * t4;
    const long long m = row + 8 * ((i / 2) % 2);
    if (m < M && n < C) residual_pair<MODULE>(acc2[i], acc2[i + 1], m * C + n, n, b2, x, scale, out);
  }
}

// ---------------------------------------------------------------------------
// The two-GEMM form.

struct GemmRing {
  static constexpr int A_BYTES = kBM * kBK * 2;
  static constexpr int B_BYTES = kBN * kBK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // The ring (from a 1024-byte boundary: the swizzle's period), then its
  // barriers.
  static constexpr int SMEM = 1024 + kStages * STAGE + 32 + 2 * kGeluTable;
  static_assert(kStages - kAhead >= 1, "ring: a stage is reloaded after its products are done");
};

// C[M, N] = A[M, K] . B[N, K]^T, bf16 operands, f32 sums, and the epilogue:
//   kGelu:     out (bf16)[m, n] = gelu_up(acc, bias[n])
//   kResidual: out (XT)[m, n] = residual_pair(acc)
//   kPartial:  out (f32)[z][m, n] = acc
// Block (x, y, z) owns columns [128 x, +128), rows [128 y, +128) and the K
// chunks [span z, span (z + 1)). A (M, K), row-major, comes through the
// tensor map tmap_a (boxes of 64 K x 128 rows, 128-byte swizzle); Bp holds,
// per 128-column tile and 64-deep K chunk, a (16, 8, 8, 8) core-matrix
// tile, zero past N and K. Thread 0 brings both a chunk, one TMA copy and
// one bulk copy on the stage's mbarrier. K and N are multiples of 8.
template <int EPI, bool MODULE, typename XT>
__global__ void __launch_bounds__(kConsumers, 2)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_a, const bf16* __restrict__ Bp,
                  long long M, int N, int K, int span, const float* __restrict__ bias,
                  const XT* __restrict__ x, const float* __restrict__ scale,
                  void* __restrict__ out, const uint16_t* __restrict__ gelu_table) {
  using R = GemmRing;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32, warp = tid % 128 / 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t sraw = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sbase = (sraw + 1023) & ~1023u;
  const uint32_t bars = sbase + kStages * R::STAGE;
  // The module mode's GELU table, after the barriers (copied now, waited
  // for before the first barrier of the main loop).
  uint16_t* gtab = reinterpret_cast<uint16_t*>(smem + (bars - sraw) + 32);
  if constexpr (MODULE && EPI == kGelu) {
    copy_gelu_table(gtab, gelu_table, tid, kConsumers);
    conv_gemm::cp_async_commit();
    conv_gemm::cp_async_wait<0>();
  }
  const long long m0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kchunks = (K + kBK - 1) / kBK;
  const int kc0 = blockIdx.z * span;
  const int nk = min(kchunks, kc0 + span) - kc0;
  const bf16* Bt = Bp + (long long)blockIdx.x * kchunks * (kBN * kBK);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) conv_gemm::mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int kt) {
    if (tid != 0 || kt >= nk) return;
    const int s = kt % kStages;
    const uint32_t st = sbase + s * R::STAGE, bar = bars + 8 * s;
    mbar_expect(bar, R::A_BYTES + R::B_BYTES);
    tma_load_2d(st, &tmap_a, (kc0 + kt) * kBK, (int)m0, bar);
    bulk_copy(st + R::A_BYTES, Bt + (long long)(kc0 + kt) * (kBN * kBK), R::B_BYTES, bar);
  };

  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) load(s);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    conv_gemm::mbar_wait(bars + 8 * s, (kt / kStages) & 1);
    // Every warpgroup is done with chunk kt - 1, whose stage the next load
    // takes.
    __syncthreads();
    load(kt + kAhead);
    const uint32_t st = sbase + s * R::STAGE;
    const uint64_t da = desc_sw128(st + wg * 64 * 128), db = desc(st + R::A_BYTES, 1024);
    conv_gemm::fence_regs(acc);
    conv_gemm::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) wgmma_ss_n128(acc, da + k * kK16Sw128, db + k * kK16, 1);
    conv_gemm::wgmma_commit();
    conv_gemm::fence_regs(acc);
    conv_gemm::wgmma_wait<0>();
    conv_gemm::fence_regs(acc);
  }

  const long long row = m0 + 64 * wg + 16 * warp + g;
#pragma unroll
  for (int i = 0; i < kBN / 2; i += 2) {
    const int n = n0 + 8 * (i / 4) + 2 * t4;
    const long long m = row + 8 * ((i / 2) % 2);
    const long long o = m * N + n;
    if constexpr (EPI == kGelu) {
      const uint32_t u = gelu_pair<MODULE>(acc[i], acc[i + 1], bias, n < N ? n : N - 2, gtab);
      if (m < M && n < N) *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + o) = u;
      continue;
    }
    if (m >= M || n >= N) continue;
    if constexpr (EPI == kResidual) {
      residual_pair<MODULE>(acc[i], acc[i + 1], o, n, bias, x, scale, static_cast<XT*>(out));
    } else {
      *reinterpret_cast<float2*>(static_cast<float*>(out) + blockIdx.z * M * N + o) =
          make_float2(acc[i], acc[i + 1]);
    }
  }
}

// Adds GEMM 2's split partials in split order, then the residual epilogue;
// a thread takes four consecutive outputs.
template <bool MODULE, typename XT>
__global__ void __launch_bounds__(kConsumers)
reduce_bf16_kernel(const float4* __restrict__ partial, const XT* __restrict__ x,
                   const float* __restrict__ bias, const float* __restrict__ scale,
                   XT* __restrict__ out, long long n4, int C, int splits) {
  const long long i = (long long)blockIdx.x * kConsumers + threadIdx.x;
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
  residual_pair<MODULE>(s.x, s.y, 4 * i, c, bias, x, scale, out);
  residual_pair<MODULE>(s.z, s.w, 4 * i + 2, c + 2, bias, x, scale, out);
}

// ---------------------------------------------------------------------------
// Host side.

// The MLP's form and GEMM 2's K split for width C, chosen for one image of
// hw pixels (never for the batch: a split order that moved with B would
// round differently alone and in a batch) on a card with `sms` SMs. The
// split count minimises a model of GEMM 2's time on an H100: each wave of
// blocks (two an SM) takes its K chunks at ~0.6 us each plus ~2 us, and a
// split adds the reduction's launch (~3 us) and the partials' round trip
// (8 bytes an output a split, at ~3 TB/s). At 60x48x384 that keeps one
// split (the partials cost more than the idle SMs), at 30x24x768 it takes
// four.
struct Plan {
  bool fused;
  int splits;  // GEMM 2 K splits
  int span;    // GEMM 2 K chunks a split
};

inline Plan plan(long long hw, int C, int sms) {
  if (C <= kFusedMaxC) return {true, 1, 0};
  const long long tiles = cdiv(hw, kBM) * cdiv(C, kBN), slots = 2LL * sms;
  const int chunks = (int)cdiv(4LL * C, kBK);
  int best = 1;
  double best_us = 1e30;
  for (int s = 1; s <= kMaxSplits && s <= chunks; ++s) {
    const double waves = (double)cdiv(tiles * s, slots);
    const double us = waves * (0.6 * cdiv(chunks, s) + 2.0) +
                      (s > 1 ? 3.0 + 8.0 * hw * C * s / 3.0e6 : 0.0);
    if (us < best_us) best = s, best_us = us;
  }
  const int per = (int)cdiv(chunks, best);
  return {false, (int)cdiv(chunks, per), per};
}

// Floats of workspace after h: u (M x 4C bf16) and the split partials, for
// the two-GEMM form.
inline long long workspace_floats(long long M, int C, const Plan& p) {
  if (p.fused) return 0;
  return M * C * 2 + (p.splits > 1 ? M * C * p.splits : 0);
}

template <int CP, bool MODULE, typename XT>
cudaError_t launch_fused(const bf16* h, const bf16* wpack, const float* b1, const float* b2,
                         const float* scale, const XT* x, XT* out, long long M, int C,
                         const uint16_t* gtab, cudaStream_t stream) {
  auto kernel = mlp_fused_kernel<CP, MODULE, XT>;
  cudaError_t e = launch_prepare<mlp_fused_kernel<CP, MODULE, XT>>(Fused<CP>::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)cdiv(M, kBM), kFusedThreads, Fused<CP>::SMEM, stream>>>(h, wpack, b1, b2,
                                                                             scale, x, out, M, C,
                                                                             gtab);
  return cudaGetLastError();
}

// The tensor map of a row-major (M, K) bf16 matrix in boxes of 64 K x 128
// rows with the 128-byte swizzle, zeros past its edges.
inline cudaError_t make_tmap(CUtensorMap* map, const bf16* A, long long M, int K) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(A), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int EPI, bool MODULE, typename XT>
cudaError_t launch_gemm(const bf16* A, const bf16* Bp, long long M, int N, int K, int splits,
                        int span, const float* bias, const XT* x, const float* scale, void* out,
                        const uint16_t* gtab, cudaStream_t stream) {
  auto kernel = gemm_wgmma_kernel<EPI, MODULE, XT>;
  cudaError_t e = launch_prepare<gemm_wgmma_kernel<EPI, MODULE, XT>>(GemmRing::SMEM);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  e = make_tmap(&map, A, M, K);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)cdiv(N, kBN), (unsigned)cdiv(M, kBM), splits);
  kernel<<<grid, kConsumers, GemmRing::SMEM, stream>>>(map, Bp, M, N, K, span, bias, x, scale,
                                                       out, gtab);
  return cudaGetLastError();
}

// Fills the module mode's GELU table (kGeluTable bf16 at tab) and counts
// into *bad the bf16 values whose lookup is not gelu_bf16's.
inline cudaError_t make_gelu_table(uint16_t* tab, unsigned* bad, cudaStream_t stream) {
  gelu_table_fill_kernel<<<kGeluTable / 256, 256, 0, stream>>>(tab);
  gelu_table_check_kernel<<<65536 / 256, 256, 0, stream>>>(tab, bad);
  return cudaGetLastError();
}

// The block on x (B, H, W, C): the depthwise + LN into h (bf16, the
// workspace's first M C halves), then the MLP in the plan's form, w1 and w2
// packed as it reads them (the fused form's one pack in w1) and the taps
// dw_t tap-major, (49, C); gtab the GELU table (the module mode's; unread
// in the Pallas mode); the workspace holds M C / 2 + workspace_floats(M,
// C, p) floats.
template <bool MODULE, typename XT>
cudaError_t run_block(const XT* x, const float* dw_t, const float* dw_b, const float* ln_g,
                      const float* ln_b, const bf16* w1, const float* b1, const bf16* w2,
                      const float* b2, const float* scale, const uint16_t* gtab,
                      float* workspace, XT* out, int B, int H, int W, int C, int sms,
                      const Plan& p, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  bf16* h = reinterpret_cast<bf16*>(workspace);
  float* ws = workspace + M * C / 2;
  cudaError_t e = run_dw_ln<XT, MODULE>(x, dw_t, dw_b, ln_g, ln_b, h, B, H, W, C, sms, stream);
  if (e != cudaSuccess) return e;
  if (p.fused) {
    switch (fused_width(C)) {
      case 96: return launch_fused<96, MODULE, XT>(h, w1, b1, b2, scale, x, out, M, C, gtab, stream);
      case 128: return launch_fused<128, MODULE, XT>(h, w1, b1, b2, scale, x, out, M, C, gtab, stream);
      default: return launch_fused<192, MODULE, XT>(h, w1, b1, b2, scale, x, out, M, C, gtab, stream);
    }
  }
  bf16* u = reinterpret_cast<bf16*>(ws);
  float* partial = ws + M * C * 2;
  const int chunks = (int)cdiv(4LL * C, kBK);
  e = launch_gemm<kGelu, MODULE, XT>(h, w1, M, 4 * C, C, 1, chunks, b1, nullptr, nullptr, u,
                                     gtab, stream);
  if (e != cudaSuccess) return e;
  if (p.splits == 1)
    return launch_gemm<kResidual, MODULE, XT>(u, w2, M, C, 4 * C, 1, chunks, b2, x, scale, out,
                                              gtab, stream);
  e = launch_gemm<kPartial, MODULE, XT>(u, w2, M, C, 4 * C, p.splits, p.span, nullptr, x, nullptr,
                                        partial, gtab, stream);
  if (e != cudaSuccess) return e;
  const long long n4 = M * C / 4;
  reduce_bf16_kernel<MODULE, XT><<<(unsigned)cdiv(n4, kConsumers), kConsumers, 0, stream>>>(
      reinterpret_cast<const float4*>(partial), x, b2, scale, out, n4, C, p.splits);
  return cudaGetLastError();
}

}  // namespace block_bf16
