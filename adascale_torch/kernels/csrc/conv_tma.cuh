// The implicit-GEMM convolution of the bf16 neck level 0 and heads
// (fpn_neck_l0.cu; fpn_heads.cu and precise_heads.cu through fpn_head.cuh)
// and of their single-pass TF32 entries, for Hopper (sm_90a), on a
// warp-specialised main loop fed by TMA:
//
//   acc[m][n] = sum_{t, c} x[b, i + oy_t, j + ox_t, c] * w[t][c][n]
//
// conv_gemm.cuh's sums (its Taps: a 1x1, a 3x3, or one phase of the heads'
// collapsed 2x2), into f32 sums from bf16 operands or, for f32 operands
// (Loop's T = float), from one TF32 product a product: x rounded to TF32
// (to nearest, ties away, conv_gemm::round_tf32) in registers after its
// ldmatrix, w rounded when it was packed (packing.pack_sw128_tf32), so that
// the tensor core, which drops the low 13 bits of an f32 operand, reads the
// rounded values. conv_gemm.cuh keeps the 3xTF32 loop. The wide heads and
// the wide neck steps run this loop on a thread-block cluster, one CTA a
// slice of the features, which share each row's LayerNorm statistics
// through distributed shared memory (fpn_head.cuh, fpn_neck_l0.cu; the
// cluster helpers below).
//
// Design:
//   * A block is persistent: one a multiprocessor, it walks units, each one
//     pixel tile with one weight set (the heads: a (head, phase) pair; the
//     neck: its one matrix), so the loads of the next unit run during this
//     one's epilogue. 384 threads: two consumer warpgroups and a producer
//     warpgroup, one of whose threads issues every copy; setmaxnreg moves
//     registers from the producer (40) to the consumers (232), which hold
//     up to 100 sums a thread through the epilogue.
//   * Pixel tiles are 2-D, kBW = 16 columns by BH rows of one image. For
//     each 128 bytes of K (64 bf16 or 32 f32 channels: Loop's KC) the
//     producer brings one halo box of
//     the tile, (16 + KW - 1) columns by (BH + KH - 1) rows, by one TMA copy
//     of a 4-D tensor map over x (C, W, H, B) at the taps' origin: TMA's
//     zero fill past the map's edges is the convolution's zero padding, and
//     a tile past the batch reads zeros. Every tap of the window reads its
//     shifted rows from that one box, so A crosses into the multiprocessor
//     once a chunk, not once a tap: what bounds these kernels on an H100 is
//     the bytes a multiprocessor takes in (about 28 bytes a cycle each,
//     whether or not a cluster multicast them), not the tensor cores.
//   * A tap's A goes from the box to registers by ldmatrix (the box is in
//     TMA's 128-byte swizzle: the 16-byte piece j of row r sits at j ^ r %
//     8), the products are wgmma with A from registers and B from shared
//     memory. B (NB rows by KC channels for each tap and chunk) comes by one
//     bulk copy a stage through its own ring, packed once per parameter set
//     in the same swizzle (kernels/packing.py::pack_sw128, and
//     pack_sw128_tf32 for f32); a weight set
//     that fits (the neck's 1x1) is brought once and stays (B_RESIDENT).
//     K walks the chunks, and within a chunk the taps.
//   * Both rings run on full and empty mbarriers. The consumers keep one
//     wgmma group in flight (wgmma_wait<1>), A in two register buffers, and
//     release a B stage as soon as its products are done and an A box once
//     its last tap's rows are in registers: one arrival a warp.
//   * Each warpgroup owns 64 pixel rows by N0 + N1 features from nb0: the
//     heads and the neck's 3x3 give each warpgroup 4 rows of a 128-pixel
//     (8 x 16) tile and all features; the neck's 1x1 (SPLIT_N) both the
//     same 64 pixels (4 x 16), half the features each. The epilogues run on
//     the accumulators' registers (a row's features lie in one quad).
//
// A pixel's sums run over its taps and chunks in one order wherever its tile
// falls and whatever B is, so a batch gives each image's bits alone.
//
// With f32 operands a k8 step's A fragment (rows g and g + 8, K t and t + 4
// of thread (g, t)) is what ldmatrix .x4 of b16 pairs gives from four 8 x 4
// f32 matrices, so the same addressing serves both types: each 128-byte row
// is 4 k8 steps of TF32 or 4 k16 steps of bf16, and K keeps its natural
// order in x and in the packed weights.
//
// A wait on a copy that never lands traps instead of hanging the card. x
// needs C % 8 == 0 (bf16) or C % 4 == 0 (f32) and 16-byte alignment (the
// wrappers check it).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "conv_gemm.cuh"

namespace conv_tma {

using conv_gemm::bf16;
using conv_gemm::fence_regs;
using conv_gemm::mbar_wait;

constexpr int kKC = 64;                    // bf16 channels a stage: one 128-byte row
constexpr int kRow = 128;                  // bytes a swizzled row
constexpr int kBW = 16;                    // pixel columns of a tile
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kSmemLimit = 232448;         // dynamic shared memory a block may use

// ---------------------------------------------------------------------------
// Copies, barriers and descriptors (the bf16 block, block_bf16.cuh, uses
// them too).

// Descriptor of a K-major bf16 tile written in the 128-byte swizzle: rows of
// 64 K (128 bytes), the 16-byte pieces of row r XORed with r % 8, the next 8
// rows 1024 bytes on. Adding kK16Sw128 moves it 16 K (32 bytes) on within
// the row, as the swizzle is applied to the final address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)(((saddr & 0x3ffffu) >> 4) | (1u << 16)) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}
constexpr uint64_t kK16Sw128 = 32 >> 4;

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// One TMA copy of the box at (c0, c1) of a 2-D tensor map into shared memory
// at dst, completing on bar; elements past the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// As tma_load_2d for a 4-D map at (c0, c1, c2, c3); coordinates may be
// negative or past the end.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Asks for `bytes` (a multiple of 16) from p (16-byte aligned) to be
// brought into L2, without waiting for them.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// Registers a thread of this warpgroup may hold from here on (all its
// threads run it together).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// cuTensorMapEncodeTiled, found once through the runtime's entry-point
// lookup (the libraries link no libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The tensor map of an NHWC map x (B, H, W, C) of bf16 or f32 as (C, W, H,
// B), in boxes of 128 bytes of channels by box_w columns by box_h rows of
// one image, with the 128-byte swizzle and zeros past its edges.
template <typename T>
inline cudaError_t make_map_nhwc(CUtensorMap* map, const T* x, int B, int H, int W, int C,
                                 int box_w, int box_h) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * e, (cuuint64_t)W * C * e,
                                 (cuuint64_t)H * W * C * e};
  const cuuint32_t box[4] = {(cuuint32_t)(kRow / e), (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map,
                            std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            4, const_cast<T*>(x), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma.mma_async m64nNk16 bf16, A from registers (this warp's 16 rows by
// 16 K as bf16 pairs: rows g and g + 8, K 2 t and 2 t + 8) and B from
// shared memory through a 64-bit descriptor, f32 sums: d (64 x N) += A .
// B^T, or d = A . B^T where scale_d is 0. d's register order is
// conv_gemm.cuh's wgmma_n96's (thread (g, t) of warp w holds d[4 j + e] =
// row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2).

template <int K>
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[K], const uint32_t* a, uint64_t db,
                                             int scale_d) {
  static_assert(K >= 48, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
      "}, {%48,%49,%50,%51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void wgmma_rs_n104(float (&d)[K], const uint32_t* a, uint64_t db,
                                              int scale_d) {
  static_assert(K >= 52, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51"
      "}, {%52,%53,%54,%55}, %56, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// wgmma.mma_async m64nNk8 TF32, A from registers (this warp's 16 rows by 8
// K: rows g and g + 8, K t and t + 4, each an f32 already rounded to TF32)
// and B from shared memory through a 64-bit descriptor, f32 sums; d as
// above.
template <int K>
__device__ __forceinline__ void wgmma_rs_tf32_n96(float (&d)[K], const uint32_t* a, uint64_t db,
                                                  int scale_d) {
  static_assert(K >= 48, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
      "}, {%48,%49,%50,%51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void wgmma_rs_tf32_n104(float (&d)[K], const uint32_t* a, uint64_t db,
                                                   int scale_d) {
  static_assert(K >= 52, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51"
      "}, {%52,%53,%54,%55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void wgmma_rs_tf32_n48(float (&d)[K], const uint32_t* a, uint64_t db,
                                                  int scale_d) {
  static_assert(K >= 24, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23"
      "}, {%24,%25,%26,%27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[K], const uint32_t* a, uint64_t db,
                                             int scale_d) {
  static_assert(K >= 32, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void wgmma_rs_n72(float (&d)[K], const uint32_t* a, uint64_t db,
                                             int scale_d) {
  static_assert(K >= 36, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35"
      "}, {%36,%37,%38,%39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void wgmma_rs_tf32_n64(float (&d)[K], const uint32_t* a, uint64_t db,
                                             int scale_d) {
  static_assert(K >= 32, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void wgmma_rs_tf32_n72(float (&d)[K], const uint32_t* a, uint64_t db,
                                             int scale_d) {
  static_assert(K >= 36, "accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35"
      "}, {%36,%37,%38,%39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x NW) of one warpgroup += A . B for a 32-byte K step of operands of
// type T (16 bf16, or 8 f32 as TF32), for the widths the kernels use (48
// only in TF32; 64 and 72 in the wide heads' narrower slices).
template <int NW, typename T = bf16, int K>
__device__ __forceinline__ void wgmma_rs(float (&d)[K], const uint32_t* a, uint64_t db,
                                         int scale_d) {
  constexpr bool kTF32 = std::is_same<T, float>::value;
  static_assert(NW == 64 || NW == 72 || NW == 96 || NW == 104 || (kTF32 && NW == 48), "wgmma width");
  if constexpr (kTF32) {
    if constexpr (NW == 48) wgmma_rs_tf32_n48(d, a, db, scale_d);
    else if constexpr (NW == 64) wgmma_rs_tf32_n64(d, a, db, scale_d);
    else if constexpr (NW == 72) wgmma_rs_tf32_n72(d, a, db, scale_d);
    else if constexpr (NW == 96) wgmma_rs_tf32_n96(d, a, db, scale_d);
    else wgmma_rs_tf32_n104(d, a, db, scale_d);
  } else {
    if constexpr (NW == 64) wgmma_rs_n64(d, a, db, scale_d);
    else if constexpr (NW == 72) wgmma_rs_n72(d, a, db, scale_d);
    else if constexpr (NW == 96) wgmma_rs_n96(d, a, db, scale_d);
    else wgmma_rs_n104(d, a, db, scale_d);
  }
}

// Four 8x8 b16 matrices from shared memory, lanes 8 i .. 8 i + 7 giving the
// row addresses of matrix i; register i gets this lane's pair of matrix i
// (row lane / 4, columns 2 (lane % 4) and + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Keeps registers that an in-flight wgmma reads alive, and untouched, up to
// this point.
template <int K>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ---------------------------------------------------------------------------
// The loop.

// The units a launch walks: pixel tiles (tiles_w x tiles_h per image, B
// images) by weight sets, the set fastest, so the blocks at work at once
// share their tiles' rows through L2.
struct Geo {
  int B, H, W;
  int tiles_w, tiles_h, tiles;
  int sets;
  int chunks;  // 64-channel chunks of K a tap
};

struct Unit {
  int set, b, h0, w0;
};

template <int BH>
__device__ __forceinline__ Unit unit_of(const Geo& g, int u) {
  const int set = u % g.sets, tile = u / g.sets;
  const int per = g.tiles_h * g.tiles_w;
  const int b = tile / per, rem = tile - b * per;
  const int ty = rem / g.tiles_w;
  return {set, b, ty * BH, (rem - ty * g.tiles_w) * kBW};
}

// A main loop's shape: BH tile rows (a 128-pixel tile at 8, 64 at 4), the
// window (KH x KW taps), NB B rows a tap and chunk, the wgmma widths N0 + N1
// of a warpgroup, SPLIT_N (both warpgroups the same 64 pixels, features
// NB / 2 each), the depths of the A and B rings, whether B stays in
// shared memory (B_CHUNKS taps x chunks of it, in place of the B ring), and
// the operands' type T (bf16; or f32, one TF32 product a product), whose KC
// channels fill a 128-byte row.
template <int BH_, int KH_, int KW_, int NB_, int N0_, int N1_, bool SPLIT_N_, int SA_, int SB_,
          int B_CHUNKS_ = 0, typename T_ = bf16>
struct Loop {
  using T = T_;
  static constexpr int KC = kRow / (int)sizeof(T);
  static constexpr int BH = BH_, KH = KH_, KW = KW_, TAPS = KH * KW;
  static constexpr int NB = NB_, N0 = N0_, N1 = N1_;
  static constexpr bool SPLIT_N = SPLIT_N_;
  static constexpr int SA = SA_, SB = SB_, B_CHUNKS = B_CHUNKS_;
  static constexpr bool B_RESIDENT = B_CHUNKS > 0;
  static constexpr int BOX_W = kBW + KW - 1, BOX_H = BH + KH - 1;
  static constexpr int A_TX = BOX_W * BOX_H * kRow;           // a halo box's bytes
  static constexpr int A_BYTES = (A_TX + 1023) / 1024 * 1024;  // a stage, on the swizzle's period
  static constexpr int B_BYTES = NB * kRow;
  static constexpr int RING = SA * A_BYTES + (B_RESIDENT ? B_CHUNKS : SB) * B_BYTES;
  static constexpr int BARS = 8 * (2 * SA + 2 * SB + 1);
  static constexpr int HEAD = 1024 + RING + (BARS + 15) / 16 * 16;  // alignment slack, rings, bars
  static_assert(SPLIT_N ? (BH == 4 && N0 + N1 == NB / 2) : (BH == 8 && N0 + N1 == NB), "tile");
  static_assert(SA >= 2 && (B_RESIDENT || SB >= 2), "rings");
  // The block's barriers: A's full and empty, B's full and empty, the
  // resident B's.
  __device__ static uint32_t full_a(uint32_t bars, int s) { return bars + 8 * s; }
  __device__ static uint32_t empty_a(uint32_t bars, int s) { return bars + 8 * (SA + s); }
  __device__ static uint32_t full_b(uint32_t bars, int s) { return bars + 8 * (2 * SA + s); }
  __device__ static uint32_t empty_b(uint32_t bars, int s) { return bars + 8 * (2 * SA + SB + s); }
  __device__ static uint32_t resident(uint32_t bars) { return bars + 8 * (2 * SA + 2 * SB); }
  __device__ static uint32_t b_ring(uint32_t ring) { return ring + SA * A_BYTES; }
};

// The block's rings from a 1024-byte boundary of its dynamic shared memory.
__device__ __forceinline__ uint32_t ring_base(unsigned char* smem) {
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (raw + 1023) & ~1023u;
}
// The shared-memory words after a loop's rings and barriers.
template <class L>
__device__ __forceinline__ float* after_ring(unsigned char* smem, uint32_t ring) {
  return reinterpret_cast<float*>(
      smem + (ring - static_cast<uint32_t>(__cvta_generic_to_shared(smem))) + (L::HEAD - 1024));
}
// Thread 0 initialises the barriers; the caller then syncs the block.
template <class L>
__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x != 0) return;
  constexpr int kWarps = kConsumers / 32;  // one arrival a consumer warp
#pragma unroll
  for (int s = 0; s < L::SA; ++s) {
    conv_gemm::mbar_init(L::full_a(bars, s), 1);
    conv_gemm::mbar_init(L::empty_a(bars, s), kWarps);
  }
#pragma unroll
  for (int s = 0; s < L::SB; ++s) {
    conv_gemm::mbar_init(L::full_b(bars, s), 1);
    conv_gemm::mbar_init(L::empty_b(bars, s), kWarps);
  }
  conv_gemm::mbar_init(L::resident(bars), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits, where a ring has gone round, for the consumers to release stage
// it % S; returns the stage.
template <int S>
__device__ __forceinline__ int claim(uint32_t empty0, uint32_t it) {
  const int s = it % S;
  if (it >= (uint32_t)S) mbar_wait(empty0 + 8 * s, (it / S - 1) & 1);
  return s;
}

// What the producer does at the start of each unit, beside its copies: by
// default nothing.
struct NoUnitHook {
  __device__ void operator()(const Unit&) const {}
};

// The producer (one thread): for each unit of this block (units first,
// first + step, ...), in order, on_unit(unit), then each chunk's halo box
// by TMA at the window's origin (oy0, ox0 of the set's Taps) into the A
// ring, and after it each tap's B of the chunk by a bulk copy into the B
// ring (or, once, all of B into the resident area). w holds each set's B,
// set-major, then tap-major, then chunk, B_BYTES each.
template <class L, class TapsOf, class OnUnit = NoUnitHook>
__device__ __forceinline__ void produce(const CUtensorMap* map, const typename L::T* w, const Geo& g,
                                        TapsOf taps_of, uint32_t ring, uint32_t bars, int first,
                                        int step, OnUnit on_unit = OnUnit{}) {
  constexpr int kElems = L::B_BYTES / (int)sizeof(typename L::T);
  const int nk = L::TAPS * g.chunks;
  if constexpr (L::B_RESIDENT) {
    const uint32_t bres = L::b_ring(ring), bar = L::resident(bars);
    mbar_expect(bar, nk * L::B_BYTES);
    for (int k = 0; k < nk; ++k)
      bulk_copy(bres + k * L::B_BYTES, w + (long long)k * kElems, L::B_BYTES, bar);
  }
  uint32_t ia = 0, ib = 0;
  const int units = g.tiles * g.sets;
  for (int un = first; un < units; un += step) {
    const Unit u = unit_of<L::BH>(g, un);
    on_unit(u);
    const conv_gemm::Taps t = taps_of(u.set);
    const typename L::T* wb = w + (long long)u.set * nk * kElems;
    for (int c = 0; c < g.chunks; ++c) {
      const int sa = claim<L::SA>(L::empty_a(bars, 0), ia++);
      mbar_expect(L::full_a(bars, sa), L::A_TX);
      tma_load_4d(ring + sa * L::A_BYTES, map, c * L::KC, u.w0 + t.ox0, u.h0 + t.oy0, u.b,
                  L::full_a(bars, sa));
      if constexpr (!L::B_RESIDENT) {
        for (int tap = 0; tap < L::TAPS; ++tap) {
          const int sb = claim<L::SB>(L::empty_b(bars, 0), ib++);
          mbar_expect(L::full_b(bars, sb), L::B_BYTES);
          bulk_copy(L::b_ring(ring) + sb * L::B_BYTES, wb + (long long)(tap * g.chunks + c) * kElems,
                    L::B_BYTES, L::full_b(bars, sb));
        }
      }
    }
  }
}

// produce() over the units of a persistent grid of single blocks.
template <class L, class TapsOf>
__device__ __forceinline__ void produce(const CUtensorMap* map, const typename L::T* w, const Geo& g,
                                        TapsOf taps_of, uint32_t ring, uint32_t bars) {
  produce<L>(map, w, g, taps_of, ring, bars, blockIdx.x, gridDim.x);
}

// The consumers' place in the rings, across units.
struct Cursor {
  uint32_t a = 0, b = 0;
};

// A consumer warpgroup's sums of one unit into acc0 (features nb0 ..) and
// acc1 (the next N1), for pixel rows hrow .. hrow + 3 of the tile (16
// each); the first product overwrites the accumulators.
template <class L, int K0, int K1>
__device__ __forceinline__ void consume(uint32_t ring, uint32_t bars, int chunks, Cursor& cur,
                                        int hrow, int nb0, float (&acc0)[K0], float (&acc1)[K1]) {
  static_assert(K0 == L::N0 / 2 && (L::N1 == 0 || K1 == L::N1 / 2), "accumulators");
  const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
  const bool lead = lane == 0;
  // This lane's ldmatrix row: pixel (hrow + warp, column 8 (lane / 8 % 2) +
  // lane % 8) of the tile, K group 2 q + lane / 16 of k16 step q.
  const int prow = (hrow + warp) * L::BOX_W + 8 * (lane / 8 % 2) + lane % 8;
  const int kgrp = lane / 16;
  constexpr int kSteps = kRow / 32;  // 32-byte K steps a row: k16 of bf16, k8 of TF32
  constexpr uint64_t kSecond = (uint64_t)(L::N0 * kRow) >> 4;  // the second width's first row
  const int nk = L::TAPS * chunks;
  uint32_t a0[16], a1[16];
  int prev_b = -1;
  // Step k: tap k % TAPS of chunk k / TAPS; A into `a`, which the step two
  // back is done with.
  auto step = [&](int k, uint32_t(&a)[16]) {
    const int tap = k % L::TAPS, c = k / L::TAPS;
    const int sa = cur.a % L::SA;
    if (tap == 0) mbar_wait(L::full_a(bars, sa), (cur.a / L::SA) & 1);
    const int r = prow + (tap / L::KW) * L::BOX_W + tap % L::KW;
    const uint32_t row = ring + sa * L::A_BYTES + r * kRow;
#pragma unroll
    for (int q = 0; q < kSteps; ++q) ldmatrix_x4(a + 4 * q, row + (((2 * q + kgrp) ^ (r & 7)) << 4));
    if constexpr (std::is_same<typename L::T, float>::value) {
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = conv_gemm::round_tf32(__uint_as_float(a[i]));
    }
    if (tap == L::TAPS - 1) {  // the box's rows are in registers
      if (lead) mbar_arrive(L::empty_a(bars, sa));
      ++cur.a;
    }
    uint32_t bbase;
    int sb = -1;
    if constexpr (L::B_RESIDENT) {
      bbase = L::b_ring(ring) + (tap * chunks + c) * L::B_BYTES;
    } else {
      sb = cur.b % L::SB;
      mbar_wait(L::full_b(bars, sb), (cur.b / L::SB) & 1);
      bbase = L::b_ring(ring) + sb * L::B_BYTES;
      ++cur.b;
    }
    const uint64_t db = desc_sw128(bbase + nb0 * kRow);
    // The operands are settled before the batch and untouched until it
    // ends (else ptxas serialises the wgmmas).
    keep_regs(a);
    fence_regs(acc0);
    fence_regs(acc1);
    conv_gemm::wgmma_fence();
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int scale = k > 0 || q > 0;
      wgmma_rs<L::N0, typename L::T>(acc0, a + 4 * q, db + q * kK16Sw128, scale);
      if constexpr (L::N1 > 0)
        wgmma_rs<L::N1, typename L::T>(acc1, a + 4 * q, db + kSecond + q * kK16Sw128, scale);
    }
    conv_gemm::wgmma_commit();
    keep_regs(a);
    fence_regs(acc0);
    fence_regs(acc1);
    conv_gemm::wgmma_wait<1>();  // the previous step's products are done
    fence_regs(acc0);
    fence_regs(acc1);
    if constexpr (!L::B_RESIDENT) {
      if (prev_b >= 0 && lead) mbar_arrive(L::empty_b(bars, prev_b));
      prev_b = sb;
    }
  };
  for (int k = 0; k < nk; k += 2) {
    step(k, a0);
    if (k + 1 < nk) step(k + 1, a1);
  }
  conv_gemm::wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
  keep_regs(a0);
  keep_regs(a1);
  if constexpr (!L::B_RESIDENT)
    if (lead) mbar_arrive(L::empty_b(bars, prev_b));
}

// Blocks to launch for `units` units: as many as fit on the card at once
// (found once a device), no more than the units.
template <auto kernel>
cudaError_t persistent_grid(int smem, long long units, int* grid) {
  static int fit[32];  // blocks at once, a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int blocks = dev < 32 ? __atomic_load_n(&fit[dev], __ATOMIC_ACQUIRE) : 0;
  if (blocks == 0) {
    int per = 0, sms = 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    blocks = per * sms;
    if (blocks <= 0) return cudaErrorInvalidConfiguration;
    if (dev < 32) __atomic_store_n(&fit[dev], blocks, __ATOMIC_RELEASE);
  }
  *grid = (int)(units < blocks ? units : blocks);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Thread-block clusters: CTAs of one cluster, on neighbouring
// multiprocessors, read and write each other's shared memory (shared::cluster
// addresses from mapa) and arrive on each other's mbarriers.

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
// This CTA's cluster, and the clusters of the grid (1-D clusters along x).
__device__ __forceinline__ int cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return (int)r;
}
// Every thread of every CTA of the cluster: the writes before it (to any
// CTA's shared memory) are seen by the reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// The shared::cluster address of this CTA's shared address saddr in the CTA
// of the cluster with the given rank.
__device__ __forceinline__ uint32_t peer_addr(uint32_t saddr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(saddr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_peer(uint32_t caddr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(caddr) : "memory");
  return v;
}
__device__ __forceinline__ float2 ld_peer2(uint32_t caddr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(caddr) : "memory");
  return v;
}
// Stores v at caddr (a peer's shared memory) and completes its bytes on the
// peer's mbarrier at cbar (both shared::cluster addresses of one CTA).
__device__ __forceinline__ void st_peer(uint32_t caddr, float2 v, uint32_t cbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(caddr),
               "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(cbar)
               : "memory");
}
__device__ __forceinline__ void st_peer(uint32_t caddr, float4 v, uint32_t cbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   caddr),
               "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
               "r"(__float_as_uint(v.w)), "r"(cbar)
               : "memory");
}
// The largest cluster the kernels launch (the portable limit).
constexpr int kMaxCluster = 8;

// mbar_wait for a phase that peers' st_peer completes: acquires at cluster
// scope, so that their stores are seen; traps instead of hanging.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1 << 24)) __trap();
  }
}

// A row's LayerNorm statistics from each slice's (sum, sum of squared
// deviations from the slice's own mean) over its real features, slice k
// holding n_k = clamp(F - k N, 0, N) of them (stat(k)): the mean over F and
// 1 / sqrt(var + eps), the slices combined in rank order (the pairwise
// update of Chan, Golub and LeVeque), so that every CTA computes the same
// bits from the same partials.
template <class Stat>
__device__ __forceinline__ float2 combine_stats(Stat stat, int slices, int F, int N) {
  float s = 0.0f;
  for (int k = 0; k < slices; ++k) s += stat(k).x;
  const float mean = s / F;
  float m2 = 0.0f;
  for (int k = 0; k < slices; ++k) {
    const float2 v = stat(k);
    const int n = min(max(F - k * N, 0), N);
    const float d = n > 0 ? v.x / n - mean : 0.0f;
    m2 += v.y + n * d * d;
  }
  return make_float2(mean, rsqrtf(m2 / F + conv_gemm::kEps));
}

// The LayerNorm statistics' exchange of a persistent cluster kernel whose
// CTAs each hold one slice of a unit's features, ROWS pixel rows a unit and
// at most MAXS slices (fpn_neck_l0.cu's wide steps; the protocol of
// fpn_head.cuh::heads_cluster_tma_kernel). The producer runs a unit ahead,
// so no cluster barrier: a thread stores its rows' (sum, squared
// deviations) into every peer's shared memory by st.async, which completes
// the bytes on the peer's mbarrier of the unit's buffer, and waits on its
// own. The buffers alternate by unit parity, a peer's value in slot (peer -
// rank - 1) mod slices. A peer stores unit i + 2's into the buffer of unit
// i only after it has received this CTA's statistics of unit i + 1 from
// every row, which a CTA sends only after each of its threads is done with
// unit i's (a warp's shuffles, or a named barrier, lie between). The
// layout at `at`: two buffers of (MAXS - 1) x ROWS float2, then their two
// mbarriers; BYTES in all.
template <int ROWS, int MAXS>
struct StatExchange {
  static constexpr int SLOTS = (MAXS - 1) * ROWS;  // float2 a buffer
  static constexpr int BYTES = 2 * SLOTS * 8 + 16;
  const float2* xs;
  uint32_t xaddr;
  int rank, slices;
  __device__ explicit StatExchange(void* at)
      : xs(static_cast<const float2*>(at)),
        xaddr(static_cast<uint32_t>(__cvta_generic_to_shared(at))),
        rank(cluster_rank()),
        slices(cluster_size()) {}
  __device__ uint32_t bar(uint32_t it) const { return xaddr + 2 * SLOTS * 8 + 8 * (it & 1); }
  __device__ int slot(int from, int to) const { return (from - to - 1 + slices) % slices; }
  // Thread 0, before init_bars (whose fence covers them).
  __device__ void init() const {
    conv_gemm::mbar_init(bar(0), 1);
    conv_gemm::mbar_init(bar(1), 1);
  }
  // One thread a unit: the peers' bytes of unit `it`.
  __device__ void expect(uint32_t it) const { mbar_expect(bar(it), (uint32_t)(slices - 1) * ROWS * 8); }
  // Row `row`'s statistics of unit `it` to the j-th peer after this CTA.
  __device__ void send(uint32_t it, int j, int row, float2 st) const {
    const int peer = (rank + 1 + j) % slices;
    const uint32_t dst = xaddr + 8 * (((it & 1) * (MAXS - 1) + slot(rank, peer)) * ROWS + row);
    st_peer(peer_addr(dst, peer), st, peer_addr(bar(it), peer));
  }
  __device__ void wait(uint32_t it) const { mbar_wait_cluster(bar(it), it >> 1 & 1); }
  // The row's (mean, rstd) over F features in slices of N: this CTA's
  // statistics and the peers' of unit `it` (after wait), in rank order.
  __device__ float2 combine(uint32_t it, int row, float2 mine, int F, int N) const {
    const float2* peers = xs + (it & 1) * SLOTS + row;
    return combine_stats([&](int k) { return k == rank ? mine : peers[slot(k, rank) * ROWS]; }, slices, F, N);
  }
};

// The launch of a kernel on clusters of `slices` CTAs along x.
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterLaunch(dim3 grid, int threads, size_t smem, int slices, cudaStream_t stream) : attr{}, cfg{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = slices;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// Clusters of `size` CTAs to launch for `units` units of a persistent
// kernel: as many as fit on the card at once (found once a device and
// size), no more than the units. cfg holds the launch's block, shared
// memory and cluster dimension.
template <auto kernel>
cudaError_t persistent_clusters(cudaLaunchConfig_t cfg, int size, long long units, int* clusters) {
  static int fit[32][kMaxCluster + 1];  // clusters at once, a device and size
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (size <= 0 || size > kMaxCluster) return cudaErrorInvalidValue;
  int n = dev < 32 ? __atomic_load_n(&fit[dev][size], __ATOMIC_ACQUIRE) : 0;
  if (n == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg.dynamicSmemBytes);
    if (e != cudaSuccess) return e;
    cfg.gridDim = dim3(size);
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (n <= 0) return cudaErrorInvalidConfiguration;
    if (dev < 32) __atomic_store_n(&fit[dev][size], n, __ATOMIC_RELEASE);
  }
  *clusters = (int)(units < n ? units : n);
  return cudaSuccess;
}

// The geometry of x (B, H, W, C) in tiles of BH rows with `sets` weight
// sets, K in chunks of kc channels (128 bytes of the operand type).
inline Geo make_geo(int B, int H, int W, int C, int BH, int sets, int kc) {
  Geo g;
  g.B = B;
  g.H = H;
  g.W = W;
  g.tiles_w = (W + kBW - 1) / kBW;
  g.tiles_h = (H + BH - 1) / BH;
  g.tiles = B * g.tiles_h * g.tiles_w;
  g.sets = sets;
  g.chunks = (C + kc - 1) / kc;
  return g;
}

// The tensor map of x for loop L: boxes of L's halo.
template <class L>
cudaError_t make_map(CUtensorMap* map, const typename L::T* x, int B, int H, int W, int C) {
  return make_map_nhwc(map, x, B, H, W, C, L::BOX_W, L::BOX_H);
}

}  // namespace conv_tma
