// The four precise FpnHeads (char prob 1, up-left corner offset 2, corner
// angle 4, corner distance 4 channels) over the precise neck output, for
// Hopper (sm_90a): nearest-x2 -> conv3x3 (C -> F_h) -> LN -> exact GELU ->
// Linear (F_h -> M_h) per head, as four phase-collapsed 2x2 convolutions at
// the low resolution, the products as 3xTF32 wgmma (f32) or bf16 wgmma
// (compute_dtype="bfloat16") (fpn_head.cuh).
//
// Replaces the Pallas TPU kernel adascale/ops/pallas/precise_heads.py::
// _fused_heads_phases (pallas_call at :144, kernel body `_kernel` at :35,
// head packing `_pack_heads` at :186). The TPU kernel packed the four heads'
// 192+193+194+194 = 773 features into 896 lanes and projected them with one
// (896, 128) product; here each block owns one head's features (up to 200,
// so a head's LayerNorm stays inside the block) and its 1..4 output
// channels, and writes the interleaved (B, 2H, 2W, 11) map itself; wider
// heads (base 256-258, large 384-386) run as slices of one thread-block
// cluster a pixel tile (fpn_head.cuh, below). In bf16 the GELU output and
// the projection are rounded to
// bf16 before the projection, as the Pallas kernel's compute-dtype
// projection does. The distance head's softplus runs outside, in f32.
//
// What bounds it: 4 phases x 4 taps x C x 773 x 2 flops per low-resolution
// pixel, 9.50 MFLOP at the flagship's C = 384; at 256x208 that is 506.7
// GFLOP. In f32 three TF32 products each: 3.07 ms at the H100 SXM's 495
// TFLOP/s dense TF32 (700 W); in bf16 one each: 0.51 ms at 989 TFLOP/s.
// Widths of 192..194 run in 200-wide tiles (3 % idle products). The bf16
// body is fpn_head.cuh's heads_tma_kernel on conv_tma.cuh's loop.
//
// The single-pass TF32 entry (matmul_precision "default" / "high"; one TF32
// product a product: 1.02 ms at 495 TFLOP/s) runs the same persistent,
// TMA-fed heads_tma_kernel on f32 operands where the heads fit the tile:
// halo boxes of x, 32 channels a 128-byte row, by TMA in the 128-byte
// swizzle; A from the box by ldmatrix (.x4 of b16 pairs gives a k8 TF32 A
// fragment) and rounded to TF32 in registers; B, the collapsed taps rounded
// to TF32 once per parameter set and packed in the same swizzle
// (packing.pack_sw128_tf32), through its own ring; RS wgmma.m64nNk8 with
// N = 104 + 96; the LayerNorm, GELU and projection on the accumulators'
// registers. It replaced conv_gemm.cuh's cp.async loop at one pass (A
// copied once a tap and rounded on each use, each 32-deep chunk a fresh
// tile, the epilogue read back through shared memory): 3.501 ms on an H100
// (PERF.md). What bounds it now is the bytes a multiprocessor takes in
// (fpn_head.cuh): B for each unit of 128 pixels, ~1.5 ms.
//
// Wider heads (F > 200: the base backbone's 256-258, the large one's
// 384-386) run in one launch as the cluster forms of the same kernels
// (heads_cluster_tma_kernel for bf16 and TF32, heads_cluster_kernel for
// 3xTF32): the 2 slices of a (head, phase, tile), 136 features each at
// base (272 for F <= 258; wgmma widths 72 + 64) and 200 at large, are the 2
// CTAs of one cluster, whose LayerNorm sums and projection cross the
// cluster through distributed shared memory. Each CTA takes in the tile's
// halo box and its slice's B: at base on a 256x208 precise level 0, 9.5 GB
// in bf16 and 19.0 GB in TF32 against products of 0.91 and 1.81 ms; at
// large 19.5 and 39.0 GB against 2.04 and 4.07 ms, so the bytes bound it
// (PERF.md's row 4w has the times). The cluster replaced a two-pass split (pre-LN sums of
// every slice through an f32 workspace, then a second kernel for the
// LayerNorm) on conv_gemm.cuh's cp.async loop.

#include "fpn_head.cuh"

namespace {
constexpr int kN = 200;   // head width a block: wgmma widths 104 + 96
constexpr int kNS = 136;  // the narrower slice of wider heads: wgmma widths 72 + 64
}

// The fused tile's width, the widest head (kMaxSlices tiles), and the width
// of each slice for heads whose widest has F = fmax: the tile where it
// holds them; else ceil(fmax / tile) slices of 136 where they hold them
// (the base backbone's), or of the tile (fpn_head::slice_width).
extern "C" int precise_heads_tile_width() { return kN; }
extern "C" int precise_heads_max_width() { return fpn_head::kMaxSlices * kN; }
extern "C" int precise_heads_slice_width(int fmax) { return fpn_head::slice_width(fmax, kNS, kN); }

// x (B, H, W, C) and out (B, 2H, 2W, sum M) f32 contiguous; the packed
// weights for `slices` slices of precise_heads_slice_width(max F) features, as
// fpn_head::heads_kernel takes them per slice (slice-major); F and M the
// heads' sizes. One launch: with one slice fpn_head::heads_kernel, with
// more its cluster form, heads_cluster_kernel. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int precise_heads_f32(const float* x, const float* w, const float* vec, const float* w2,
                                 const float* b2, float* out, const int* F, const int* M, int heads,
                                 int slices, int B, int H, int W, int C, cudaStream_t stream) {
  return fpn_head::launch_entry<float, kN, kNS, false, 3>(x, w, vec, w2, b2, out, F, M, heads, slices,
                                                          B, H, W, C, stream);
}

// As precise_heads_f32, the products as one TF32 product a product
// (matmul_precision "default" / "high"): fpn_head.cuh's heads_tma_kernel
// on f32 operands (x rounded to TF32 in registers), or with more than one
// slice its cluster form, heads_cluster_tma_kernel; w as it takes them
// (packing.pack_sw128_tf32, per slice: (heads, 4 phases, 4 taps,
// ceil(C/32) chunks, N/8, 8 rows, 128 bytes of K in the 128-byte swizzle),
// rounded to TF32).
extern "C" int precise_heads_tf32(const float* x, const float* w, const float* vec, const float* w2,
                                  const float* b2, float* out, const int* F, const int* M, int heads,
                                  int slices, int B, int H, int W, int C, cudaStream_t stream) {
  return fpn_head::launch_entry<float, kN, kNS, false, 1>(x, w, vec, w2, b2, out, F, M, heads, slices,
                                                          B, H, W, C, stream);
}

// As precise_heads_f32 with x and w in bf16 (C % 8 == 0), w as
// fpn_head::heads_tma_kernel takes it (packing.pack_sw128's chunks, per
// slice), the GELU output rounded to bf16 before the projection (w2 holds
// bf16 values).
extern "C" int precise_heads_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* vec,
                                  const float* w2, const float* b2, float* out, const int* F, const int* M,
                                  int heads, int slices, int B, int H, int W, int C, cudaStream_t stream) {
  return fpn_head::launch_entry<__nv_bfloat16, kN, kNS, true, 1>(x, w, vec, w2, b2, out, F, M, heads,
                                                                 slices, B, H, W, C, stream);
}
