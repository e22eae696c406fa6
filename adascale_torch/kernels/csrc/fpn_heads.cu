// Both rough FpnHeads (char mask and char height) over the rough neck
// output, for Hopper (sm_90a): nearest-x2 -> conv3x3 (C -> F) -> LN -> exact
// GELU -> Linear (F -> 1) per head, as four phase-collapsed 2x2
// convolutions at the low resolution, the products as 3xTF32 wgmma (f32)
// or bf16 wgmma (compute_dtype="bfloat16") (fpn_head.cuh).
//
// Replaces the Pallas TPU kernel adascale/ops/pallas/fpn_heads.py::
// fused_rough_heads (pallas_call at :200, kernel body `_kernel` at :70, tap
// packing `_phase_tap_weights` at :58). The TPU kernel packed both heads
// into one 384-wide operand to fill its 128-wide matrix unit and wrote four
// phase maps that XLA interleaved; here each block owns one head's 192
// features (its LayerNorm stays inside the block) and the kernel writes the
// interleaved map itself. Wider heads (base 256, large 384) run as slices
// of one thread-block cluster a pixel tile (fpn_head.cuh, below). The
// height head's softplus runs outside, in f32.
//
// What bounds it: 4 phases x 4 taps x C x 2F x 2 flops per low-resolution
// pixel, 4.72 MFLOP at the flagship's C = 384, F = 192; at 240x192 that is
// 217.6 GFLOP. In f32 three TF32 products each: 1.32 ms at the H100 SXM's
// 495 TFLOP/s dense TF32 (700 W); in bf16 one product each: 0.22 ms at 989
// TFLOP/s dense bf16; against well under 0.1 ms for its bytes. The bf16
// body is fpn_head.cuh's heads_tma_kernel on conv_tma.cuh's loop.
//
// The single-pass TF32 entry (matmul_precision "default" / "high"; one TF32
// product a product: 0.44 ms at 495 TFLOP/s) runs the same persistent,
// TMA-fed heads_tma_kernel on f32 operands where the heads fit the tile, as
// the precise heads' TF32 entry does (precise_heads.cu): halo boxes of x,
// 32 channels a 128-byte row, by TMA in the 128-byte swizzle; A from the
// box by ldmatrix and rounded to TF32 in registers; B, the collapsed taps
// rounded to TF32 once per parameter set and packed in the same swizzle
// (packing.pack_sw128_tf32), through its own ring; RS wgmma.m64n96k8 twice
// (N = 96 + 96); the LayerNorm, GELU and projection on the accumulators'
// registers. It replaced conv_gemm.cuh's cp.async loop at one pass (A
// copied once a tap and rounded on each use, each 32-deep chunk a fresh
// tile, the epilogue read back through shared memory): 1.43-1.52 ms on an
// H100 (PERF.md). What bounds it now is the bytes a multiprocessor takes
// in: at 240x192 the 2880 units (360 tiles x 8 (head, phase)) take in 4.1
// GB, B 1.18 MB and A 0.24 MB a unit, ~0.62 ms at ~28 bytes a cycle an SM,
// above the products' 0.44 ms.
//
// Wider heads (F > 192: the base backbone's 256, the large one's 384) run
// in one launch as the cluster forms of the same kernels
// (heads_cluster_tma_kernel for bf16 and TF32, heads_cluster_kernel for
// 3xTF32): the 2 slices of a (head, phase, tile), 128 features each at
// base (no padding; wgmma widths 64 + 64) and 192 at large, are the 2 CTAs
// of one cluster, whose LayerNorm sums and projection cross the cluster
// through distributed shared memory. Each CTA takes in the tile's halo box
// and its slice's B: at base on page_0's 240x192 level 0, 3.9 GB in bf16
// and 7.8 GB in TF32 against products of 0.39 and 0.78 ms; at large 8.2 and
// 16.3 GB against 0.88 and 1.76 ms, so the bytes bound it (PERF.md's row 2w
// has the times). The cluster replaced a two-pass split (pre-LN sums of every
// slice through an f32 workspace, then a second kernel for the LayerNorm)
// on conv_gemm.cuh's cp.async loop.

#include "fpn_head.cuh"

namespace {
constexpr int kN = 192;   // head width a block: wgmma widths 96 + 96
constexpr int kNS = 128;  // the narrower slice of wider heads: wgmma widths 64 + 64
}

// The fused tile's width, the widest head (kMaxSlices tiles), and the width
// of each slice for heads whose widest has F = fmax: the tile where it
// holds them; else ceil(fmax / tile) slices of 128 where they hold them
// (the base backbone's), or of the tile (fpn_head::slice_width).
extern "C" int fpn_heads_tile_width() { return kN; }
extern "C" int fpn_heads_max_width() { return fpn_head::kMaxSlices * kN; }
extern "C" int fpn_heads_slice_width(int fmax) { return fpn_head::slice_width(fmax, kNS, kN); }

// x (B, H, W, C) and out (B, 2H, 2W, sum M) f32 contiguous; the packed
// weights for `slices` slices of fpn_heads_slice_width(max F) features, as
// fpn_head::heads_kernel takes them per slice (slice-major); F and M the
// heads' sizes. One launch: with one slice fpn_head::heads_kernel, with
// more its cluster form, heads_cluster_kernel. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int fpn_heads_f32(const float* x, const float* w, const float* vec, const float* w2,
                             const float* b2, float* out, const int* F, const int* M, int heads,
                             int slices, int B, int H, int W, int C, cudaStream_t stream) {
  return fpn_head::launch_entry<float, kN, kNS, false, 3>(x, w, vec, w2, b2, out, F, M, heads, slices,
                                                          B, H, W, C, stream);
}

// As fpn_heads_f32, the products as one TF32 product a product
// (matmul_precision "default" / "high"): fpn_head.cuh's heads_tma_kernel
// on f32 operands (x rounded to TF32 in registers), or with more than one
// slice its cluster form, heads_cluster_tma_kernel; w as it takes them
// (packing.pack_sw128_tf32, per slice: (heads, 4 phases, 4 taps,
// ceil(C/32) chunks, N/8, 8 rows, 128 bytes of K in the 128-byte swizzle),
// rounded to TF32).
extern "C" int fpn_heads_tf32(const float* x, const float* w, const float* vec, const float* w2,
                              const float* b2, float* out, const int* F, const int* M, int heads,
                              int slices, int B, int H, int W, int C, cudaStream_t stream) {
  return fpn_head::launch_entry<float, kN, kNS, false, 1>(x, w, vec, w2, b2, out, F, M, heads, slices,
                                                          B, H, W, C, stream);
}

// As fpn_heads_f32 with x and w in bf16 (C % 8 == 0), w as
// fpn_head::heads_tma_kernel takes it (packing.pack_sw128's chunks, per
// slice).
extern "C" int fpn_heads_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* vec,
                              const float* w2, const float* b2, float* out, const int* F, const int* M,
                              int heads, int slices, int B, int H, int W, int C, cudaStream_t stream) {
  return fpn_head::launch_entry<__nv_bfloat16, kN, kNS, false, 1>(x, w, vec, w2, b2, out, F, M, heads,
                                                                slices, B, H, W, C, stream);
}
