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
// interleaved map itself. Wider heads (base 256, large 384) go through the
// two-pass split of fpn_head.cuh. The height head's softplus runs outside,
// in f32.
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
// above the products' 0.44 ms. Wider heads keep the cp.async loop
// (launch_heads, two passes).

#include "fpn_head.cuh"

namespace {
constexpr int kN = 192;  // head width a block: wgmma widths 96 + 96
}

// The fused tile's width, and the widest head (kMaxSlices tiles).
extern "C" int fpn_heads_tile_width() { return kN; }
extern "C" int fpn_heads_max_width() { return fpn_head::kMaxSlices * kN; }

// x (B, H, W, C) and out (B, 2H, 2W, sum M) f32 contiguous; the packed
// weights as fpn_head::heads_kernel takes them with N = fpn_heads_tile_width(),
// per slice; where slices > 1, ws is scratch of heads x 4 x chunk x slices N
// floats, the two passes taking `chunk` pixels (a multiple of 128) at a
// time (else ws may be null and chunk is unused). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int fpn_heads_f32(const float* x, const float* w, const float* vec, const float* w2,
                             const float* b2, float* out, float* ws, int chunk, const int* F,
                             const int* M, int heads, int slices, int B, int H, int W, int C,
                             cudaStream_t stream) {
  return fpn_head::launch_heads<float, kN, false>(x, w, vec, w2, b2, out, ws, chunk, F, M, heads,
                                                  slices, B, H, W, C, stream);
}

// As fpn_heads_f32, the products as one TF32 product a product
// (matmul_precision "default" / "high"): x rounded to TF32 in registers.
// One slice: fpn_head.cuh's heads_tma_kernel on f32 operands, w as it
// takes them (packing.pack_sw128_tf32: (heads, 4 phases, 4 taps, ceil(C/32)
// chunks, N/8, 8 rows, 128 bytes of K in the 128-byte swizzle), rounded to
// TF32); wider heads: launch_heads at one pass, w as fpn_heads_f32's (only
// the hi part read).
extern "C" int fpn_heads_tf32(const float* x, const float* w, const float* vec, const float* w2,
                              const float* b2, float* out, float* ws, int chunk, const int* F,
                              const int* M, int heads, int slices, int B, int H, int W, int C,
                              cudaStream_t stream) {
  if (slices != 1)
    return fpn_head::launch_heads<float, kN, false, 1>(x, w, vec, w2, b2, out, ws, chunk, F, M,
                                                       heads, slices, B, H, W, C, stream);
  return fpn_head::launch_heads_tma<float, kN, false>(x, w, vec, w2, b2, out, F, M, heads, B, H, W,
                                                      C, stream);
}

// As fpn_heads_f32 with x and w in bf16 (C % 8 == 0); with one slice, w
// as fpn_head::heads_tma_kernel takes it (packing.pack_sw128's chunks).
extern "C" int fpn_heads_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* vec,
                              const float* w2, const float* b2, float* out, float* ws, int chunk,
                              const int* F, const int* M, int heads, int slices, int B, int H,
                              int W, int C, cudaStream_t stream) {
  return fpn_head::launch_heads_bf16<kN, false>(x, w, vec, w2, b2, out, ws, chunk, F, M, heads,
                                                slices, B, H, W, C, stream);
}
