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

// As fpn_heads_f32 with x and w in bf16 (C % 8 == 0); with one slice, w
// as fpn_head::heads_tma_kernel takes it (packing.pack_sw128's chunks).
extern "C" int fpn_heads_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* vec,
                              const float* w2, const float* b2, float* out, float* ws, int chunk,
                              const int* F, const int* M, int heads, int slices, int B, int H,
                              int W, int C, cudaStream_t stream) {
  return fpn_head::launch_heads_bf16<kN, false>(x, w, vec, w2, b2, out, ws, chunk, F, M, heads,
                                                slices, B, H, W, C, stream);
}
