// Both rough FpnHeads (char mask and char height) over the rough neck
// output, f32, for Hopper (sm_90a): nearest-x2 -> conv3x3 (C -> F) -> LN ->
// exact GELU -> Linear (F -> 1) per head, as four phase-collapsed 2x2
// convolutions at the low resolution, the products as 3xTF32 wgmma
// (fpn_head.cuh).
//
// Replaces the Pallas TPU kernel adascale/ops/pallas/fpn_heads.py::
// fused_rough_heads (pallas_call at :200, kernel body `_kernel` at :70, tap
// packing `_phase_tap_weights` at :58). The TPU kernel packed both heads
// into one 384-wide operand to fill its 128-wide matrix unit and wrote four
// phase maps that XLA interleaved; here each block owns one head's 192
// features (its LayerNorm stays inside the block) and the kernel writes the
// interleaved map itself. The height head's softplus runs outside, in f32.
//
// What bounds it: 4 phases x 4 taps x C x 2F x 2 flops per low-resolution
// pixel, 4.72 MFLOP at the flagship's C = 384, F = 192; at 240x192 that is
// 217.6 GFLOP, three TF32 products each: 1.32 ms at the H100 SXM's 495
// TFLOP/s dense TF32 (700 W), against well under 0.1 ms for its bytes.

#include "fpn_head.cuh"

namespace {
constexpr int kN = 192;  // head width a block: wgmma widths 96 + 96
}

extern "C" int fpn_heads_max_width() { return kN; }

// x (B, H, W, C) and out (B, 2H, 2W, sum M) f32 contiguous; the packed
// weights as fpn_head::heads_kernel takes them with N = fpn_heads_max_width().
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fpn_heads_f32(const float* x, const float* w, const float* vec, const float* w2,
                             const float* b2, float* out, const int* F, const int* M, int heads,
                             int B, int H, int W, int C, cudaStream_t stream) {
  return fpn_head::launch_heads<kN>(x, w, vec, w2, b2, out, F, M, heads, B, H, W, C, stream);
}
