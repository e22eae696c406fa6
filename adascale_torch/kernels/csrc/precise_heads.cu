// The four precise FpnHeads (char prob 1, up-left corner offset 2, corner
// angle 4, corner distance 4 channels) over the precise neck output, f32,
// for Hopper (sm_90a): nearest-x2 -> conv3x3 (C -> F_h) -> LN -> exact GELU
// -> Linear (F_h -> M_h) per head, as four phase-collapsed 2x2 convolutions
// at the low resolution, the products as 3xTF32 wgmma (fpn_head.cuh).
//
// Replaces the Pallas TPU kernel adascale/ops/pallas/precise_heads.py::
// _fused_heads_phases (pallas_call at :144, kernel body `_kernel` at :35,
// head packing `_pack_heads` at :186). The TPU kernel packed the four heads'
// 192+193+194+194 = 773 features into 896 lanes and projected them with one
// (896, 128) product; here each block owns one head's features (up to 200,
// so a head's LayerNorm stays inside the block) and its 1..4 output
// channels, and writes the interleaved (B, 2H, 2W, 11) map itself. The
// distance head's softplus runs outside, in f32.
//
// What bounds it: 4 phases x 4 taps x C x 773 x 2 flops per low-resolution
// pixel, 9.50 MFLOP at the flagship's C = 384; at 256x208 that is 506.7
// GFLOP, three TF32 products each: 3.07 ms at the H100 SXM's 495 TFLOP/s
// dense TF32 (700 W). Widths of 192..194 run in 200-wide tiles (3 % idle
// products).

#include "fpn_head.cuh"

namespace {
constexpr int kN = 200;  // head width a block: wgmma widths 104 + 96
}

extern "C" int precise_heads_max_width() { return kN; }

// As fpn_heads_f32, with N = precise_heads_max_width().
extern "C" int precise_heads_f32(const float* x, const float* w, const float* vec,
                                 const float* w2, const float* b2, float* out, const int* F,
                                 const int* M, int heads, int B, int H, int W, int C,
                                 cudaStream_t stream) {
  return fpn_head::launch_heads<kN>(x, w, vec, w2, b2, out, F, M, heads, B, H, W, C, stream);
}
