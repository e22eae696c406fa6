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
// heads (base 256-258, large 384-386) go through the two-pass split of
// fpn_head.cuh. In bf16 the GELU output and the projection are rounded to
// bf16 before the projection, as the Pallas kernel's compute-dtype
// projection does. The distance head's softplus runs outside, in f32.
//
// What bounds it: 4 phases x 4 taps x C x 773 x 2 flops per low-resolution
// pixel, 9.50 MFLOP at the flagship's C = 384; at 256x208 that is 506.7
// GFLOP. In f32 three TF32 products each: 3.07 ms at the H100 SXM's 495
// TFLOP/s dense TF32 (700 W); in bf16 one each: 0.51 ms at 989 TFLOP/s.
// Widths of 192..194 run in 200-wide tiles (3 % idle products). The bf16
// body is fpn_head.cuh's heads_tma_kernel on conv_tma.cuh's loop.

#include "fpn_head.cuh"

namespace {
constexpr int kN = 200;  // head width a block: wgmma widths 104 + 96
}

extern "C" int precise_heads_tile_width() { return kN; }
extern "C" int precise_heads_max_width() { return fpn_head::kMaxSlices * kN; }

// As fpn_heads_f32, with N = precise_heads_tile_width().
extern "C" int precise_heads_f32(const float* x, const float* w, const float* vec,
                                 const float* w2, const float* b2, float* out, float* ws,
                                 int chunk, const int* F, const int* M, int heads, int slices,
                                 int B, int H, int W, int C, cudaStream_t stream) {
  return fpn_head::launch_heads<float, kN, false>(x, w, vec, w2, b2, out, ws, chunk, F, M, heads,
                                                  slices, B, H, W, C, stream);
}

// As precise_heads_f32 with x and w in bf16 (C % 8 == 0; with one slice, w
// as fpn_head::heads_tma_kernel takes it), the GELU output rounded to bf16
// before the projection (w2 holds bf16 values).
extern "C" int precise_heads_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                  const float* vec, const float* w2, const float* b2, float* out,
                                  float* ws, int chunk, const int* F, const int* M, int heads,
                                  int slices, int B, int H, int W, int C, cudaStream_t stream) {
  return fpn_head::launch_heads_bf16<kN, true>(x, w, vec, w2, b2, out, ws, chunk, F, M, heads,
                                                slices, B, H, W, C, stream);
}
