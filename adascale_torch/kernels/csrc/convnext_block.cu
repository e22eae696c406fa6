// One ConvNeXt residual block in f32 for Hopper (sm_90a), NHWC:
//
//   out = x + scale * (W2 · GELU(W1 · LN(dwconv7x7(x) + dw_b) + b1) + b2)
//
// Replaces the Pallas TPU kernel adascale/ops/pallas/convnext_block.py::
// fused_convnext_block (pallas_call at :290, kernel body `_kernel` at :68).
// Same arithmetic: zero-padded depthwise 7x7 with bias, LayerNorm in f32
// (eps 1e-6, biased variance), Linear C->4C, exact erf GELU, Linear 4C->C,
// layer scale, residual add. No channel padding and no erf stand-in: those
// were TPU constraints.
//
// What bounds it: without tensor cores the block is bound by f32 operations.
// Per pixel it does 2*49*C (depthwise) + 16*C^2 (the two projections) flops
// and moves 8*C bytes (x in, out written). For the first rough-pass stage
// of a 960x768 padded page (240x192 pixels, C=96) that is ~7.2 GFLOP, about
// 108 us at the H100 SXM's 67 TFLOP/s f32 peak (700 W), against ~36 MB,
// about 11 us at 3.35 TB/s.
//
// Design (simple first, two or three launches):
//   1. dw_ln_kernel: a block covers 8 pixels of one row and all C channels.
//      The 49-tap sums go to shared memory; then warp p reduces pixel p's
//      mean and variance over C with shuffles and writes h = LN(...).
//   2. mlp_kernel: warp w owns PI pixels; the block stages their h rows in
//      shared memory. It walks the 4C hidden units in chunks of 32 (one per
//      lane): u = GELU(h · W1[:, chunk] + b1) goes to shared memory, then
//      y += u · W2[chunk, :] accumulates in registers (lane owns channels
//      lane + 32 j). The 4C hidden never reaches device memory. The epilogue
//      adds b2, multiplies by the layer scale and adds the residual.
//   Each warp reads only the pixels it owns, so the chunk loop needs warp
//   barriers only.
//   3. When the pixel tiles alone would not fill two waves of the card's SMs
//      (the small late stages: 720 pixels at C=768 give 90 tiles), the hidden
//      units are split across up to 8 blocks per tile. Each writes its C-wide
//      partial projection (never the 4C hidden) to the workspace and
//      reduce_kernel adds the partials in split order and does the epilogue,
//      so the result does not depend on scheduling.
//
// The caller passes W1 as (C, 4C) and W2 as (4C, C) row-major, and the
// depthwise weights as (49, C), so that every weight load is coalesced over
// lanes. C may be any value up to 768; pixels and channels are masked.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDwPix = kWarps;  // one warp normalises one pixel
constexpr int kHalo = 3;
constexpr int kChunk = 32;      // hidden units per chunk, one per lane
constexpr int kMaxC = 768;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__global__ void __launch_bounds__(kThreads)
dw_ln_kernel(const float* __restrict__ x, const float* __restrict__ dw_w,
             const float* __restrict__ dw_b, const float* __restrict__ ln_g,
             const float* __restrict__ ln_b, float* __restrict__ h, int H, int W,
             int C) {
  extern __shared__ float s_val[];  // [kDwPix][C]
  const int x0 = blockIdx.x * kDwPix;
  const int y = blockIdx.y;
  const long long b = blockIdx.z;
  const float* xb = x + b * H * W * C;
  for (int idx = threadIdx.x; idx < kDwPix * C; idx += kThreads) {
    const int p = idx / C;
    const int c = idx - p * C;
    const int px = x0 + p;
    float acc = 0.0f;
    if (px < W) {
      acc = dw_b[c];
      for (int ky = 0; ky < 7; ++ky) {
        const int iy = y + ky - kHalo;
        if (iy < 0 || iy >= H) continue;
        const float* row = xb + (long long)iy * W * C;
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          const int ix = px + kx - kHalo;
          if (ix >= 0 && ix < W)
            acc = fmaf(row[(long long)ix * C + c], dw_w[(ky * 7 + kx) * C + c], acc);
        }
      }
    }
    s_val[idx] = acc;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* v = s_val + warp * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += v[c];
  const float mean = warp_sum(s) / C;
  float q = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = v[c] - mean;
    q = fmaf(d, d, q);
  }
  const float rstd = rsqrtf(warp_sum(q) / C + kEps);
  const int px = x0 + warp;
  if (px < W) {
    float* out = h + ((b * H + y) * W + px) * C;
    for (int c = lane; c < C; c += 32) out[c] = (v[c] - mean) * rstd * ln_g[c] + ln_b[c];
  }
}

// CJ: channels per lane (C <= 32 * CJ). PI: pixels per warp. Block
// (blockIdx.x, blockIdx.y) covers pixel tile x and hidden units
// [y * k_span, (y + 1) * k_span). With one split (gridDim.y == 1) it writes
// the finished block output; otherwise its partial projection sums go to
// partial[y] and reduce_kernel finishes them.
template <int CJ, int PI>
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const float* __restrict__ h, const float* __restrict__ x,
           const float* __restrict__ w1, const float* __restrict__ b1,
           const float* __restrict__ w2, const float* __restrict__ b2,
           const float* __restrict__ scale, float* __restrict__ out,
           float* __restrict__ partial, long long npix, int C, int k_span) {
  constexpr int TP = PI * kWarps;
  extern __shared__ float smem[];
  float* h_s = smem;             // [TP][C]
  float* u_s = smem + TP * C;    // [TP][kChunk]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long p0 = (long long)blockIdx.x * TP;

  for (int idx = threadIdx.x; idx < TP * C; idx += kThreads) {
    const int p = idx / C;
    const long long gp = p0 + p;
    h_s[idx] = gp < npix ? h[gp * C + (idx - p * C)] : 0.0f;
  }
  __syncthreads();

  float acc[PI][CJ];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.0f;

  const int hidden = 4 * C;
  const int k_begin = blockIdx.y * k_span;
  const int k_end = min(hidden, k_begin + k_span);
  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    const int k = k0 + lane;
    const bool k_ok = k < k_end;
    float u[PI];
    const float bk = k_ok ? b1[k] : 0.0f;
#pragma unroll
    for (int i = 0; i < PI; ++i) u[i] = bk;
    if (k_ok) {
      for (int c = 0; c < C; ++c) {
        const float w = w1[(long long)c * hidden + k];
#pragma unroll
        for (int i = 0; i < PI; ++i) u[i] = fmaf(h_s[(warp + i * kWarps) * C + c], w, u[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < PI; ++i)
      u_s[(warp + i * kWarps) * kChunk + lane] = k_ok ? gelu_exact(u[i]) : 0.0f;
    __syncwarp();

    const int kn = min(kChunk, k_end - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float* w2row = w2 + (long long)(k0 + kk) * C;
      float uk[PI];
#pragma unroll
      for (int i = 0; i < PI; ++i) uk[i] = u_s[(warp + i * kWarps) * kChunk + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = lane + 32 * j;
        if (c < C) {
          const float w = w2row[c];
#pragma unroll
          for (int i = 0; i < PI; ++i) acc[i][j] = fmaf(uk[i], w, acc[i][j]);
        }
      }
    }
    __syncwarp();
  }

  float* part = gridDim.y > 1 ? partial + blockIdx.y * npix * C : nullptr;
#pragma unroll
  for (int i = 0; i < PI; ++i) {
    const long long gp = p0 + warp + i * kWarps;
    if (gp >= npix) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = lane + 32 * j;
      if (c >= C) continue;
      if (part)
        part[gp * C + c] = acc[i][j];
      else
        out[gp * C + c] = x[gp * C + c] + (acc[i][j] + b2[c]) * scale[c];
    }
  }
}

// Sums the split partials in split order and applies the epilogue.
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ partial, const float* __restrict__ x,
              const float* __restrict__ b2, const float* __restrict__ scale,
              float* __restrict__ out, long long n, int C, int splits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partial[s * n + i];
  const int c = (int)(i % C);
  out[i] = x[i] + (acc + b2[c]) * scale[c];
}

template <int PI>
constexpr int tile_pixels() { return PI * kWarps; }

// Hidden-unit splits: enough blocks for two waves of the card's SMs when the
// pixel tiles alone are fewer, at most 8, each split a whole number of chunks.
struct Split {
  int splits;
  int k_span;
};

Split choose_split(long long npix, int C, int sms) {
  const int tp = C <= 96 ? tile_pixels<8>() : C <= 192 ? tile_pixels<4>()
               : C <= 384 ? tile_pixels<2>() : tile_pixels<1>();
  const long long blocks = (npix + tp - 1) / tp;
  const int chunks = (4 * C + kChunk - 1) / kChunk;
  int want = 1;
  if (blocks < 2LL * sms) {
    const long long w = (2LL * sms + blocks - 1) / blocks;
    want = w < 8 ? (int)w : 8;
  }
  const int per = (chunks + want - 1) / want;
  return Split{(chunks + per - 1) / per, per * kChunk};
}

template <int CJ, int PI>
cudaError_t launch_mlp(const float* h, const float* x, const float* w1, const float* b1,
                       const float* w2, const float* b2, const float* scale, float* out,
                       float* partial, long long npix, int C, Split split,
                       cudaStream_t stream) {
  constexpr int TP = PI * kWarps;
  const size_t smem = (size_t)(TP * C + TP * kChunk) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlp_kernel<CJ, PI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (npix + TP - 1) / TP;
  const dim3 grid((unsigned)blocks, split.splits);
  mlp_kernel<CJ, PI><<<grid, kThreads, smem, stream>>>(
      h, x, w1, b1, w2, b2, scale, out, partial, npix, C, split.k_span);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split.splits == 1) return e;
  const long long n = npix * C;
  reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      partial, x, b2, scale, out, n, C, split.splits);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch that convnext_block_f32 needs for this shape on a card
// with `sms` multiprocessors: the LayerNorm output h, then the split partials.
extern "C" long long convnext_block_f32_workspace(int B, int H, int W, int C, int sms) {
  const long long npix = (long long)B * H * W;
  const Split split = choose_split(npix, C, sms);
  return npix * C * (1 + (split.splits > 1 ? split.splits : 0));
}

// x and out are (B, H, W, C) f32, contiguous; workspace holds
// convnext_block_f32_workspace(B, H, W, C, sms) floats. dw_w is (49, C),
// w1 (C, 4C), w2 (4C, C); the vectors have C entries, b1 has 4C.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int convnext_block_f32(const float* x, const float* dw_w, const float* dw_b,
                                  const float* ln_g, const float* ln_b, const float* w1,
                                  const float* b1, const float* w2, const float* b2,
                                  const float* scale, float* workspace, float* out, int B,
                                  int H, int W, int C, int sms, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxC || H > 65535 || B > 65535 ||
      sms <= 0)
    return (int)cudaErrorInvalidValue;
  float* h = workspace;
  const dim3 grid1((W + kDwPix - 1) / kDwPix, H, B);
  dw_ln_kernel<<<grid1, kThreads, (size_t)kDwPix * C * sizeof(float), stream>>>(
      x, dw_w, dw_b, ln_g, ln_b, h, H, W, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long npix = (long long)B * H * W;
  const Split split = choose_split(npix, C, sms);
  float* partial = workspace + npix * C;
  if (C <= 96) {
    e = launch_mlp<3, 8>(h, x, w1, b1, w2, b2, scale, out, partial, npix, C, split, stream);
  } else if (C <= 192) {
    e = launch_mlp<6, 4>(h, x, w1, b1, w2, b2, scale, out, partial, npix, C, split, stream);
  } else if (C <= 384) {
    e = launch_mlp<12, 2>(h, x, w1, b1, w2, b2, scale, out, partial, npix, C, split, stream);
  } else {
    e = launch_mlp<24, 1>(h, x, w1, b1, w2, b2, scale, out, partial, npix, C, split, stream);
  }
  return (int)e;
}
