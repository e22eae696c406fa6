// The bf16 implicit-GEMM convolution of the neck level 0 and the heads
// (fpn_neck_l0.cu; fpn_heads.cu and precise_heads.cu through fpn_head.cuh)
// for Hopper (sm_90a), on a warp-specialised main loop fed by TMA:
//
//   acc[m][n] = sum_{t, c} x[b, i + oy_t, j + ox_t, c] * w[t][c][n]
//
// conv_gemm.cuh's sums (its Taps: a 1x1, a 3x3, or one phase of the heads'
// collapsed 2x2), from bf16 operands into f32 sums. conv_gemm.cuh keeps the
// f32 loop (3xTF32) and the loop of the wide bf16 paths, which split the
// features into slices and run a chunk of flattened pixels at a time.
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
//     each 64 channels (128 bytes) of K the producer brings one halo box of
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
//     memory. B (NB rows by 64 channels for each tap and chunk) comes by one
//     bulk copy a stage through its own ring, packed once per parameter set
//     in the same swizzle (kernels/packing.py::pack_sw128); a weight set
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
// A wait on a copy that never lands traps instead of hanging the card. x
// needs C % 8 == 0 and 16-byte alignment (the wrappers check it).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "conv_gemm.cuh"

namespace conv_tma {

using conv_gemm::bf16;
using conv_gemm::fence_regs;
using conv_gemm::mbar_wait;

constexpr int kKC = 64;                    // channels a stage: one 128-byte row
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

// The tensor map of an NHWC bf16 map x (B, H, W, C) as (C, W, H, B), in
// boxes of 64 channels by box_w columns by box_h rows of one image, with
// the 128-byte swizzle and zeros past its edges.
inline cudaError_t make_map_nhwc(CUtensorMap* map, const bf16* x, int B, int H, int W, int C,
                                 int box_w, int box_h) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {kKC, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
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

template <int NW, int K>
__device__ __forceinline__ void wgmma_rs(float (&d)[K], const uint32_t* a, uint64_t db,
                                         int scale_d) {
  if constexpr (NW == 96) {
    wgmma_rs_n96(d, a, db, scale_d);
  } else {
    static_assert(NW == 104, "wgmma width");
    wgmma_rs_n104(d, a, db, scale_d);
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
// NB / 2 each), the depths of the A and B rings, and whether B stays in
// shared memory (B_CHUNKS taps x chunks of it, in place of the B ring).
template <int BH_, int KH_, int KW_, int NB_, int N0_, int N1_, bool SPLIT_N_, int SA_, int SB_,
          int B_CHUNKS_ = 0>
struct Loop {
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

// The producer (one thread): for each unit of this block, in order, each
// chunk's halo box by TMA at the window's origin (oy0, ox0 of the set's
// Taps) into the A ring, and after it each tap's B of the chunk by a bulk
// copy into the B ring (or, once, all of B into the resident area). w
// holds each set's B, set-major, then tap-major, then chunk, B_BYTES each.
template <class L, class TapsOf>
__device__ __forceinline__ void produce(const CUtensorMap* map, const bf16* w, const Geo& g,
                                        TapsOf taps_of, uint32_t ring, uint32_t bars) {
  constexpr int kElems = L::B_BYTES / 2;
  const int nk = L::TAPS * g.chunks;
  if constexpr (L::B_RESIDENT) {
    const uint32_t bres = L::b_ring(ring), bar = L::resident(bars);
    mbar_expect(bar, nk * L::B_BYTES);
    for (int k = 0; k < nk; ++k)
      bulk_copy(bres + k * L::B_BYTES, w + (long long)k * kElems, L::B_BYTES, bar);
  }
  uint32_t ia = 0, ib = 0;
  const int units = g.tiles * g.sets;
  for (int un = blockIdx.x; un < units; un += gridDim.x) {
    const Unit u = unit_of<L::BH>(g, un);
    const conv_gemm::Taps t = taps_of(u.set);
    const bf16* wb = w + (long long)u.set * nk * kElems;
    for (int c = 0; c < g.chunks; ++c) {
      const int sa = claim<L::SA>(L::empty_a(bars, 0), ia++);
      mbar_expect(L::full_a(bars, sa), L::A_TX);
      tma_load_4d(ring + sa * L::A_BYTES, map, c * kKC, u.w0 + t.ox0, u.h0 + t.oy0, u.b,
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
    for (int q = 0; q < kKC / 16; ++q) ldmatrix_x4(a + 4 * q, row + (((2 * q + kgrp) ^ (r & 7)) << 4));
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
    for (int q = 0; q < kKC / 16; ++q) {
      const int scale = k > 0 || q > 0;
      wgmma_rs<L::N0>(acc0, a + 4 * q, db + q * kK16Sw128, scale);
      if constexpr (L::N1 > 0) wgmma_rs<L::N1>(acc1, a + 4 * q, db + kSecond + q * kK16Sw128, scale);
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

// The geometry of x (B, H, W, C) in tiles of BH rows with `sets` weight sets.
inline Geo make_geo(int B, int H, int W, int C, int BH, int sets) {
  Geo g;
  g.B = B;
  g.H = H;
  g.W = W;
  g.tiles_w = (W + kBW - 1) / kBW;
  g.tiles_h = (H + BH - 1) / BH;
  g.tiles = B * g.tiles_h * g.tiles_w;
  g.sets = sets;
  g.chunks = (C + kKC - 1) / kKC;
  return g;
}

// The tensor map of x for loop L: boxes of L's halo.
template <class L>
cudaError_t make_map(CUtensorMap* map, const bf16* x, int B, int H, int W, int C) {
  return make_map_nhwc(map, x, B, H, W, C, L::BOX_W, L::BOX_H);
}

}  // namespace conv_tma
