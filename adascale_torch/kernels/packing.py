"""Weights in the layout of the port's ``wgmma`` kernels (``csrc/conv_gemm.cuh``),
and the cache that packs them once per parameter set.

``pack_kmajor(taps)`` lays a (..., K, n) weight operand out as the kernels'
f32 B: per 32-deep K chunk a TF32 ``hi`` and ``lo = tf32(w - hi)``, each in
wgmma's no-swizzle K-major core-matrix order; ``pack_sw128(taps)`` as the
bf16 B of the kernels on the TMA-fed loop (``csrc/conv_tma.cuh``: every
bf16 neck and heads kernel), per 64-deep chunk
n rows of 128 bytes in the 128-byte swizzle, and ``pack_sw128_tf32(taps)``
as the f32 B of their single-pass TF32 entries on that loop, per 32-deep
chunk, rounded to TF32. ``split_slices(taps, slices)`` cuts the output
features into the slices a wide kernel gives one CTA of a cluster each (the
wide heads, the wide neck's step1), before packing. ``pack_core_kmajor(w, rows, depth)`` tiles an (N, K) operand
for the bf16 ConvNeXt block's ``wgmma`` (``csrc/block_bf16.cuh``), and
``pack_block_bf16(w1, w2)`` packs that block's two projections in the form
its kernel takes for their width; ``pack_block_tf32(w1, w2)`` does the same,
rounded to TF32, for the block's single-pass TF32 entry
(``csrc/block_tf32.cuh``). ``cached(tensors, tag, pack)``
keeps what ``pack()`` built while ``tensors[0]`` lives, and reuses it while
every tensor it was packed from is unchanged. The heads (``fpn_heads``,
``precise_heads``) and the neck level 0 (``fpn_neck``) pack through both.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, Hashable, Sequence

import torch

from ..utils.precision import round_tf32 as tf32_round

# The packed layout's constants, as csrc/conv_gemm.cuh reads them: input
# channels a kernel stage (kKC), and the channel each wgmma K slot of a group
# of 8 holds (thread t of a quad loads channels 2t and 2t + 1, its K slots t
# and t + 4, with one 8-byte read). The CPU tests import both from here.
KC = 32
KSLOT = (0, 2, 4, 6, 1, 3, 5, 7)
# Input channels a stage of the bf16 one-pass neck and heads
# (csrc/conv_tma.cuh kKC): one 128-byte row of bf16.
KC_TMA = 64
# One pack per first tensor of its parameter set, by that tensor's id and
# dropped with it: (weak references to every tensor it was packed from,
# tag, their states, the pack).
_PACKED: Dict[int, tuple] = {}
# Packs built (calls of a ``pack``), so that a run can show that warm calls
# build none.
PACKS = 0


def pack_kmajor(taps: torch.Tensor) -> torch.Tensor:
    """``taps`` (..., K, n), K a multiple of 32 (zero past the real
    channels) and n of 8, as (..., K/32 chunks, 2, n/8, 8, 8, 4): each
    chunk's TF32 ``hi`` and ``lo = tf32(taps - hi)`` (axis -6) in wgmma's
    K-major core-matrix order (row group, K group of 4, row, K in group),
    with K slot s of each 8 holding channel ``KSLOT[s]`` of those 8."""
    *lead, k, n = taps.shape
    if k % KC or n % 8:
        raise ValueError(f"pack_kmajor: K={k}, n={n}; want K % {KC} == 0 and n % 8 == 0")
    nl = len(lead)
    t = taps.reshape(*lead, k // KC, KC // 8, 8, n)[..., KSLOT, :]
    t = t.reshape(*lead, k // KC, KC // 4, 4, n // 8, 8)
    t = t.permute(*range(nl + 1), nl + 3, nl + 1, nl + 4, nl + 2)
    hi = tf32_round(t)
    return torch.stack([hi, tf32_round(t - hi)], dim=nl + 1)


def pack_sw128_tf32(taps: torch.Tensor) -> torch.Tensor:
    """``taps`` (..., K, n), K a multiple of 32 (zero past the real
    channels) and n of 8, rounded to TF32 (``utils.precision.round_tf32``)
    as f32 (..., K/32 chunks, n/8, 8, 8, 4): each chunk's n rows of 32 K
    (128 bytes), 8 rows to a 1024-byte group, the 16-byte piece j of row r
    holding K 4 (j ^ r) .. 4 (j ^ r) + 3, the layout TMA's 128-byte swizzle
    gives a box of 32 f32 channels, K in its natural order. Element (k, n)
    of chunk k // 32 sits at [n // 8, n % 8, ((k % 32) // 4) ^ (n % 8),
    k % 4]. The single-pass TF32 kernels read it with ``wgmma``, which
    drops an f32 operand's low 13 bits, so the values are rounded here."""
    *lead, k, n = taps.shape
    if k % KC or n % 8:
        raise ValueError(f"pack_sw128_tf32: K={k}, n={n}; want K % {KC} == 0 and n % 8 == 0")
    nl = len(lead)
    t = taps.float().reshape(*lead, k // KC, 8, 4, n // 8, 8)  # (chunk, K group, K, row group, row)
    t = t.permute(*range(nl + 1), nl + 3, nl + 4, nl + 1, nl + 2)  # (chunk, row group, row, K group, K)
    rows = torch.arange(8)
    return tf32_round(t[..., rows[:, None], rows[:, None] ^ rows[None, :], :]).contiguous()


def pack_sw128(taps: torch.Tensor) -> torch.Tensor:
    """``taps`` (..., K, n), K a multiple of 64 (zero past the real
    channels) and n of 8, as bf16 (..., K/64 chunks, n/8, 8, 8, 8): each
    chunk's n rows of 64 K (128 bytes), 8 rows to a 1024-byte group, the
    16-byte piece j of row r holding K 8 (j ^ r) .. 8 (j ^ r) + 7, the
    layout TMA's 128-byte swizzle gives a box of 64 channels. Element (k, n)
    of chunk k // 64 sits at [n // 8, n % 8, ((k % 64) // 8) ^ (n % 8),
    k % 8]."""
    *lead, k, n = taps.shape
    if k % KC_TMA or n % 8:
        raise ValueError(f"pack_sw128: K={k}, n={n}; want K % {KC_TMA} == 0 and n % 8 == 0")
    nl = len(lead)
    t = taps.reshape(*lead, k // KC_TMA, 8, 8, n // 8, 8)  # (chunk, K group, K, row group, row)
    t = t.permute(*range(nl + 1), nl + 3, nl + 4, nl + 1, nl + 2)  # (chunk, row group, row, K group, K)
    rows = torch.arange(8)
    return t[..., rows[:, None], rows[:, None] ^ rows[None, :], :].to(torch.bfloat16).contiguous()


# The bf16 block's forms (csrc/block_bf16.cuh): the fused form's widest C,
# its wgmma widths (GEMM 2's N; C is padded up to one) and hidden units a
# chunk; the two-GEMM form's tile of output columns by K.
BLOCK_FUSED_MAX_C = 192
BLOCK_FUSED_WIDTHS = (96, 128, 192)
BLOCK_HIDDEN_CHUNK = 64
BLOCK_TILE = (128, 64)


def block_fused_width(c: int) -> int:
    """The fused form's wgmma width for C (``block_bf16.cuh::fused_width``),
    or 0 where C takes the two-GEMM form."""
    if c > BLOCK_FUSED_MAX_C:
        return 0
    return next(w for w in BLOCK_FUSED_WIDTHS if w >= c)


def pack_core_kmajor(w: torch.Tensor, rows: int, depth: int) -> torch.Tensor:
    """An (N, K) operand, zero-padded to multiples of ``rows`` and ``depth``,
    as bf16 tiles (N/rows, K/depth, rows/8, depth/8, 8, 8): tile (i, j)
    holds rows [rows i, rows (i + 1)) by K [depth j, depth (j + 1)) in
    wgmma's no-swizzle K-major core-matrix order (row group, K group, row,
    K in group), so that one bulk copy brings it to shared memory as the
    descriptor reads it."""
    n, k = w.shape
    if rows % 8 or depth % 8:
        raise ValueError(f"pack_core_kmajor: tiles {rows} x {depth}; want multiples of 8")
    np_, kp = -(-n // rows) * rows, -(-k // depth) * depth
    t = torch.nn.functional.pad(w.to(torch.bfloat16), (0, kp - k, 0, np_ - n))
    t = t.reshape(np_ // rows, rows // 8, 8, kp // depth, depth // 8, 8)
    return t.permute(0, 3, 1, 4, 2, 5).contiguous()


def pack_block_bf16(w1: torch.Tensor, w2: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The bf16 ConvNeXt block's W1 (4C, C) and W2 (C, 4C), nn.Linear's
    layouts, packed for its kernel (bf16, flat):

    - C <= ``BLOCK_FUSED_MAX_C`` (the fused form, C padded to CP =
      ``block_fused_width(C)``): ``w1`` holds, per chunk of
      ``BLOCK_HIDDEN_CHUNK`` hidden units, the chunk's W1 rows as one
      64 x CP tile, then W2's columns of those units as one CP x 64 tile
      (its rows the output channels), zero past C and 4C; ``w2`` is empty.
    - wider: ``w1`` and ``w2`` each in ``BLOCK_TILE`` tiles (128 output
      columns by 64 of K), column tile by column tile.
    """
    c = w1.shape[1]
    cp = block_fused_width(c)
    if cp:
        h = BLOCK_HIDDEN_CHUNK
        up = pack_core_kmajor(w1, h, cp).reshape(-1, h * cp)
        down = pack_core_kmajor(w2, cp, h).reshape(-1, cp * h)
        return {"w1": torch.stack([up, down], 1).reshape(-1), "w2": up.new_empty(0)}
    return {"w1": pack_core_kmajor(w1, *BLOCK_TILE).reshape(-1),
            "w2": pack_core_kmajor(w2, *BLOCK_TILE).reshape(-1)}


# The TF32 block's forms (csrc/block_tf32.cuh): the fused form's widest C
# and wgmma widths are bf16's; its hidden units a chunk by width (at 192
# two stages of f32 W1 and W2 chunks fit beside the h rows only at 32); the
# two-GEMM form's tile of output columns by K (one 128-byte row of f32).
BLOCK_TF32_HIDDEN = {96: 64, 128: 64, 192: 32}
BLOCK_TF32_TILE = (128, 32)


def pack_core_kmajor_tf32(w: torch.Tensor, rows: int, depth: int) -> torch.Tensor:
    """An (N, K) operand rounded to TF32 (``utils.precision.round_tf32``),
    zero-padded to multiples of ``rows`` and ``depth``, as f32 tiles
    (N/rows, K/depth, rows/8, depth/4, 8, 4): tile (i, j) holds rows
    [rows i, rows (i + 1)) by K [depth j, depth (j + 1)) in wgmma's
    no-swizzle K-major core-matrix order for 4-byte elements (row group, K
    group of 4, row, K in group)."""
    n, k = w.shape
    if rows % 8 or depth % 4:
        raise ValueError(f"pack_core_kmajor_tf32: tiles {rows} x {depth}; want rows % 8 == 0 and depth % 4 == 0")
    np_, kp = -(-n // rows) * rows, -(-k // depth) * depth
    t = torch.nn.functional.pad(w.float(), (0, kp - k, 0, np_ - n))
    t = t.reshape(np_ // rows, rows // 8, 8, kp // depth, depth // 4, 4)
    return tf32_round(t.permute(0, 3, 1, 4, 2, 5)).contiguous()


def kslot_columns(k: int) -> torch.Tensor:
    """The column order that puts, in each group of 8 of ``k`` columns,
    column ``KSLOT[s]`` at slot s: the K order of an operand that meets an
    accumulator turned into a TF32 A fragment (thread t of a quad holds
    columns 2t and 2t + 1 of each 8, which its fragment takes as K slots t
    and t + 4)."""
    if k % 8:
        raise ValueError(f"kslot_columns: {k} columns, want a multiple of 8")
    return torch.tensor([8 * (i // 8) + KSLOT[i % 8] for i in range(k)])


def pack_tiles_sw128_tf32(w: torch.Tensor) -> torch.Tensor:
    """An (N, K) operand, zero-padded to multiples of ``BLOCK_TF32_TILE``,
    as flat f32 tiles (N/128, K/32, 16, 8, 8, 4): for each 128-row tile and
    32-deep K chunk, ``pack_sw128_tf32``'s 128 rows of 128 bytes in the
    128-byte swizzle, rounded to TF32."""
    n, k = w.shape
    bn, bk = BLOCK_TF32_TILE
    np_, kp = -(-n // bn) * bn, -(-k // bk) * bk
    t = pack_sw128_tf32(torch.nn.functional.pad(w.float(), (0, kp - k, 0, np_ - n)).t())
    t = t.reshape(kp // bk, np_ // bn, bn // 8, 8, 8, 4).permute(1, 0, 2, 3, 4, 5)
    return t.contiguous().reshape(-1)


def pack_block_tf32(w1: torch.Tensor, w2: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The TF32 ConvNeXt block's W1 (4C, C) and W2 (C, 4C), nn.Linear's
    layouts, rounded to TF32 and packed for its kernel (f32, flat):

    - C <= ``BLOCK_FUSED_MAX_C`` (the fused form, C padded to CP =
      ``block_fused_width(C)``, NH = ``BLOCK_TF32_HIDDEN[CP]`` hidden units
      a chunk): ``w1`` holds, per chunk, the chunk's W1 rows as one NH x CP
      core-matrix tile (``pack_core_kmajor_tf32``), then W2's columns of
      those units as one CP x NH tile whose K (the hidden units) is in
      ``kslot_columns`` order within each 8, zero past C and 4C; ``w2`` is
      empty.
    - wider: ``w1`` and ``w2`` each by ``pack_tiles_sw128_tf32``.
    """
    c = w1.shape[1]
    cp = block_fused_width(c)
    if cp:
        nh = BLOCK_TF32_HIDDEN[cp]
        hidden = -(-4 * c // nh) * nh
        w2p = torch.nn.functional.pad(w2.float(), (0, hidden - 4 * c))[:, kslot_columns(hidden)]
        up = pack_core_kmajor_tf32(w1, nh, cp).reshape(-1, nh * cp)
        down = pack_core_kmajor_tf32(w2p, cp, nh).reshape(-1, cp * nh)
        return {"w1": torch.stack([up, down], 1).reshape(-1), "w2": up.new_empty(0)}
    return {"w1": pack_tiles_sw128_tf32(w1), "w2": pack_tiles_sw128_tf32(w2)}


def pack_for(
    taps: torch.Tensor, dtype: torch.dtype, tma: bool = False, tf32_sw128: bool = False
) -> torch.Tensor:
    """The B operand of a kernel by its operand type and loop: f32
    ``pack_kmajor`` (conv_gemm.cuh's loop) or ``pack_sw128_tf32`` (a
    single-pass TF32 entry on the TMA-fed loop, ``tma`` and
    ``tf32_sw128``); bf16 ``pack_sw128`` (every bf16 kernel runs on the
    TMA-fed loop, ``tma``; K padded to 64)."""
    if dtype == torch.bfloat16 and tma:
        return pack_sw128(taps)
    if dtype == torch.float32:
        return pack_sw128_tf32(taps) if tma and tf32_sw128 else pack_kmajor(taps)
    raise ValueError(f"no packed layout for {dtype} (tma={tma})")


def split_slices(taps: torch.Tensor, slices: int, axis: int) -> torch.Tensor:
    """(..., K, slices * n) -> the slices as a new axis at ``axis`` (counted
    before the split), each (..., K, n): the layout of a kernel that gives
    each slice of the output features its own block."""
    *lead, k, fp = taps.shape
    t = taps.reshape(*lead, k, slices, fp // slices)
    order = list(range(t.dim()))
    order.insert(axis, order.pop(-2))
    return t.permute(*order).contiguous()


def cached(
    tensors: Sequence[torch.Tensor], tag: Hashable, pack: Callable[[], Dict[str, torch.Tensor]]
) -> Dict[str, torch.Tensor]:
    """``pack()``, built once per parameter set: kept while ``tensors[0]``
    lives, and reused for the same ``tag`` while every tensor is the same
    object with the same ``_version`` (an in-place update repacks), storage
    (``param.data = new`` repacks), device and shape. Inference tensors
    carry no version counter and are packed every call. A reuse costs a
    few microseconds of host time (``tools/kernel_ms.py --only
    block_bf16_host``)."""
    global PACKS
    try:
        state = [(t._version, t.data_ptr(), t.get_device(), t.shape) for t in tensors]
    except RuntimeError:  # an inference tensor
        PACKS += 1
        return pack()
    key = id(tensors[0])
    entry = _PACKED.get(key)
    if entry is not None:
        refs, saved_tag, saved, packed = entry
        if saved_tag == tag and saved == state and all(r() is t for r, t in zip(refs, tensors)):
            return packed
    PACKS += 1
    packed = pack()
    refs = [weakref.ref(tensors[0], lambda _, key=key: _PACKED.pop(key, None))]
    _PACKED[key] = (refs + [weakref.ref(t) for t in tensors[1:]], tag, state, packed)
    return packed
