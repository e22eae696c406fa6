"""Weights in the layout of the port's ``wgmma`` kernels (``csrc/conv_gemm.cuh``),
and the cache that packs them once per parameter set.

``pack_kmajor(taps)`` lays a (..., K, n) weight operand out as the kernels'
f32 B: per 32-deep K chunk a TF32 ``hi`` and ``lo = tf32(w - hi)``, each in
wgmma's no-swizzle K-major core-matrix order; ``pack_kmajor_bf16(taps)`` as
their bf16 B, one bf16 tile a chunk in the same order (8 bf16 a core-matrix
row, K in its natural order). ``split_slices(taps, slices)`` cuts the output
features into the slices a wide kernel launches one block each for, before
either packing. ``cached(tensors, tag, pack)``
keeps what ``pack()`` built while ``tensors[0]`` lives, and reuses it while
every tensor it was packed from is unchanged. The heads (``fpn_heads``,
``precise_heads``) and the neck level 0 (``fpn_neck``) pack through both.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, Hashable, Sequence

import torch
from torch.utils.weak import WeakIdKeyDictionary

# The packed layout's constants, as csrc/conv_gemm.cuh reads them: input
# channels a kernel stage (kKC), and the channel each wgmma K slot of a group
# of 8 holds (thread t of a quad loads channels 2t and 2t + 1, its K slots t
# and t + 4, with one 8-byte read). The CPU tests import both from here.
KC = 32
KSLOT = (0, 2, 4, 6, 1, 3, 5, 7)
# One pack per first tensor of its parameter set, held weakly: it goes with
# the model. The entry's guards name every tensor it was packed from.
_PACKED = WeakIdKeyDictionary()
# Packs built (calls of a ``pack``), so that a run can show that warm calls
# build none.
PACKS = 0


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, by integer ops on its bits, as the kernels split A."""
    return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


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


def pack_kmajor_bf16(taps: torch.Tensor) -> torch.Tensor:
    """``taps`` (..., K, n), K a multiple of 32 (zero past the real
    channels) and n of 8, as bf16 (..., K/32 chunks, n/8, 4, 8, 8): each
    chunk in wgmma's K-major core-matrix order (row group, K group of 8,
    row, K in group), the layout ``conv_gemm.cuh::mainloop_bf16`` reads."""
    *lead, k, n = taps.shape
    if k % KC or n % 8:
        raise ValueError(f"pack_kmajor_bf16: K={k}, n={n}; want K % {KC} == 0 and n % 8 == 0")
    nl = len(lead)
    t = taps.reshape(*lead, k // KC, KC // 8, 8, n // 8, 8)
    t = t.permute(*range(nl + 1), nl + 3, nl + 1, nl + 4, nl + 2)
    return t.to(torch.bfloat16).contiguous()


def pack_for(taps: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``pack_kmajor`` (f32) or ``pack_kmajor_bf16`` by the kernel's operand
    type."""
    if dtype == torch.bfloat16:
        return pack_kmajor_bf16(taps)
    if dtype == torch.float32:
        return pack_kmajor(taps)
    raise ValueError(f"no packed layout for {dtype}")


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
    carry no version counter and are packed every call."""
    global PACKS
    if any(t.is_inference() for t in tensors):
        PACKS += 1
        return pack()

    def state(t):
        return t._version, t.data_ptr(), t.device, tuple(t.shape)

    entry = _PACKED.get(tensors[0])
    if entry is not None:
        saved_tag, guards, packed = entry
        if saved_tag == tag and len(guards) == len(tensors) and all(
            ref() is t and saved == state(t) for (ref, saved), t in zip(guards, tensors)
        ):
            return packed
    PACKS += 1
    packed = pack()
    _PACKED[tensors[0]] = (tag, [(weakref.ref(t), state(t)) for t in tensors], packed)
    return packed
