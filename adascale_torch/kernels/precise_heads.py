"""The four precise FpnHeads in one pass: a hand-written CUDA kernel and its
plain twin.

``fused_precise_heads(x, heads)`` computes the char prob (1 channel), up-left
corner offset (2), corner angle (4) and corner distance (4) heads over the
precise neck output ``x`` (B, H, W, C), each ``Linear(GELU(LN(conv3x3(
nearest_x2(x)) + b)))`` -> (B, 2H, 2W, M), before the distance head's
softplus. It replaces the Pallas TPU kernel ``adascale/ops/pallas/
precise_heads.py::_fused_heads_phases`` (``pl.pallas_call`` at :144). It
shares the phase-collapsed packing and the plain version with the rough heads
(``fpn_heads``); on a CUDA tensor it launches ``csrc/precise_heads.cu``, the
heads kernel of ``csrc/fpn_head.cuh`` in 200-wide tiles for inner widths of
192..194. Bound by operations: 506.7 GFLOP at the flagship's 256x208x384,
three TF32 products each, 3.07 ms on an H100 SXM (495 TFLOP/s dense TF32,
700 W). A bf16 ``x`` launches the bf16 entry (as the rough heads', with the
GELU output and projection rounded to bf16 before the projection, as the
Pallas kernel's compute-dtype projection; 0.51 ms at 989 TFLOP/s; on the
TMA-fed loop of ``csrc/conv_tma.cuh``, ``fpn_head.cuh::heads_tma_kernel``); heads
wider than the 200-wide tile (base 256-258, large 384-386) run in one launch
as the kernels' cluster forms, in two slices of 136 (base) or 200 (large)
features, each pixel tile's slices on one thread-block cluster
(``fpn_heads.run_heads_kernel``). Inside a
``utils.precision.matmul_precision("default")`` or ``("high")`` scope an
f32 ``x`` on the card launches the single-pass entry
``precise_heads_tf32`` (1.02 ms at 495 TFLOP/s; counted in
``LAUNCHES_TF32``): the bf16 entry's persistent TMA-fed loop on f32
operands (x rounded to TF32 in registers, the taps rounded and packed by
``packing.pack_sw128_tf32``), as the rough heads' TF32 entry, wider heads
on its cluster form. Its plain twin is
``fused_precise_heads_plain(..., tf32=True)``.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_upsample import heads_phase_form
from ..utils.precision import tf32_products
from . import _nvcc
from .fpn_heads import Params, bind, head_params, run_heads_kernel
from .fpn_neck import fpn_neck_forward_fused

# Calls that launched the kernel.
LAUNCHES = 0
# Calls that launched the bf16 kernel, counted apart (LAUNCHES counts
# the f32 ones).
LAUNCHES_BF16 = 0
# Calls that launched the single-pass TF32 entry, counted apart.
LAUNCHES_TF32 = 0

HEAD_NAMES = (
    "precise_char_prob_head",
    "precise_char_up_left_corner_offset_head",
    "precise_char_corner_angle_head",
    "precise_char_corner_distance_head",
)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return bind(_nvcc.build("precise_heads", "precise_heads.cu"), "precise_heads")


def fused_precise_heads_plain(
    x: torch.Tensor, heads: Sequence[Params], tf32: bool = False
) -> List[torch.Tensor]:
    """Eager PyTorch twin of the kernel: each head's (B, 2H, 2W, M) f32
    output; for a bf16 ``x`` rounded where the bf16 kernel rounds; ``tf32``
    (f32): the single-pass TF32 entry's twin."""
    bf16 = x.dtype == torch.bfloat16
    return heads_phase_form(x, heads, kernel=bf16, round_y=bf16, tf32=tf32 and not bf16)


def fused_precise_heads(x: torch.Tensor, heads: Sequence[Params]) -> List[torch.Tensor]:
    """Each head's (B, 2H, 2W, M) f32 output from an f32 or bf16 ``x``: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor. On the card it raises where a
    gradient is wanted."""
    global LAUNCHES, LAUNCHES_BF16, LAUNCHES_TF32
    _nvcc.check_dtype("fused_precise_heads x", x)
    if x.device.type == "cpu":
        return fused_precise_heads_plain(x, heads)
    tf32 = x.dtype == torch.float32 and tf32_products()
    outs = run_heads_kernel(build, "precise_heads", x, heads, "fused_precise_heads", round_y=True, tf32=tf32)
    if x.dtype == torch.bfloat16:
        LAUNCHES_BF16 += 1
    elif tf32:
        LAUNCHES_TF32 += 1
    else:
        LAUNCHES += 1
    return outs


def forward_precise_from_features_fused(
    model: nn.Module, features: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``AdaptiveScaling.forward_precise_from_features`` with the precise
    neck's level 0 and the four heads through their kernels; softplus on the
    corner distances in f32, as the model does."""
    neck = fpn_neck_forward_fused(model.precise_neck, features)
    prob, offset, angle, distance = fused_precise_heads(
        neck, [head_params(getattr(model, name)) for name in HEAD_NAMES]
    )
    return prob, offset, angle, F.softplus(distance.float())
