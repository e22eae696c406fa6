"""FPN neck and head, NHWC, PyTorch.

Counterpart of ``adascale/models/fpn.py``: per-level Linear-LN-GELU
laterals, a top-down nearest upsample + add, per-level 3x3-LN-GELU blocks to
out_channels / levels, nearest upsample of every level to level 0 and a
channel concat. The head's x2 branch is nearest-x2 -> conv3x3 -> LN -> GELU
-> Linear, computed as Flax computes it by default (``_PhaseFusedSmooth``):
four phase-collapsed 2x2 convolutions at the low resolution, then
interleaved (``ops/fused_upsample.py``, which says why the form matters).
Factor 1 is a 3x3 at the input resolution; factors 3 and 4 are a nearest
upsample then a 5x5.

Every module takes ``dtype`` as Flax's do: its products in ``dtype`` (input
and parameters cast there; parameters stay f32), LayerNorm and GELU in f32
rounded to it, so that at bf16 the port rounds where Flax rounds.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bf16 import gelu
from ..ops.fused_upsample import heads_phase_form, module_head_bf16
from ..ops.resize import resize_nearest
from .convnext import EPS, conv2d_nhwc, layer_norm, per_image


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype``; in bf16 the product and the bias add
    each rounded, as Flax's Dense rounds them, one image a call
    (``convnext.per_image``)."""
    if dtype == torch.float32:
        return F.linear(x.float(), layer.weight, layer.bias)
    w = layer.weight.to(dtype)
    return per_image(lambda xi: F.linear(xi.to(dtype), w), x) + layer.bias.to(dtype)


class Conv1x1Block(nn.Module):
    """Linear -> LN -> GELU on the channel axis."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Linear(in_channels, out_channels)
        self.ln = nn.LayerNorm(out_channels, eps=EPS)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(layer_norm(linear(x, self.conv, self.dtype), self.ln, self.dtype), self.dtype)


class ConvKxKBlock(nn.Module):
    """KxK conv (same padding) -> LN -> GELU."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel: int = 3, dtype: torch.dtype = torch.float32
    ):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, padding=kernel // 2)
        self.ln = nn.LayerNorm(out_channels, eps=EPS)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = layer_norm(conv2d_nhwc(x, self.conv, self.dtype), self.ln, self.dtype)
        return gelu(y, self.dtype)


class FpnNeck(nn.Module):
    def __init__(
        self, in_channels_group: Sequence[int], out_channels: int, dtype: torch.dtype = torch.float32
    ):
        super().__init__()
        num = len(in_channels_group)
        if num < 2 or out_channels % num:
            raise ValueError(f"FpnNeck: {num} levels, out_channels {out_channels}")
        self.num = num
        self.dtype = dtype
        inner = out_channels // num
        for i, c in enumerate(in_channels_group):
            self.add_module(f"step1_{i}", Conv1x1Block(c, out_channels, dtype))
        for i in range(num):
            self.add_module(f"step2_{i}", ConvKxKBlock(out_channels, inner, 3, dtype))

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        outputs = [getattr(self, f"step1_{i}")(f) for i, f in enumerate(features)]
        for i in range(self.num - 1, 0, -1):
            prev = outputs[i - 1]
            outputs[i - 1] = prev + resize_nearest(outputs[i], (prev.shape[1], prev.shape[2]))
        outputs = [getattr(self, f"step2_{i}")(o) for i, o in enumerate(outputs)]
        shape0 = (features[0].shape[1], features[0].shape[2])
        outputs = [outputs[0]] + [resize_nearest(o, shape0) for o in outputs[1:]]
        return torch.cat(outputs, dim=-1)


class FpnHead(nn.Module):
    """Nearest-upsample by ``upsampling_factor`` -> KxK conv -> LN -> GELU ->
    Linear: K = 3 for factors 1 and 2, K = 5 for factors 3 and 4."""

    def __init__(
        self, in_channels: int, out_channels: int, upsampling_factor: int = 2,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if not 1 <= upsampling_factor <= 4:
            raise NotImplementedError(f"FpnHead upsampling_factor {upsampling_factor}")
        self.upsampling_factor = upsampling_factor
        self.dtype = dtype
        inner = (in_channels + out_channels) // 2
        self.step1 = ConvKxKBlock(in_channels, inner, 3 if upsampling_factor <= 2 else 5, dtype)
        self.step2 = nn.Linear(inner, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.upsampling_factor
        x = x.to(self.dtype)
        if f == 2 and self.dtype == torch.bfloat16:
            params = dict(self.named_parameters())
            return per_image(lambda xi: module_head_bf16(xi, params), x)
        if f == 2:
            return heads_phase_form(x, [dict(self.named_parameters())])[0]
        if f > 1:
            x = resize_nearest(x, (x.shape[1] * f, x.shape[2] * f))
        return linear(self.step1(x), self.step2, self.dtype)
