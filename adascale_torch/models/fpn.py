"""FPN neck and head, NHWC, PyTorch.

Counterpart of ``adascale/models/fpn.py``: per-level Linear-LN-GELU
laterals, a top-down nearest upsample + add, per-level 3x3-LN-GELU blocks to
out_channels / levels, nearest upsample of every level to level 0 and a
channel concat. The head's x2 branch is nearest-x2 -> conv3x3 -> LN -> GELU
-> Linear; the JAX package computes it as four low-resolution phases
(``_PhaseFusedSmooth``), which is the same function, so here it is written
directly. The x2 is exact, so ``F.interpolate(mode="nearest")`` follows the
floor convention.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_nearest
from .convnext import EPS, conv2d_nhwc, layer_norm


class Conv1x1Block(nn.Module):
    """Linear -> LN -> GELU on the channel axis."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Linear(in_channels, out_channels)
        self.ln = nn.LayerNorm(out_channels, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(layer_norm(self.conv(x), self.ln), approximate="none")


class ConvKxKBlock(nn.Module):
    """KxK conv (same padding) -> LN -> GELU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, padding=kernel // 2)
        self.ln = nn.LayerNorm(out_channels, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(layer_norm(conv2d_nhwc(x, self.conv), self.ln), approximate="none")


class FpnNeck(nn.Module):
    def __init__(self, in_channels_group: Sequence[int], out_channels: int):
        super().__init__()
        num = len(in_channels_group)
        if num < 2 or out_channels % num:
            raise ValueError(f"FpnNeck: {num} levels, out_channels {out_channels}")
        self.num = num
        inner = out_channels // num
        for i, c in enumerate(in_channels_group):
            self.add_module(f"step1_{i}", Conv1x1Block(c, out_channels))
        for i in range(num):
            self.add_module(f"step2_{i}", ConvKxKBlock(out_channels, inner, 3))

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
    """Nearest-x2 -> conv3x3 -> LN -> GELU -> Linear (upsampling factor 2)."""

    def __init__(self, in_channels: int, out_channels: int, upsampling_factor: int = 2):
        super().__init__()
        if upsampling_factor != 2:
            raise NotImplementedError(f"FpnHead upsampling_factor {upsampling_factor}")
        inner = (in_channels + out_channels) // 2
        self.step1 = ConvKxKBlock(in_channels, inner, 3)
        self.step2 = nn.Linear(inner, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.step2(self.step1(up.permute(0, 2, 3, 1)))
