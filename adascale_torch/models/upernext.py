"""UPerNeXt neck and head, NHWC, PyTorch.

Counterpart of ``adascale/models/upernext.py``: 1x1 laterals on every level
but the last, a pyramid pooling module (adaptive average pools at scales 1,
2, 3, 6, each through a 1x1 block and bilinearly back, concatenated with the
level and through a 3x3 block) on the last; a top-down bilinear upsample +
add; 3x3 blocks on every level but the last; every level bilinearly up to
level 0 and concatenated. The head bilinearly upsamples by its factor, then
3x3 -> LN -> GELU -> Linear. Blocks are the FPN's (Linear or 3x3 conv, LN
with eps 1e-6, exact GELU), so the submodule names are the Flax tree's
(``step1_{i}``, ``ppm.ap_conv{k}``, ``ppm.final_conv``, ``step2_{i}``, the
head's ``step1`` and ``step2``, ``conv``/``ln`` inside) and
``utils.params.state_dict_from_jax`` loads the committed weights directly.
Each module takes ``dtype`` as the FPN's do; the pools and bilinear resizes
compute in f32 and return the input's dtype, as the JAX package's do.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.resize import adaptive_avg_pool, resize_bilinear
from .fpn import Conv1x1Block, ConvKxKBlock, linear

PPM_SCALES = (1, 2, 3, 6)


class PpmBlock(nn.Module):
    """Pyramid pooling over the last backbone level."""

    def __init__(
        self, in_channels: int, out_channels: int, scales: Sequence[int] = PPM_SCALES,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.scales = tuple(scales)
        for k in range(len(self.scales)):
            self.add_module(f"ap_conv{k}", Conv1x1Block(in_channels, out_channels, dtype))
        self.final_conv = ConvKxKBlock(
            in_channels + len(self.scales) * out_channels, out_channels, 3, dtype
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (x.shape[1], x.shape[2])
        features = [x] + [
            resize_bilinear(getattr(self, f"ap_conv{k}")(adaptive_avg_pool(x, s)), shape)
            for k, s in enumerate(self.scales)
        ]
        return self.final_conv(torch.cat(features, dim=-1))


class UperNextNeck(nn.Module):
    def __init__(
        self, in_channels_group: Sequence[int], out_channels: int, dtype: torch.dtype = torch.float32
    ):
        super().__init__()
        num = len(in_channels_group)
        if num < 2 or out_channels % num:
            raise ValueError(f"UperNextNeck: {num} levels, out_channels {out_channels}")
        self.num = num
        self.dtype = dtype
        inner = out_channels // num
        for i, c in enumerate(in_channels_group[:-1]):
            self.add_module(f"step1_{i}", Conv1x1Block(c, inner, dtype))
        self.ppm = PpmBlock(in_channels_group[-1], inner, dtype=dtype)
        for i in range(num - 1):
            self.add_module(f"step2_{i}", ConvKxKBlock(inner, inner, 3, dtype))

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        num = self.num
        outputs = [getattr(self, f"step1_{i}")(features[i]) for i in range(num - 1)]
        outputs.append(self.ppm(features[-1]))
        for i in range(num - 1, 0, -1):
            prev = outputs[i - 1]
            outputs[i - 1] = prev + resize_bilinear(outputs[i], (prev.shape[1], prev.shape[2]))
        for i in range(num - 1):
            outputs[i] = getattr(self, f"step2_{i}")(outputs[i])
        shape0 = (features[0].shape[1], features[0].shape[2])
        outputs = [outputs[0]] + [resize_bilinear(o, shape0) for o in outputs[1:]]
        return torch.cat(outputs, dim=-1)


class UperNextHead(nn.Module):
    """Bilinear upsample by ``upsampling_factor`` -> 3x3 -> LN -> GELU ->
    Linear."""

    def __init__(
        self, in_channels: int, out_channels: int, upsampling_factor: int = 1,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.upsampling_factor = upsampling_factor
        self.dtype = dtype
        inner = (in_channels + out_channels) // 2
        self.step1 = ConvKxKBlock(in_channels, inner, 3, dtype)
        self.step2 = nn.Linear(inner, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.upsampling_factor
        if f > 1:
            x = resize_bilinear(x, (x.shape[1] * f, x.shape[2] * f))
        return linear(self.step1(x), self.step2, self.dtype)
