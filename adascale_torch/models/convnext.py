"""ConvNeXt multi-scale backbone, NHWC, PyTorch.

Counterpart of ``adascale/models/convnext.py`` (inference: stochastic depth
is the identity). The patchify stem, the stage LayerNorms and the 2x2
downsamples are library ops; every residual block goes through
``adascale_torch.kernels.convnext_block`` (the CUDA kernel on the card, its
plain twin on the CPU). The residual stream is f32.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.convnext_block import convnext_block

EPS = 1e-6

CONVNEXT_PRESETS = {
    "tiny": ((96, 3), (192, 3), (384, 9), (768, 3)),
    "small": ((96, 3), (192, 3), (384, 27), (768, 3)),
    "base": ((128, 3), (256, 3), (512, 27), (1024, 3)),
    "large": ((192, 3), (384, 3), (768, 27), (1536, 3)),
}


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Apply an ``nn.Conv2d`` to an NHWC tensor; returns contiguous NHWC."""
    y = conv(x.permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).contiguous()


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm over the channel (last) axis in f32, eps 1e-6."""
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, eps=EPS)


class ConvNeXtBlock(nn.Module):
    """dwconv7x7 -> LN -> Linear(4C) -> GELU -> Linear(C) -> * scale -> + x."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.dwconv = nn.Conv2d(c, c, 7, padding=3, groups=c)
        self.ln = nn.LayerNorm(c, eps=EPS)
        self.mlp_up = nn.Linear(c, 4 * c)
        self.mlp_down = nn.Linear(4 * c, c)
        self.block_scale = nn.Parameter(torch.full((c,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = {
            "dwconv.weight": self.dwconv.weight,
            "dwconv.bias": self.dwconv.bias,
            "ln.weight": self.ln.weight,
            "ln.bias": self.ln.bias,
            "mlp_up.weight": self.mlp_up.weight,
            "mlp_up.bias": self.mlp_up.bias,
            "mlp_down.weight": self.mlp_down.weight,
            "mlp_down.bias": self.mlp_down.bias,
            "block_scale": self.block_scale,
        }
        return convnext_block(x.float().contiguous(), p)


class ConvNeXtStage(nn.Module):
    """N blocks + LN; returns (feature, downsampled input of the next stage)."""

    def __init__(self, channels: int, num_layers: int, out_channels: int | None):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"layer{i}", ConvNeXtBlock(channels))
        self.num_layers = num_layers
        self.ln = nn.LayerNorm(channels, eps=EPS)
        self.downsample = (
            nn.Conv2d(channels, out_channels, 2, stride=2) if out_channels else None
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        feature = layer_norm(x, self.ln)
        if self.downsample is None:
            return feature, feature
        return feature, conv2d_nhwc(feature, self.downsample)


class ConvNeXt(nn.Module):
    """(B, H, W, 3) -> four NHWC features at strides 4, 8, 16, 32."""

    def __init__(self, block_channels_and_num_layers: Sequence[Tuple[int, int]]):
        super().__init__()
        specs = tuple(tuple(s) for s in block_channels_and_num_layers)
        self.specs = specs
        self.stem_conv = nn.Conv2d(3, specs[0][0], 4, stride=4)
        self.stem_ln = nn.LayerNorm(specs[0][0], eps=EPS)
        for i, (c, n) in enumerate(specs):
            out_c = specs[i + 1][0] if i + 1 < len(specs) else None
            self.add_module(f"stage{i}", ConvNeXtStage(c, n, out_c))

    @property
    def in_channels_group(self) -> Tuple[int, ...]:
        return tuple(c for c, _ in self.specs)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = layer_norm(conv2d_nhwc(x, self.stem_conv), self.stem_ln)
        features: List[torch.Tensor] = []
        for i in range(len(self.specs)):
            feature, x = getattr(self, f"stage{i}")(x)
            features.append(feature)
        return features
