"""ConvNeXt multi-scale backbone, NHWC, PyTorch.

Counterpart of ``adascale/models/convnext.py``. The patchify stem, the
stage LayerNorms and the 2x2 downsamples are library ops; every residual
block goes through ``adascale_torch.kernels.convnext_block`` (the CUDA kernel
on the card, its plain twin on the CPU; with a gradient, through
``TrainableBlock``). The residual stream is f32.

``dtype=torch.bfloat16`` (the JAX package's ``compute_dtype="bfloat16"``)
runs the stem and the downsamples in bf16 and rounds every LayerNorm's
output to bf16, as Flax's modules at that dtype do; ``residual_dtype`` picks
which of the JAX package's two backbones the blocks follow: f32 (the Flax
module path, whose blocks keep an f32 residual and round inside) or bf16
(``convnext_forward_pallas``, whose blocks take and return bf16). Parameters
stay f32 and are cast where they are used.

Stochastic depth (``deterministic=False``) is applied outside the block, as
``convnext_forward_pallas_train`` does: ``x + mask * ((block(x) - x) /
keep)``, with one keep/drop draw per sample and the per-layer rate
``0.1 * l / (L - 1)`` over the L blocks. The masks are drawn from an
explicit ``torch.Generator`` by ``draw_drop_masks`` and passed in. Serving
is deterministic, the default.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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


def per_image(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over a batch one image at a time, for a library call in bf16.
    cuDNN and cuBLAS pick their algorithm (and so the order of each sum) by
    the batch too, and a bf16 output rounds the sum: on an H100 the same
    page came out of a batch of 4 one bf16 ulp apart in a third of stage 2's
    features, and its polygons moved. One image a call keeps a page's
    numbers the same alone and in a batch (``detect_many``)."""
    if x.shape[0] == 1:
        return fn(x)
    return torch.cat([fn(x[i : i + 1]) for i in range(x.shape[0])])


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Apply an ``nn.Conv2d`` to an NHWC tensor in ``dtype`` (input and
    parameters cast to it; in bf16 the convolution and the bias add each
    rounded, as Flax's Conv rounds them, one image a call: ``per_image``);
    returns contiguous NHWC."""
    if dtype == torch.float32:
        y = conv(x.float().permute(0, 3, 1, 2))
    else:
        y = per_image(lambda xi: F.conv2d(
            xi.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype), None,
            conv.stride, conv.padding, conv.dilation, conv.groups,
        ), x) + conv.bias.to(dtype)[:, None, None]
    return y.permute(0, 2, 3, 1).contiguous()


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm over the channel (last) axis in f32, eps 1e-6, rounded to
    ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, eps=EPS).to(dtype)


def drop_path(x: torch.Tensor, out: torch.Tensor, mask: torch.Tensor, keep_prob: float) -> torch.Tensor:
    """Stochastic depth around a residual block with input ``x`` and output
    ``out``: ``x + mask * ((out - x) / keep_prob)``, ``mask`` (B,) of 0/1.
    The branch's value is Flax ``DropPath``'s ``where(mask, branch / keep, 0)``
    exactly."""
    mask = mask.to(device=x.device, dtype=torch.float32).reshape(-1, *(1,) * (x.dim() - 1))
    return x + mask * ((out - x) / keep_prob)


class ConvNeXtBlock(nn.Module):
    """dwconv7x7 -> LN -> Linear(4C) -> GELU -> Linear(C) -> * scale -> + x;
    ``prob_bypass`` is its stochastic-depth rate; ``dtype`` and
    ``residual_dtype`` as the module docstring says."""

    def __init__(
        self, channels: int, prob_bypass: float, dtype: torch.dtype = torch.float32,
        residual_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        c = channels
        self.prob_bypass = prob_bypass
        self.dtype, self.residual_dtype = dtype, residual_dtype
        self.dwconv = nn.Conv2d(c, c, 7, padding=3, groups=c)
        self.ln = nn.LayerNorm(c, eps=EPS)
        self.mlp_up = nn.Linear(c, 4 * c)
        self.mlp_down = nn.Linear(4 * c, c)
        self.block_scale = nn.Parameter(torch.full((c,), 1e-6))

    def forward(self, x: torch.Tensor, drop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``drop_mask`` (B,) of 0/1 applies stochastic depth at this block's
        rate; None runs the block deterministically."""
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
        x = x.to(self.residual_dtype).contiguous()
        out = convnext_block(x, p) if self.dtype == torch.float32 else convnext_block(x, p, self.dtype)
        if drop_mask is None or self.prob_bypass == 0.0:
            return out
        return drop_path(x, out, drop_mask, 1.0 - self.prob_bypass)


class ConvNeXtStage(nn.Module):
    """N blocks + LN; returns (feature, downsampled input of the next stage)."""

    def __init__(
        self, channels: int, num_layers: int, out_channels: int | None, prob_bypass: Sequence[float],
        dtype: torch.dtype = torch.float32, residual_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        for i in range(num_layers):
            self.add_module(
                f"layer{i}", ConvNeXtBlock(channels, prob_bypass[i], dtype, residual_dtype)
            )
        self.num_layers = num_layers
        self.dtype = dtype
        self.ln = nn.LayerNorm(channels, eps=EPS)
        self.downsample = (
            nn.Conv2d(channels, out_channels, 2, stride=2) if out_channels else None
        )

    def forward(
        self, x: torch.Tensor, drop_masks: Optional[Sequence[Optional[torch.Tensor]]] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, None if drop_masks is None else drop_masks[i])
        feature = layer_norm(x, self.ln, self.dtype)
        if self.downsample is None:
            return feature, feature
        return feature, conv2d_nhwc(feature, self.downsample, self.dtype)


class ConvNeXt(nn.Module):
    """(B, H, W, 3) -> four NHWC features at strides 4, 8, 16, 32, in
    ``dtype``."""

    def __init__(
        self, block_channels_and_num_layers: Sequence[Tuple[int, int]],
        dtype: torch.dtype = torch.float32, residual_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        specs = tuple(tuple(s) for s in block_channels_and_num_layers)
        self.specs = specs
        self.dtype = dtype
        self.stem_conv = nn.Conv2d(3, specs[0][0], 4, stride=4)
        self.stem_ln = nn.LayerNorm(specs[0][0], eps=EPS)
        rates = drop_path_rates(specs)
        begin = 0
        for i, (c, n) in enumerate(specs):
            out_c = specs[i + 1][0] if i + 1 < len(specs) else None
            self.add_module(
                f"stage{i}",
                ConvNeXtStage(c, n, out_c, rates[begin : begin + n], dtype, residual_dtype),
            )
            begin += n

    @property
    def in_channels_group(self) -> Tuple[int, ...]:
        return tuple(c for c, _ in self.specs)

    def blocks(self) -> List[ConvNeXtBlock]:
        """The residual blocks in order (global layer index l)."""
        return [
            getattr(getattr(self, f"stage{i}"), f"layer{j}")
            for i, (_, n) in enumerate(self.specs) for j in range(n)
        ]

    def draw_drop_masks(
        self, batch_size: int, generator: torch.Generator
    ) -> List[Optional[torch.Tensor]]:
        """One (B,) 0/1 keep mask per block (None where its rate is 0),
        drawn on the generator's device: keep with probability 1 - rate."""
        masks: List[Optional[torch.Tensor]] = []
        for block in self.blocks():
            if block.prob_bypass == 0.0:
                masks.append(None)
                continue
            u = torch.rand((batch_size,), generator=generator, device=generator.device)
            masks.append((u < 1.0 - block.prob_bypass).float())
        return masks

    def forward(
        self,
        x: torch.Tensor,
        deterministic: bool = True,
        drop_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
    ) -> List[torch.Tensor]:
        """``deterministic=False`` applies stochastic depth with ``drop_masks``
        (one per block, drawn by ``draw_drop_masks`` before the forward, so a
        recompute under remat sees the same masks)."""
        if deterministic:
            drop_masks = None
        elif drop_masks is None:
            raise ValueError("deterministic=False needs drop_masks (draw_drop_masks)")
        x = layer_norm(conv2d_nhwc(x, self.stem_conv, self.dtype), self.stem_ln, self.dtype)
        features: List[torch.Tensor] = []
        begin = 0
        for i, (_, n) in enumerate(self.specs):
            masks = None if drop_masks is None else drop_masks[begin : begin + n]
            feature, x = getattr(self, f"stage{i}")(x, masks)
            features.append(feature)
            begin += n
        return features


def drop_path_rates(specs: Sequence[Tuple[int, int]]) -> List[float]:
    """Stochastic-depth rate of each block: ``0.1 * l / (L - 1)``."""
    total = sum(n for _, n in specs)
    return [0.1 * l / max(total - 1, 1) for l in range(total)]
