"""Resize and pad primitives with the JAX package's conventions, NHWC.

Counterparts of ``adascale/ops/resize.py``:

  * ``resize_nearest``: PyTorch's asymmetric nearest convention,
    ``src = floor(dst * in / out)`` per axis (the FPN's top-down ladder);
  * ``resize_bilinear``: ``F.interpolate(mode="bilinear",
    align_corners=False)``'s half-pixel convention, the source clamped to
    [0, in - 1] (UPerNeXt's top-down ladder, its upsample to level 0 and its
    heads' pre-upsample);
  * ``adaptive_avg_pool``: ``nn.AdaptiveAvgPool2d``'s regions
    [floor(i * in / out), ceil((i + 1) * in / out)) (UPerNeXt's pyramid
    pooling);
  * ``area_downsample``: cv2 ``INTER_AREA`` box averaging for shrinking (the
    rough pass's preprocessing), as two separable products with the area
    weight matrices;
  * ``pad_length_to_make_divisible`` / ``pad_to_divisible``: bottom/right
    zero padding to a multiple of the backbone's downsampling factor.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC: ``out[i] = in[floor(i * in / out)]`` per axis."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    rows = torch.from_numpy(np.floor(np.arange(oh) * (h / oh)).astype(np.int64))
    cols = torch.from_numpy(np.floor(np.arange(ow) * (w / ow)).astype(np.int64))
    x = x.index_select(1, rows.to(x.device))
    return x.index_select(2, cols.to(x.device))


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC, half-pixel centres (align_corners=False).
    The JAX package computes the same weights as two dense products; here
    PyTorch's own kernel runs on a channels-last NCHW view. In f32 for any
    input, cast back to its dtype, as the JAX package's bf16 path does."""
    if (out_hw[0], out_hw[1]) == (x.shape[1], x.shape[2]):
        return x
    y = F.interpolate(
        x.float().permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear", align_corners=False
    )
    return y.permute(0, 2, 3, 1).to(x.dtype)


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Adaptive average pooling of NHWC to (out_size, out_size), as
    ``nn.AdaptiveAvgPool2d``; in f32, cast back to the input's dtype."""
    y = F.adaptive_avg_pool2d(x.float().permute(0, 3, 1, 2), out_size)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def area_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) box-filter matrix matching ``cv2.INTER_AREA`` for
    shrinking: output pixel i averages the source span [i*s, (i+1)*s),
    s = in/out, with fractional coverage at the edges."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    for i in range(out_size):
        left = i * scale
        right = (i + 1) * scale
        lo = int(math.floor(left))
        hi = int(math.ceil(right))
        for j in range(lo, min(hi, in_size)):
            cover = min(j + 1.0, right) - max(float(j), left)
            if cover > 0:
                w[i, j] = cover / scale
    return w


def area_downsample(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Area (box-average) downsample of NHWC f32: out = W_h · x · W_w^T."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    wh = torch.from_numpy(area_resize_weights(h, oh)).to(x.device)
    ww = torch.from_numpy(area_resize_weights(w, ow)).to(x.device)
    y = torch.einsum("iy,byxc->bixc", wh, x.float())
    return torch.einsum("jx,byxc->byjc", ww, y).to(x.dtype)


def pad_length_to_make_divisible(length: int, downsampling_factor: int) -> Tuple[int, int]:
    """(padded length, pad) for the next multiple of ``downsampling_factor``."""
    padded = math.ceil(length / downsampling_factor) * downsampling_factor
    return padded, padded - length


def pad_to_divisible(x: torch.Tensor, downsampling_factor: int = 32) -> torch.Tensor:
    """Zero-pad NHWC bottom/right so H and W divide ``downsampling_factor``."""
    h, w = x.shape[1], x.shape[2]
    ph, _ = pad_length_to_make_divisible(h, downsampling_factor)
    pw, _ = pad_length_to_make_divisible(w, downsampling_factor)
    if (ph, pw) == (h, w):
        return x
    return F.pad(x, (0, 0, 0, pw - w, 0, ph - h))
