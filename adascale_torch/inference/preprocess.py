"""Preprocessing for inference, on the device.

Counterpart of ``adascale/inference/preprocess.py``: target shapes are
integer math on the host; the page goes to the device once as uint8 and is
area-downsampled to the short-side rule and zero-padded bottom/right to the
shape bucket there.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.resize import area_downsample


def compute_rough_shapes(
    height: int,
    width: int,
    short_side: int = 720,
    divisor: int = 32,
    bucket: int = 64,
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(resized_hw, padded_hw) for the rough pass: downsample only when the
    short side exceeds ``short_side`` (keeping the aspect ratio), then snap
    up to a multiple of ``bucket``."""
    h, w = height, width
    if min(h, w) > short_side:
        if h < w:
            rh, rw = short_side, round(w * (short_side / h))
        else:
            rh, rw = round(h * (short_side / w)), short_side
    else:
        rh, rw = h, w
    if bucket % divisor:
        raise ValueError(f"bucket {bucket} is not a multiple of divisor {divisor}")
    return (rh, rw), (math.ceil(rh / bucket) * bucket, math.ceil(rw / bucket) * bucket)


def compute_padded_shape(
    height: int, width: int, divisor: int = 32, bucket: int = 64
) -> Tuple[int, int]:
    if bucket % divisor:
        raise ValueError(f"bucket {bucket} is not a multiple of divisor {divisor}")
    return math.ceil(height / bucket) * bucket, math.ceil(width / bucket) * bucket


def preprocess_image(
    image: torch.Tensor,  # (H, W, 3) uint8 or float, on the target device
    resized_hw: Tuple[int, int],
    padded_hw: Tuple[int, int],
) -> torch.Tensor:
    """(H, W, 3) -> (1, PH, PW, 3) f32: area-downsample, then zero-pad."""
    x = area_downsample(image.float()[None], resized_hw)
    (rh, rw), (ph, pw) = resized_hw, padded_hw
    if (ph, pw) != (rh, rw):
        x = F.pad(x, (0, 0, 0, pw - rw, 0, ph - rh))
    return x
