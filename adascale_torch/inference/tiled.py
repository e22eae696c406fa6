"""Tiled full-resolution rough pass, on the device.

Counterpart of ``adascale/inference/tiled.py``: a large page is cut into
overlapping square tiles (stride-spaced origins, the last one end-aligned),
the tiles go through the rough forward as one batch (in chunks of the most
the kernels take in one launch, ``max_group_batch``: 64 tiles of 768), and
the per-tile maps are stitched back, each tile writing only the interior it
owns (the overlap margin cropped on interior edges, page borders kept).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

# Pixels of stage 0 (the input / 4) a launch takes: the block kernel's
# 65 535 row tiles of 64 pixels (kernels/csrc/convnext_block.cu); the heads
# kernel's 65 535 tiles of 128 level-0 pixels (kernels/csrc/fpn_head.cuh)
# allow twice that. Both take B <= 65 535.
MAX_STAGE0_PIXELS = 65535 * 64
MAX_BATCH = 65535


def max_group_batch(padded_hw: Tuple[int, int]) -> int:
    """The largest power-of-two batch of ``padded_hw`` inputs that every
    kernel of the forward takes in one launch."""
    limit = min(MAX_BATCH, MAX_STAGE0_PIXELS // ((padded_hw[0] // 4) * (padded_hw[1] // 4)))
    if limit < 1:
        raise ValueError(f"an input of {padded_hw} exceeds the block kernel's row tiles")
    return 1 << (limit.bit_length() - 1)


def compute_tile_origins(length: int, tile: int, stride: int) -> List[int]:
    """1-D tile origins covering [0, length): stride-spaced, the last tile
    end-aligned. Needs length >= tile."""
    if length < tile or stride < 1:
        raise ValueError(f"tile origins: length {length}, tile {tile}, stride {stride}")
    origins = list(range(0, length - tile + 1, stride))
    if origins[-1] + tile < length:
        origins.append(length - tile)
    return origins


def _ownership(
    origins: Sequence[int], tile: int, margin: int, length: int
) -> List[Tuple[int, int]]:
    """Each tile's half-open span [start, stop) of the stitched output: the
    margin cropped on interior edges, the page borders kept; the spans
    partition [0, length)."""
    n = len(origins)
    spans: List[Tuple[int, int]] = []
    for i, o in enumerate(origins):
        start = 0 if i == 0 else o + margin
        stop = length if i == n - 1 else min(o + tile - margin, length)
        if i > 0:
            start = min(start, spans[-1][1])
        spans.append((start, stop))
    fixed: List[Tuple[int, int]] = []
    for i, (start, stop) in enumerate(spans):
        if i > 0:
            start = fixed[-1][1]
        fixed.append((start, max(start, stop)))
    if fixed[0][0] != 0 or fixed[-1][1] != length:
        raise AssertionError(f"ownership spans {fixed} do not cover [0, {length})")
    return fixed


def tiled_rough_forward(
    forward_rough_batch: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    image: torch.Tensor,
    tile: int,
    overlap: int,
    fdf: int,
    max_batch: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the rough forward tile by tile over ``image`` (H, W, 3), H and W
    multiples of ``fdf`` and at least ``tile``, and stitch.

    ``forward_rough_batch(x: (N, tile, tile, 3)) -> (mask_logits, height)``,
    each (N, tile/fdf, tile/fdf, 1), is called with the tiles in chunks of
    at most ``max_batch`` (default ``max_group_batch((tile, tile))``): once
    for a page of up to that many tiles. Returns the stitched (H/fdf, W/fdf)
    maps."""
    h, w = image.shape[:2]
    if tile % fdf or overlap % (2 * fdf):
        raise ValueError(f"tile {tile} / overlap {overlap} must divide by {fdf} / {2 * fdf}")
    stride = tile - overlap
    ys = compute_tile_origins(h, tile, stride)
    xs = compute_tile_origins(w, tile, stride)
    tiles = torch.stack([image[oy : oy + tile, ox : ox + tile] for oy in ys for ox in xs])
    step = max_batch or max_group_batch((tile, tile))
    outs = [forward_rough_batch(tiles[k : k + step]) for k in range(0, len(tiles), step)]
    mask_logits = torch.cat([m for m, _ in outs])
    height = torch.cat([h for _, h in outs])

    ft, margin = tile // fdf, overlap // (2 * fdf)
    fh, fw = h // fdf, w // fdf
    fys, fxs = [o // fdf for o in ys], [o // fdf for o in xs]
    own_y = _ownership(fys, ft, margin, fh)
    own_x = _ownership(fxs, ft, margin, fw)
    out_mask = mask_logits.new_zeros(fh, fw)
    out_height = height.new_zeros(fh, fw)
    idx = 0
    for oy, (y0, y1) in zip(fys, own_y):
        for ox, (x0, x1) in zip(fxs, own_x):
            out_mask[y0:y1, x0:x1] = mask_logits[idx, y0 - oy : y1 - oy, x0 - ox : x1 - ox, 0]
            out_height[y0:y1, x0:x1] = height[idx, y0 - oy : y1 - oy, x0 - ox : x1 - ox, 0]
            idx += 1
    return out_mask, out_height
