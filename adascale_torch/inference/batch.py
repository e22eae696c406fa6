"""Batched multi-page serving: ``detect_many``.

Counterpart of ``adascale/inference/batch.py``. Pages are grouped by their
own padded rough shape bucket (the shape single-page ``detect()`` pads to),
and each group runs the rough pass as one batched forward: every page
area-downsampled on the device (``ops.resize.area_downsample``) and
zero-padded into the batch, the batch padded with zero pages to a power of
two, each page's padding invalidated on the device. The host geometry runs
per page and stacks each page's regions into one precise image (no area
chunking, as in the JAX package); the stacks are grouped by their own padded
bucket the same way and run as batched precise forwards, with the engine's
device peak pick. The per-page polygon build finishes on the host.

A group larger than the kernels take in one launch is split
(``tiled.max_group_batch``). The batched forwards run inside
``utils.precision.matmul_precision(cfg.matmul_precision)``, where the JAX
package opens ``jax.default_matmul_precision`` (around the forwards only;
its rough pages are resized before, outside the scope, and so are they
here).

With a ``mesh`` (``parallel.create_mesh``; every rank is given every page)
each group's batch is also a multiple of the mesh's ranks, as the JAX
package pads it for its sharded forwards; each rank builds and forwards its
rows of the batch only, and the maps are gathered over the mesh, so that
every rank returns every page's results, those of the mesh-less
``detect_many``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.resize import area_downsample
from ..parallel.mesh import all_gather_rows, mesh_rank, mesh_size
from ..utils.precision import matmul_precision
from .engine import AdaptiveScalingInference, RoughInferResult, precise_result
from .preprocess import compute_padded_shape, compute_rough_shapes
from .tiled import max_group_batch


def _groups(shapes: Sequence[Tuple[int, int]]) -> List[Tuple[Tuple[int, int], List[int]]]:
    """Page indices grouped by shape, in first-seen order, each group cut to
    ``max_group_batch`` pages."""
    by_shape: Dict[Tuple[int, int], List[int]] = {}
    for i, shape in enumerate(shapes):
        by_shape.setdefault(shape, []).append(i)
    out = []
    for shape, idxs in by_shape.items():
        step = max_group_batch(shape)
        out += [(shape, idxs[k : k + step]) for k in range(0, len(idxs), step)]
    return out


class BatchedAdaptiveScalingInference:
    """Wraps an ``AdaptiveScalingInference`` for multi-page throughput."""

    def __init__(self, engine: AdaptiveScalingInference, mesh: Optional[DeviceMesh] = None):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh: a DeviceMesh (parallel.create_mesh), not {type(mesh).__name__}")
        self.engine = engine
        self.mesh = mesh

    @staticmethod
    def _pad_batch(n: int, ranks: int = 1) -> int:
        """A group's batch rounded up to a power of two, and to a multiple of
        the mesh's ``ranks``."""
        pow2 = 1 << (max(n, 1) - 1).bit_length()
        return math.ceil(pow2 / ranks) * ranks

    def _rows(self, nb: int) -> range:
        """This rank's rows of a padded batch of ``nb``."""
        if self.mesh is None:
            return range(nb)
        b = nb // mesh_size(self.mesh)
        r = mesh_rank(self.mesh)
        return range(r * b, (r + 1) * b)

    def _gather(self, maps):
        """Each map's rows of every rank, in row order."""
        if self.mesh is None:
            return maps
        return tuple(all_gather_rows(m, self.mesh) for m in maps)

    def detect_many(self, images: Sequence[np.ndarray]) -> List[Dict[str, Any]]:
        """Both passes over a list of pages (H, W, 3) uint8; returns one
        ``detect()``-like result per page (one precise stack each)."""
        engine = self.engine
        cfg = engine.config
        device = engine.device
        n = len(images)
        if n == 0:
            return []
        fdf = 4 // cfg.rough_head_upsampling_factor
        pfdf = 4 // cfg.precise_head_upsampling_factor
        ranks = 1 if self.mesh is None else mesh_size(self.mesh)

        shapes = [
            compute_rough_shapes(
                im.shape[0],
                im.shape[1],
                short_side=cfg.rough_downsample_short_side_length,
                divisor=cfg.backbone_downsampling_factor,
                bucket=cfg.shape_bucket,
            )
            for im in images
        ]
        roughs: List[Optional[RoughInferResult]] = [None] * n
        for (ph, pw), idxs in _groups([padded for _, padded in shapes]):
            nb = self._pad_batch(len(idxs), ranks)
            rows = self._rows(nb)
            valid = [(0, 0)] * nb
            for j, i in enumerate(idxs):
                rh, rw = shapes[i][0]
                valid[j] = (math.ceil(rh / fdf), math.ceil(rw / fdf))
            with torch.inference_mode():
                batch = torch.zeros(len(rows), ph, pw, 3, device=device)
                for j, i in enumerate(idxs):
                    if j in rows:
                        rh, rw = shapes[i][0]
                        page = torch.from_numpy(np.ascontiguousarray(images[i])).to(device)
                        batch[j - rows.start, :rh, :rw] = area_downsample(page.float()[None], (rh, rw))[0]
                with matmul_precision(cfg.matmul_precision):
                    mask_logits, height = engine._forward(batch, "rough")
                maps = engine.rough_maps(mask_logits[..., 0], height[..., 0], valid[rows.start : rows.stop])
                mask, height = (m.cpu().numpy() for m in self._gather(maps))
            for j, i in enumerate(idxs):
                roughs[i] = RoughInferResult(
                    resized_shape=valid[j],
                    resized_image_shape=shapes[i][0],
                    padded_image_shape=(ph, pw),
                    rough_char_mask=mask[j],
                    rough_char_height_score_map=height[j],
                )

        regions = [engine.build_flattened_text_regions(im, r) for im, r in zip(images, roughs)]
        stacks = [engine.stack_flattened_text_regions(r) for r in regions]
        precise_shapes = [
            compute_padded_shape(
                *s.shape[:2], divisor=cfg.backbone_downsampling_factor, bucket=cfg.shape_bucket
            )
            for s, _ in stacks
        ]
        precises: List[Any] = [None] * n
        for (ph, pw), idxs in _groups(precise_shapes):
            nb = self._pad_batch(len(idxs), ranks)
            rows = self._rows(nb)
            valid = [(0, 0)] * nb
            for j, i in enumerate(idxs):
                h, w = stacks[i][0].shape[:2]
                valid[j] = (math.ceil(h / pfdf), math.ceil(w / pfdf))
            with torch.inference_mode():
                batch = torch.zeros(len(rows), ph, pw, 3, device=device)
                for j, i in enumerate(idxs):
                    if j in rows:
                        stacked = stacks[i][0]
                        h, w = stacked.shape[:2]
                        batch[j - rows.start, :h, :w] = torch.from_numpy(np.ascontiguousarray(stacked)).to(device)
                with matmul_precision(cfg.matmul_precision):
                    outputs = engine._forward(batch, "precise")
                maps = engine.precise_maps(outputs, valid[rows.start : rows.stop])
                maps = [m.cpu().numpy() for m in self._gather(maps)]
            for j, i in enumerate(idxs):
                precises[i] = precise_result(maps, j, (ph, pw), stacks[i][0].shape[:2])

        results = []
        for i in range(n):
            stacked, boxes = stacks[i]
            grouped, polygons = engine.build_char_polygons(precises[i], regions[i], boxes)
            results.append(
                {
                    "rough": roughs[i],
                    "regions": regions[i],
                    "stacked_image": stacked,
                    "boxes": boxes,
                    "precise": precises[i],
                    "num_precise_chunks": 1,
                    "grouped_polygons": grouped,
                    "char_polygons": polygons,
                }
            )
        return results
