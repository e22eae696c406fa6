"""Two-pass adaptive-scaling inference engine, PyTorch.

Counterpart of ``adascale/inference/engine.py``. Each pass runs on the
device: preprocessing (area resize + pad), the forward, sigmoid/threshold,
pad invalidation and the height floor for the rough pass; sigmoid/softmax
and the 5x5 max-filter peak pick for the precise pass. Only the final maps
come back to the host, where regions are flattened, rescaled and stacked,
and polygons are built, remapped and deduplicated
(``adascale_torch.data.geometry``, ``adascale_torch.inference.flatten``).

Every backbone block of both passes runs through
``adascale_torch.kernels.convnext_block``: the hand-written CUDA kernel on
the card, its plain twin on the CPU. With ``use_pallas_neck_heads`` an FPN
model's neck level 0 and the heads of each pass run through their kernels
too (``kernels.fpn_neck``, ``kernels.fpn_heads``, ``kernels.precise_heads``);
a UPerNeXt model keeps its module neck and heads there, as the JAX engine
routes it. ``detect(image, tiled=True)`` (or ``tiled_rough_long_side_min``)
runs the rough pass at full resolution over overlapping tiles
(``inference/tiled.py``); ``precise_band_recall_center_dist_ratio`` adds
the boundary-band recall pass. ``inference/batch.py`` serves many pages at
once.

Ported: f32 and bf16 (``compute_dtype="bfloat16"``) serving, both neck
types, the fused neck/head configuration, the single and tiled rough passes,
core-mask peak gating, band recall, NMS and area-chunked precise stacks. In
bf16 the engine follows the JAX engine's two paths: ``use_pallas_backbone``
picks the Pallas backbone's rounding (a bf16 residual between blocks) over
the Flax module's (f32 residual), and the fused neck and heads run only
together with it, as there; the input is cast to bf16 before the backbone
and the maps come back in f32.

``matmul_precision`` is "highest", "high" or "default". The rough pass
(preprocessing and forward), the precise forward and the tiled rough pass
run inside ``utils.precision.matmul_precision(cfg.matmul_precision)``, where
the JAX engine opens ``jax.default_matmul_precision``: at "high" and
"default" every f32 product on the card is one TF32 pass, in cuDNN and
cuBLAS and in the kernels' single-pass entries, as XLA computes it on a GPU
there; on the CPU all three compute the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.geometry import (
    Box,
    Polygon,
    affine_polygons,
    distance_transform_l2_3x3,
    mask_to_disconnected_polygons,
    rotate_trans_mat,
)
from ..kernels.fpn_heads import forward_rough_from_features_fused
from ..kernels.precise_heads import forward_precise_from_features_fused
from ..models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from ..utils.params import load_params, state_dict_from_jax
from ..utils.precision import PRECISIONS, matmul_precision, pin_full_f32
from .eval import polygon_iou
from .flatten import (
    FlattenedTextRegion,
    TextRegionFlattener,
    resize_nearest,
    stack_flattened_text_regions,
)
from .preprocess import compute_padded_shape, compute_rough_shapes, preprocess_image
from .tiled import tiled_rough_forward


@dataclasses.dataclass(frozen=True)
class AdaptiveScalingInferenceConfig:
    """The JAX engine's config fields and defaults, plus ``device``. See
    ``adascale/inference/engine.py`` for what each field does."""

    checkpoint: Optional[str] = None
    model: AdaptiveScalingConfig = AdaptiveScalingConfig()
    backbone_downsampling_factor: int = 32
    rough_head_upsampling_factor: int = 2
    rough_downsample_short_side_length: int = 720
    rough_char_mask_positive_thr: float = 0.5
    rough_valid_char_height_min: float = 3.0
    precise_head_upsampling_factor: int = 2
    precise_text_region_flattener_typical_long_side_ratio_min: float = 3.0
    precise_text_region_flattener_text_region_polygon_dilate_ratio: float = 0.8
    precise_flattened_text_region_resized_char_height_median: int = 35
    precise_flattened_text_region_resized_ratio_min: float = 0.25
    precise_stack_flattened_text_regions_page_pad: int = 10
    precise_stack_flattened_text_regions_pad: int = 2
    precise_build_polygons_positive_char_prob_thr: float = 0.6
    precise_build_polygons_maximum_filter_size: int = 5
    dedup_char_polygons_iou_thr: Optional[float] = 0.3
    precise_peak_gate_core_dilate_ratio: Optional[float] = 0.4
    precise_band_recall_center_dist_ratio: Optional[float] = None
    precise_band_recall_max_core_dist_ratio: float = 0.75
    precise_stacked_image_max_area: Optional[int] = 2048 * 2048
    shape_bucket: int = 64
    matmul_precision: str = "highest"
    compute_dtype: str = "float32"  # or "bfloat16"
    # The port always runs the backbone blocks through its kernel. In f32
    # this field is not read (both backbones compute the same function); in
    # bf16 it picks the Pallas backbone's rounding (a bf16 residual between
    # blocks) over the Flax module's (an f32 one), as the JAX engine does.
    use_pallas_backbone: bool = False
    # Level 0 of each FPN neck and the heads of each pass through their
    # kernels. The JAX engine reads this only together with
    # use_pallas_backbone; in f32 the port reads it alone, since its backbone
    # always runs its kernel and the function computed is the same; in bf16
    # it reads it as the JAX engine does.
    use_pallas_neck_heads: bool = False
    tiled_rough_tile_size: int = 768
    tiled_rough_tile_overlap: int = 128
    tiled_rough_long_side_min: Optional[int] = None
    device: str = "cuda"


@dataclasses.dataclass
class RoughInferResult:
    resized_shape: Tuple[int, int]  # valid region of the feature maps
    resized_image_shape: Tuple[int, int]
    padded_image_shape: Tuple[int, int]
    rough_char_mask: np.ndarray  # (FH, FW) uint8
    rough_char_height_score_map: np.ndarray  # (FH, FW) float32


@dataclasses.dataclass
class PreciseInferResult:
    padded_image_shape: Tuple[int, int]
    stacked_image_shape: Tuple[int, int]
    precise_char_prob_score_map: np.ndarray  # (FH, FW) float32
    precise_peak_mask: np.ndarray  # (FH, FW) uint8
    precise_np_char_up_left_corner_offset: np.ndarray  # (FH, FW, 2)
    precise_np_char_corner_angle_distribution: np.ndarray  # (FH, FW, 4)
    precise_np_char_corner_distance: np.ndarray  # (FH, FW, 4)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_supported(cfg: AdaptiveScalingInferenceConfig) -> None:
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of {sorted(COMPUTE_DTYPES)}")
    if cfg.matmul_precision not in PRECISIONS:
        raise ValueError(
            f"matmul_precision {cfg.matmul_precision!r}: one of {', '.join(repr(p) for p in PRECISIONS)}"
        )


def fused_neck_heads(cfg: AdaptiveScalingInferenceConfig) -> bool:
    """Whether the engine runs an FPN model's neck level 0 and heads through
    their kernels: ``use_pallas_neck_heads``, and in bf16 only together with
    ``use_pallas_backbone``, as the JAX engine routes them."""
    return (
        cfg.use_pallas_neck_heads
        and cfg.model.neck_head_type == "fpn"
        and (cfg.compute_dtype == "float32" or cfg.use_pallas_backbone)
    )


def valid_mask(
    shape: Sequence[int], valid: Sequence[Tuple[int, int]], device: torch.device
) -> torch.Tensor:
    """(B, FH, FW) bool: True where row < valid[b][0] and column <
    valid[b][1], so each page's padding is invalidated."""
    b, fh, fw = shape
    lim = torch.tensor(valid, dtype=torch.int64).reshape(b, 2).to(device)
    rows = torch.arange(fh, device=device)[None, :, None] < lim[:, 0, None, None]
    cols = torch.arange(fw, device=device)[None, None, :] < lim[:, 1, None, None]
    return rows & cols


def precise_result(
    maps: Sequence[np.ndarray], i: int, padded_hw: Tuple[int, int], stacked_hw: Tuple[int, int]
) -> PreciseInferResult:
    """Page ``i`` of ``AdaptiveScalingInference.precise_maps``'s output, on
    the host."""
    prob, peaks, offset, angles, distance = (m[i] for m in maps)
    return PreciseInferResult(
        padded_image_shape=tuple(padded_hw),
        stacked_image_shape=tuple(stacked_hw),
        precise_char_prob_score_map=prob,
        precise_peak_mask=peaks,
        precise_np_char_up_left_corner_offset=offset,
        precise_np_char_corner_angle_distribution=angles,
        precise_np_char_corner_distance=distance,
    )


class AdaptiveScalingInference:
    def __init__(
        self,
        config: AdaptiveScalingInferenceConfig,
        params: Optional[Mapping[str, Any]] = None,
    ):
        """``params``: the JAX package's nested parameter tree (numpy
        leaves); else ``config.checkpoint`` names a flat ``.npz`` or a
        reference state-dict file (``utils.params.load_params``)."""
        _check_supported(config)
        self.config = config
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {config.device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions on the CPU"
            )
        pin_full_f32()
        if params is None:
            if config.checkpoint is None:
                raise ValueError("need params or config.checkpoint")
            params = load_params(config.checkpoint, config.model)
        self.dtype = COMPUTE_DTYPES[config.compute_dtype]
        pallas_residual = self.dtype == torch.bfloat16 and config.use_pallas_backbone
        model = AdaptiveScaling(
            config.model, self.dtype, torch.bfloat16 if pallas_residual else torch.float32
        )
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        self.model = model.to(self.device).eval()

    def _forward(self, x: torch.Tensor, which: str):
        """Backbone, neck and heads of the rough or precise pass, on ``x``
        cast to the compute dtype. Where ``fused_neck_heads`` says so an FPN
        model's neck level 0 and heads go through their kernels; their
        kernels take the FPN's structure only, so a UPerNeXt model runs its
        module neck and heads, as the JAX engine routes it (the backbone runs
        the block kernel either way)."""
        x = x.to(self.dtype)
        if not fused_neck_heads(self.config):
            return self.model.forward_rough(x) if which == "rough" else self.model.forward_precise(x)
        features = self.model.backbone(x)
        if which == "rough":
            return forward_rough_from_features_fused(self.model, features)
        return forward_precise_from_features_fused(self.model, features)

    # ------------------------------------------------------------------ rough

    def rough_infer(self, image: np.ndarray) -> RoughInferResult:
        """Rough pass on the device: preprocess, forward, threshold, pad
        invalidation and the height floor; only the two maps come back."""
        cfg = self.config
        h, w = image.shape[:2]
        resized_hw, padded_hw = compute_rough_shapes(
            h,
            w,
            short_side=cfg.rough_downsample_short_side_length,
            divisor=cfg.backbone_downsampling_factor,
            bucket=cfg.shape_bucket,
        )
        fdf = 4 // cfg.rough_head_upsampling_factor
        valid = (math.ceil(resized_hw[0] / fdf), math.ceil(resized_hw[1] / fdf))
        with torch.inference_mode():
            page = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
            with matmul_precision(cfg.matmul_precision):
                x = preprocess_image(page, resized_hw, padded_hw)
                mask_logits, height = self._forward(x, "rough")
            mask, height = self.rough_maps(mask_logits[..., 0], height[..., 0], [valid])
        return RoughInferResult(
            resized_shape=valid,
            resized_image_shape=resized_hw,
            padded_image_shape=padded_hw,
            rough_char_mask=mask[0].cpu().numpy(),
            rough_char_height_score_map=height[0].cpu().numpy(),
        )

    def rough_maps(
        self, mask_logits: torch.Tensor, height: torch.Tensor, valid: Sequence[Tuple[int, int]]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, FH, FW) logits and heights -> the thresholded uint8 mask and
        the height map, each page's rows and columns past its ``valid``
        (h, w) zeroed, heights under ``rough_valid_char_height_min`` zeroed."""
        cfg = self.config
        ok = valid_mask(mask_logits.shape, valid, mask_logits.device)
        mask = (torch.sigmoid(mask_logits.float()) >= cfg.rough_char_mask_positive_thr) & ok
        height = height.float().masked_fill(~ok, 0.0)
        height = torch.where(
            height < cfg.rough_valid_char_height_min, torch.zeros_like(height), height
        )
        return mask.to(torch.uint8), height

    def rough_infer_tiled(self, image: np.ndarray) -> RoughInferResult:
        """Full-resolution rough pass: no short-side resize; the page is
        zero-padded to a multiple of the feature stride and to at least one
        tile, cut into overlapping tiles that go through one batched forward
        (chunked at the kernels' launch limits), and stitched on the device."""
        cfg = self.config
        h, w = image.shape[:2]
        fdf = 4 // cfg.rough_head_upsampling_factor
        tile = cfg.tiled_rough_tile_size
        ph = max(tile, math.ceil(h / fdf) * fdf)
        pw = max(tile, math.ceil(w / fdf) * fdf)
        valid = (math.ceil(h / fdf), math.ceil(w / fdf))
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(image)).to(self.device).float()
            with matmul_precision(cfg.matmul_precision):
                x = F.pad(x, (0, 0, 0, pw - w, 0, ph - h))
                mask_logits, height = tiled_rough_forward(
                    lambda t: self._forward(t, "rough"),
                    x,
                    tile=tile,
                    overlap=cfg.tiled_rough_tile_overlap,
                    fdf=fdf,
                )
            mask, height = self.rough_maps(mask_logits[None], height[None], [valid])
        return RoughInferResult(
            resized_shape=valid,
            resized_image_shape=(h, w),
            padded_image_shape=(ph, pw),
            rough_char_mask=mask[0].cpu().numpy(),
            rough_char_height_score_map=height[0].cpu().numpy(),
        )

    # ------------------------------------------------------- region flattening

    def build_flattened_text_regions(
        self, image: np.ndarray, rough: RoughInferResult
    ) -> List[FlattenedTextRegion]:
        """Flatten each rough region and rescale it so that its median char
        height becomes the canonical one."""
        cfg = self.config
        resized_shape = rough.resized_shape
        rough_polygons = mask_to_disconnected_polygons(rough.rough_char_mask)
        page_shape = image.shape[:2]
        text_region_polygons = [
            p.to_conducted_resized_polygon(resized_shape, page_shape) for p in rough_polygons
        ]
        regions = TextRegionFlattener(
            typical_long_side_ratio_min=(
                cfg.precise_text_region_flattener_typical_long_side_ratio_min
            ),
            text_region_polygon_dilate_ratio=(
                cfg.precise_text_region_flattener_text_region_polygon_dilate_ratio
            ),
            image=image,
            text_region_polygons=text_region_polygons,
            core_gate_dilate_ratio=cfg.precise_peak_gate_core_dilate_ratio,
        ).flattened_text_regions

        # Char-height medians in page pixels.
        inverse_resized_ratio = page_shape[0] / (
            resized_shape[0] * (4 // cfg.rough_head_upsampling_factor)
        )
        medians: List[float] = []
        for p in rough_polygons:
            values = p.extract_score_map_values(rough.rough_char_height_score_map)
            values = values[values > 0]
            medians.append(
                float(np.median(values)) * inverse_resized_ratio if len(values) else 0.0
            )

        target = cfg.precise_flattened_text_region_resized_char_height_median
        side_min = round(target * cfg.precise_flattened_text_region_resized_ratio_min)
        resized_regions: List[FlattenedTextRegion] = []
        for region, median in zip(regions, medians):
            if median <= 0.0:
                continue
            scale = target / median
            rh = round(region.height * scale)
            rw = round(region.width * scale)
            if rh < side_min and rw < side_min:
                continue
            if rh < 1 or rw < 1:
                continue
            resized_regions.append(region.to_resized_flattened_text_region(rh, rw))
        return resized_regions

    def stack_flattened_text_regions(
        self, flattened_text_regions: Sequence[FlattenedTextRegion]
    ) -> Tuple[np.ndarray, List[Box]]:
        cfg = self.config
        return stack_flattened_text_regions(
            page_pad=cfg.precise_stack_flattened_text_regions_page_pad,
            flattened_text_regions_pad=cfg.precise_stack_flattened_text_regions_pad,
            flattened_text_regions=flattened_text_regions,
        )

    # ---------------------------------------------------------------- precise

    def precise_infer(self, stacked_image: np.ndarray) -> PreciseInferResult:
        """Precise pass on the device: pad, forward, sigmoid/softmax and the
        max-filter peak pick; the maps come back to the host."""
        cfg = self.config
        h, w = stacked_image.shape[:2]
        ph, pw = compute_padded_shape(
            h, w, divisor=cfg.backbone_downsampling_factor, bucket=cfg.shape_bucket
        )
        fdf = 4 // cfg.precise_head_upsampling_factor
        valid = (math.ceil(h / fdf), math.ceil(w / fdf))
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(stacked_image)).to(self.device)
            x = F.pad(x.float()[None], (0, 0, 0, pw - w, 0, ph - h))
            with matmul_precision(cfg.matmul_precision):
                outputs = self._forward(x, "precise")
            maps = self.precise_maps(outputs, [valid])
            maps = [m.cpu().numpy() for m in maps]
        return precise_result(maps, 0, (ph, pw), (h, w))

    def precise_maps(
        self, outputs: Sequence[torch.Tensor], valid: Sequence[Tuple[int, int]]
    ) -> Tuple[torch.Tensor, ...]:
        """The precise forward's (B, FH, FW, *) outputs -> (prob, peaks,
        offset, angles, distance): the char prob with each page's rows and
        columns past its ``valid`` (h, w) zeroed, its thresholded 5x5 local
        maxima (uint8), the offsets, the corner-angle softmax and the
        distances."""
        cfg = self.config
        prob_logits, offset, angle_logits, distance = outputs
        prob = torch.sigmoid(prob_logits[..., 0].float())
        prob = prob.masked_fill(~valid_mask(prob.shape, valid, prob.device), 0.0)
        angles = torch.softmax(angle_logits.float(), dim=-1)
        # 5x5 max filter with -inf padding (max_pool2d pads with -inf).
        size = cfg.precise_build_polygons_maximum_filter_size
        local_max = F.max_pool2d(prob[:, None], size, stride=1, padding=size // 2)[:, 0]
        peaks = (prob == local_max) & (prob >= cfg.precise_build_polygons_positive_char_prob_thr)
        return prob, peaks.to(torch.uint8), offset.float(), angles, distance.float()

    # ------------------------------------------------------- polygon building

    def precise_build_polygon(
        self, precise: PreciseInferResult, point_y: int, point_x: int
    ) -> Polygon:
        """Polar corner reconstruction at a feature-grid point; its image
        position is ``point * fdf``."""
        fdf = 4 // self.config.precise_head_upsampling_factor
        py, px = float(point_y * fdf), float(point_x * fdf)
        off_y, off_x = precise.precise_np_char_up_left_corner_offset[point_y, point_x]
        up_left = np.asarray([px + off_x, py + off_y], dtype=np.float64)
        angle_distrib = precise.precise_np_char_corner_angle_distribution[point_y, point_x]
        distances = precise.precise_np_char_corner_distance[point_y, point_x]
        _, up_right_dis, down_right_dis, down_left_dis = distances

        two_pi = 2 * np.pi
        theta = float(np.arctan2(off_y, off_x)) % two_pi
        corners = [up_left]
        for frac, dis in zip(angle_distrib[:3], (up_right_dis, down_right_dis, down_left_dis)):
            theta = (theta + float(frac) * two_pi) % two_pi
            corners.append(
                np.asarray(
                    [px + math.cos(theta) * dis, py + math.sin(theta) * dis], dtype=np.float64
                )
            )
        score = float(precise.precise_char_prob_score_map[point_y, point_x])
        return Polygon(np.stack(corners), score=score)

    def precise_build_grouped_polygons(
        self,
        precise: PreciseInferResult,
        flattened_text_regions: Sequence[FlattenedTextRegion],
        boxes: Sequence[Box],
        collect_band: bool = False,
    ) -> Any:
        """Gate peaks to each region's box and core (else full) mask, then
        build one polygon per peak.

        With ``collect_band`` (and core gating on) returns ``(grouped,
        band_grouped, band_dists)``: per region also the polygons of the
        peaks inside its full dilated mask but outside its core, with each
        peak's distance (feature pixels) to the core, those farther than
        ``precise_band_recall_max_core_dist_ratio`` of the canonical char
        height dropped."""
        cfg = self.config
        if len(flattened_text_regions) != len(boxes):
            raise ValueError("one box per region expected")
        peak_mask = precise.precise_peak_mask
        fh, fw = peak_mask.shape
        fdf = 4 // cfg.precise_head_upsampling_factor
        cap = (
            cfg.precise_band_recall_max_core_dist_ratio
            * cfg.precise_flattened_text_region_resized_char_height_median
            / fdf
        )
        grouped: List[List[Polygon]] = []
        band_grouped: List[List[Polygon]] = []
        band_dists: List[List[float]] = []
        for region, box in zip(flattened_text_regions, boxes):
            dbox = box.to_resized_box(precise.padded_image_shape, (fh, fw)).clamp_to((fh, fw))
            gate = (
                region.flattened_core_mask
                if region.flattened_core_mask is not None
                else region.flattened_mask
            )
            region_mask = resize_nearest(gate, (dbox.height, dbox.width))
            boxed = dbox.extract(peak_mask).copy()
            polygons: List[Polygon] = []
            dists: List[float] = []
            if collect_band and region.flattened_core_mask is not None:
                full_mask = resize_nearest(region.flattened_mask, (dbox.height, dbox.width))
                band = boxed.copy()
                band[(full_mask == 0) | (region_mask != 0)] = 0
                ys, xs = np.nonzero(band)
                if len(ys):
                    # Distance to this region's own core: small for a char
                    # of this region its coarse core narrowly missed, large
                    # for a neighbour's char cut by this crop's boundary.
                    core_dist = distance_transform_l2_3x3((region_mask == 0).astype(np.uint8))
                    for y, x in zip(ys, xs):
                        d = float(core_dist[y, x])
                        if d > cap:
                            continue
                        polygons.append(
                            self.precise_build_polygon(precise, int(y) + dbox.up, int(x) + dbox.left)
                        )
                        dists.append(d)
            band_grouped.append(polygons)
            band_dists.append(dists)
            boxed[region_mask == 0] = 0
            ys, xs = np.nonzero(boxed)
            grouped.append(
                [
                    self.precise_build_polygon(precise, int(y) + dbox.up, int(x) + dbox.left)
                    for y, x in zip(ys, xs)
                ]
            )
        if collect_band:
            return grouped, band_grouped, band_dists
        return grouped

    def precise_build_remapped_polygons(
        self,
        flattened_text_regions: Sequence[FlattenedTextRegion],
        boxes: Sequence[Box],
        grouped_polygons: Sequence[Sequence[Polygon]],
    ) -> List[Polygon]:
        """Undo stacking shift, resize, trim and rotation per region."""
        remapped: List[Polygon] = []
        for region, box, polygons in zip(flattened_text_regions, boxes, grouped_polygons):
            if not polygons:
                continue
            stage1: List[Polygon] = []
            for polygon in polygons:
                p = polygon.to_relative_polygon(origin_y=box.up, origin_x=box.left)
                p = p.to_conducted_resized_polygon(region.shape, region.shape_before_resize)
                p = p.to_shifted_polygon(
                    offset_y=region.rotated_trimmed_box.up,
                    offset_x=region.rotated_trimmed_box.left,
                )
                stage1.append(p)
            if region.flattening_rotate_angle != 0.0:
                mat = rotate_trans_mat(
                    region.flattening_rotate_angle, region.bounding_extended_box.shape
                )
                full = np.vstack([mat, [0.0, 0.0, 1.0]]).astype(np.float64)
                stage1 = affine_polygons(np.linalg.inv(full), stage1)
            for p in stage1:
                remapped.append(
                    p.to_shifted_polygon(
                        offset_y=region.bounding_extended_box.up,
                        offset_x=region.bounding_extended_box.left,
                    )
                )
        return remapped

    def dedup_char_polygons(self, polygons: Sequence[Polygon]) -> List[Polygon]:
        """Greedy NMS over remapped char polygons (highest peak prob wins)."""
        thr = self.config.dedup_char_polygons_iou_thr
        if thr is None or len(polygons) <= 1:
            return list(polygons)
        order = sorted(
            range(len(polygons)),
            key=lambda i: -(polygons[i].score if polygons[i].score is not None else 0.0),
        )
        kept: List[Polygon] = []
        for i in order:
            p = polygons[i]
            if all(polygon_iou(p, k) < thr for k in kept):
                kept.append(p)
        return kept

    @staticmethod
    def _polygon_center_size(p: Polygon) -> Tuple[np.ndarray, float]:
        """The polygon's vertex mean and the square root of its area (at
        least 1)."""
        pts = np.asarray(p.points, dtype=np.float64)
        x, y = pts[:, 0], pts[:, 1]
        area = 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))
        return pts.mean(axis=0), math.sqrt(max(area, 1.0))

    def merge_band_polygons(self, kept: Sequence[Polygon], band: Sequence[Polygon]) -> List[Polygon]:
        """Add each band polygon, best owner first, unless its centre lies
        within ``precise_band_recall_center_dist_ratio`` of the smaller
        size of a polygon already kept or added."""
        ratio = self.config.precise_band_recall_center_dist_ratio
        if ratio is None or not band:
            return list(kept)
        out = list(kept)
        infos = [self._polygon_center_size(k) for k in out]
        centers = np.stack([c for c, _ in infos]) if infos else np.zeros((0, 2), np.float64)
        sizes = np.asarray([s for _, s in infos], dtype=np.float64)
        for p in band:
            c, size = self._polygon_center_size(p)
            if centers.shape[0]:
                dist = np.linalg.norm(centers - c[None, :], axis=1)
                if bool(np.any(dist < ratio * np.minimum(sizes, size))):
                    continue
            out.append(p)
            centers = np.concatenate([centers, c[None, :]], axis=0)
            sizes = np.concatenate([sizes, [size]])
        return out

    def build_char_polygons(
        self,
        precise: PreciseInferResult,
        flattened_text_regions: Sequence[FlattenedTextRegion],
        boxes: Sequence[Box],
    ) -> Tuple[List[List[Polygon]], List[Polygon]]:
        """Grouped peak -> polygon build, inverse remap and NMS, then (with
        ``precise_band_recall_center_dist_ratio``) the band recall pass: band
        polygons remapped region by region, ordered by core distance, then
        score, and merged. Returns (grouped core polygons, page-coordinate
        char polygons)."""
        if self.config.precise_band_recall_center_dist_ratio is None:
            grouped = self.precise_build_grouped_polygons(precise, flattened_text_regions, boxes)
            band_grouped, band_dists = [], []
        else:
            grouped, band_grouped, band_dists = self.precise_build_grouped_polygons(
                precise, flattened_text_regions, boxes, collect_band=True
            )
        remapped = self.precise_build_remapped_polygons(flattened_text_regions, boxes, grouped)
        remapped = self.dedup_char_polygons(remapped)
        if any(band_grouped):
            candidates: List[Tuple[float, float, Polygon]] = []
            for region, box, polys, dists in zip(
                flattened_text_regions, boxes, band_grouped, band_dists
            ):
                if not polys:
                    continue
                region_remapped = self.precise_build_remapped_polygons([region], [box], [polys])
                for p, d in zip(region_remapped, dists):
                    candidates.append((d, -(p.score if p.score is not None else 0.0), p))
            candidates.sort(key=lambda t: (t[0], t[1]))
            remapped = self.merge_band_polygons(remapped, [p for _, _, p in candidates])
        return grouped, remapped

    # -------------------------------------------------------------- end-to-end

    def detect(self, image: np.ndarray, tiled: Optional[bool] = None) -> Dict[str, Any]:
        """Page image (H, W, 3) uint8 -> char polygons in page coordinates.
        ``tiled=True``, or ``None`` with the page's long side at least
        ``tiled_rough_long_side_min``, runs the rough pass at full resolution
        over tiles. With several precise chunks, ``stacked_image``, ``boxes``
        and ``precise`` are those of the first chunk."""
        if tiled is None:
            tiled = (
                self.config.tiled_rough_long_side_min is not None
                and max(image.shape[:2]) >= self.config.tiled_rough_long_side_min
            )
        rough = self.rough_infer_tiled(image) if tiled else self.rough_infer(image)
        regions = self.build_flattened_text_regions(image, rough)
        grouped: List[List[Polygon]] = []
        remapped: List[Polygon] = []
        first_chunk = None
        chunks = self._chunk_regions_by_area(regions)
        for chunk in chunks:
            stacked, boxes = self.stack_flattened_text_regions(chunk)
            precise = self.precise_infer(stacked)
            g, r = self.build_char_polygons(precise, chunk, boxes)
            grouped.extend(g)
            remapped.extend(r)
            if first_chunk is None:
                first_chunk = (stacked, boxes, precise)
        if len(chunks) > 1:
            # Duplicates from overlapping crops can land in different chunks.
            remapped = self.dedup_char_polygons(remapped)
        stacked, boxes, precise = first_chunk
        return {
            "rough": rough,
            "regions": regions,
            "stacked_image": stacked,
            "boxes": boxes,
            "precise": precise,
            "num_precise_chunks": len(chunks),
            "grouped_polygons": grouped,
            "char_polygons": remapped,
        }

    def _chunk_regions_by_area(
        self, regions: Sequence[FlattenedTextRegion]
    ) -> List[List[FlattenedTextRegion]]:
        """Consecutive groups whose estimated packed area (1.5x the summed
        region areas) stays under ``precise_stacked_image_max_area``."""
        cap = self.config.precise_stacked_image_max_area
        if cap is None or not regions:
            return [list(regions)]
        chunks: List[List[FlattenedTextRegion]] = []
        cur: List[FlattenedTextRegion] = []
        area = 0.0
        for region in regions:
            a = 1.5 * float(region.height) * float(region.width)
            if cur and area + a > cap:
                chunks.append(cur)
                cur, area = [], 0.0
            cur.append(region)
            area += a
        chunks.append(cur)
        return chunks
