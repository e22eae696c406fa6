"""End-to-end inference demo with visualisations.

Counterpart of ``adascale/inference/demo.py``: runs ``detect()`` on a page
and writes the same ten images, from the same parts of its result, under
the same stems (``STEMS``), as PNG (``utils/painter.py``; the port writes no
JPEG): the rough mask and score map over the resized page, the text-region
polygons with their index and by typicality, the stacked image, the precise
char-prob map and its thresholded mask, the precise char polygons and the
remapped polygons, plain and with coloured borders.

``cv2.resize`` becomes ``inference/flatten.py``'s ``resize_area`` and
``resize_nearest``; the page is read by ``utils/png.py::read_image`` (PNG or
an ``.npz`` page).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..utils.config import load_config
from ..utils.painter import Painter
from ..utils.png import read_image
from .engine import AdaptiveScalingInference, AdaptiveScalingInferenceConfig
from .flatten import resize_area, resize_nearest

STEMS = (
    "rough_mask",
    "rough_score_map",
    "text_region_polygons",
    "text_region_polygons_is_typical",
    "stacked_image",
    "precise_char_prob_score_map",
    "precise_char_prob_gt_70_mask",
    "precise_char_polygons",
    "remapped_char_polygons",
    "remapped_char_polygons_border",
)


def visualisations(engine: AdaptiveScalingInference, image: np.ndarray, result: dict) -> dict:
    """``detect()``'s result on ``image`` -> {stem: (H, W, 3) uint8 image},
    the JAX demo's images in its order."""
    rough = result["rough"]
    precise = result["precise"]
    regions = result["regions"]
    stacked = result["stacked_image"]
    out = {}

    # Rough visualisations.
    ph, pw = rough.padded_image_shape
    padded = np.zeros((ph, pw, 3), dtype=np.uint8)
    rh, rw = rough.resized_image_shape
    padded[:rh, :rw] = resize_area(image, (rh, rw))
    out["rough_mask"] = Painter(padded).paint_mask(resize_nearest(rough.rough_char_mask, (ph, pw))).image
    out["rough_score_map"] = Painter(padded).paint_score_map(
        resize_nearest(rough.rough_char_height_score_map, (ph, pw)), alpha=1.0
    ).image

    # Text regions.
    polygons = [r.text_region_polygon for r in regions]
    out["text_region_polygons"] = Painter(image).paint_polygons(polygons, enable_index=True).image
    colors = ["red" if r.is_typical else "blue" for r in regions]
    out["text_region_polygons_is_typical"] = Painter(image).paint_polygons(polygons, color=colors).image
    out["stacked_image"] = Painter(stacked).image

    # Precise visualisations.
    sph, spw = precise.padded_image_shape
    stacked_padded = np.zeros((sph, spw, 3), dtype=np.uint8)
    sh, sw = precise.stacked_image_shape
    stacked_padded[:sh, :sw] = stacked
    out["precise_char_prob_score_map"] = Painter(stacked_padded).paint_score_map(
        resize_nearest(precise.precise_char_prob_score_map, (sph, spw))
    ).image
    thr = engine.config.precise_build_polygons_positive_char_prob_thr
    out["precise_char_prob_gt_70_mask"] = Painter(stacked_padded).paint_mask(
        resize_nearest((precise.precise_char_prob_score_map >= thr).astype(np.uint8), (sph, spw))
    ).image

    # Polygons.
    flat = [p for group in result["grouped_polygons"] for p in group]
    out["precise_char_polygons"] = Painter(stacked_padded).paint_polygons(flat).image
    remapped = result["char_polygons"]
    out["remapped_char_polygons"] = Painter(image).paint_polygons(remapped).image
    lines, colors = [], []
    for polygon in remapped:
        pts = polygon.points
        if len(pts) != 4:
            continue
        ul, ur, dr, dl = pts
        lines.extend([(tuple(ul), tuple(ur)), (tuple(ur), tuple(dr)), (tuple(dr), tuple(dl)), (tuple(dl), tuple(ul))])
        colors.extend(["green", "yellow", "red", "yellow"])
    out["remapped_char_polygons_border"] = Painter(image).paint_lines(
        lines, color=colors, thickness=1, alpha=0.8
    ).image
    return out


def infer(
    inferencing_config_json: Optional[str],
    image_file: str,
    output_folder: str,
    engine: Optional[AdaptiveScalingInference] = None,
    image: Optional[np.ndarray] = None,
    device: Optional[str] = None,
) -> dict:
    """``detect()`` on the page, then ``STEMS`` as ``<output_folder>/<stem>.png``;
    returns ``detect()``'s result. Without ``engine`` one is built from the
    inference config (a JSON file, document or None); ``device`` replaces
    the config's (``"cuda"`` unless it says otherwise)."""
    os.makedirs(output_folder, exist_ok=True)
    if engine is None:
        config = load_config(inferencing_config_json, AdaptiveScalingInferenceConfig)
        if device is not None:
            config = dataclasses.replace(config, device=device)
        engine = AdaptiveScalingInference(config)
    if image is None:
        image = read_image(image_file)
    result = engine.detect(image)
    for stem, picture in visualisations(engine, image, result).items():
        Painter(picture).to_file(os.path.join(output_folder, f"{stem}.png"))
    return result
