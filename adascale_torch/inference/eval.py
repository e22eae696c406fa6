"""Detection-quality evaluation: polygon-IoU matching -> precision/recall/F1,
and the rough mask's IoU against the ground truth.

Counterpart of ``adascale/inference/eval.py`` (host-side numpy), using the
OpenCV-free ``Polygon.fill_mask`` and ``geometry.fill_poly``.
Rasterisation of a polygon pair happens on its joint bounding-box grid, so
the cost follows char size, not page size.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.geometry import Polygon, fill_poly


def polygon_iou(a: Polygon, b: Polygon) -> float:
    """Raster IoU of two polygons on their joint bounding-box grid."""
    ax0, ax1 = float(a.xs.min()), float(a.xs.max())
    ay0, ay1 = float(a.ys.min()), float(a.ys.max())
    bx0, bx1 = float(b.xs.min()), float(b.xs.max())
    by0, by1 = float(b.ys.min()), float(b.ys.max())
    if ax1 < bx0 or bx1 < ax0 or ay1 < by0 or by1 < ay0:
        return 0.0
    x0 = int(np.floor(min(ax0, bx0)))
    y0 = int(np.floor(min(ay0, by0)))
    x1 = int(np.ceil(max(ax1, bx1))) + 1
    y1 = int(np.ceil(max(ay1, by1))) + 1
    shape = (y1 - y0, x1 - x0)
    if shape[0] <= 0 or shape[1] <= 0 or shape[0] * shape[1] > 4_000_000:
        return 0.0
    ma = a.to_shifted_polygon(-y0, -x0).fill_mask(shape).astype(bool)
    mb = b.to_shifted_polygon(-y0, -x0).fill_mask(shape).astype(bool)
    union = np.logical_or(ma, mb).sum()
    return float(np.logical_and(ma, mb).sum()) / float(union) if union else 0.0


def _boxes(polygons: Sequence[Polygon]) -> np.ndarray:
    """(n, 4) bounding boxes (x0, x1, y0, y1), as ``polygon_iou`` takes them."""
    return np.asarray([[float(p.xs.min()), float(p.xs.max()), float(p.ys.min()), float(p.ys.max())]
                       for p in polygons], np.float64)


def match_polygons(
    preds: Sequence[Polygon], gts: Sequence[Polygon], iou_thr: float = 0.5
) -> List[Tuple[int, int, float]]:
    """One-to-one greedy matching by descending IoU; returns
    (pred_idx, gt_idx, iou) triples with iou >= iou_thr. For iou_thr > 0
    only the pairs whose bounding boxes touch are rasterised (the IoU of any
    other pair is 0), chosen at once over all pairs."""
    candidates: List[Tuple[float, int, int]] = []
    if iou_thr > 0 and preds and gts:
        a, b = _boxes(preds)[:, None], _boxes(gts)[None]
        apart = (a[..., 1] < b[..., 0]) | (b[..., 1] < a[..., 0])
        apart |= (a[..., 3] < b[..., 2]) | (b[..., 3] < a[..., 2])
        pairs = zip(*np.nonzero(~apart))
    else:
        pairs = ((i, j) for i in range(len(preds)) for j in range(len(gts)))
    for i, j in pairs:
        iou = polygon_iou(preds[i], gts[j])
        if iou >= iou_thr:
            candidates.append((iou, int(i), int(j)))
    candidates.sort(reverse=True)
    matched_p: set = set()
    matched_g: set = set()
    matches: List[Tuple[int, int, float]] = []
    for iou, i, j in candidates:
        if i in matched_p or j in matched_g:
            continue
        matched_p.add(i)
        matched_g.add(j)
        matches.append((i, j, iou))
    return matches


@dataclasses.dataclass(frozen=True)
class DetectionMetrics:
    precision: float
    recall: float
    f1: float
    num_pred: int
    num_gt: int
    num_matched: int
    mean_matched_iou: float

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def evaluate_char_detection(
    pred_polygons: Sequence[Polygon],
    gt_char_corners: Sequence[np.ndarray],
    iou_thr: float = 0.5,
) -> DetectionMetrics:
    """Predicted char quadrilaterals vs GT char corner arrays ((4, 2) (x, y))."""
    gts = [Polygon(np.asarray(c, np.float32)) for c in gt_char_corners]
    matches = match_polygons(list(pred_polygons), gts, iou_thr)
    num_pred, num_gt, num_matched = len(pred_polygons), len(gts), len(matches)
    precision = num_matched / num_pred if num_pred else 0.0
    recall = num_matched / num_gt if num_gt else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    mean_iou = float(np.mean([m[2] for m in matches])) if matches else 0.0
    return DetectionMetrics(
        precision=precision,
        recall=recall,
        f1=f1,
        num_pred=num_pred,
        num_gt=num_gt,
        num_matched=num_matched,
        mean_matched_iou=mean_iou,
    )


def mask_iou(pred_mask: np.ndarray, gt_mask: np.ndarray) -> float:
    """IoU of two binary masks (shapes must match); 1.0 where both are
    empty."""
    a = np.asarray(pred_mask) > 0
    b = np.asarray(gt_mask) > 0
    union = np.logical_or(a, b).sum()
    if not union:
        return 1.0
    return float(np.logical_and(a, b).sum()) / float(union)


def evaluate_rough_mask(
    rough_char_mask: np.ndarray,
    gt_chars: Sequence,
    page_shape: Tuple[int, int],
    valid_shape: Optional[Tuple[int, int]] = None,
) -> float:
    """IoU of the rough pass's char mask against the ground-truth char mask.

    ``rough_char_mask``: the engine's ``RoughInferResult.rough_char_mask``
    (at the padded feature resolution). ``gt_chars``: ``CharInstance``s (or
    anything with ``corners``) in page coordinates, scaled to the mask's
    valid region and filled as ``cv2.fillPoly`` fills their rounded corners.
    ``valid_shape``: that region (``RoughInferResult.resized_shape``); the
    comparison is restricted to it."""
    vh, vw = valid_shape if valid_shape is not None else rough_char_mask.shape[:2]
    gt = np.zeros((vh, vw), np.uint8)
    sy = vh / page_shape[0]
    sx = vw / page_shape[1]
    for c in gt_chars:
        pts = np.asarray(c.corners, np.float32) * np.asarray([[sx, sy]], np.float32)
        fill_poly(gt, np.round(pts).astype(np.int32))
    return mask_iou(rough_char_mask[:vh, :vw], gt)
