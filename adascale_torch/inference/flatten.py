"""Text-region flattening and stacking, on the host in numpy.

Counterpart of ``adascale/inference/flatten.py`` without OpenCV. Each
detected region polygon is dilated, cropped, rotated so that its long side
is horizontal, trimmed to the rotated mask and later resized; all regions
are then shelf-packed into one stacked image for one precise-pass forward.

The OpenCV calls of the JAX package are replaced as follows:

  * ``minAreaRect`` -> ``_min_area_rect``: OpenCV's convex hull and
    rotating calipers, followed in f32 step by step so that near-ties pick
    the same rectangle; ``_long_side_angle`` turns it into the rotation
    angle and long-side ratio as the JAX package does;
  * ``warpAffine`` -> ``warp_affine``: OpenCV 5.0's inverse-mapped f32
    bilinear warp with its fused multiply-adds and a constant border (zero
    unless asked), bit for bit where its vector loop runs;
  * ``resize`` -> ``resize_area`` / ``resize_linear`` / ``resize_nearest``,
    each with its OpenCV convention (area weights, half-pixel centres,
    ``floor(dst * in / out)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data.geometry import Box, Polygon, bilinear_fma, fma_f32, rotate_trans_mat, rotated_shape
from ..ops.resize import area_resize_weights


# ------------------------------------------------------------ image ops

def _round_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def resize_area(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(..., INTER_AREA)`` for shrinking, uint8: the area
    weights accumulated in f32 in OpenCV's order (columns, then rows), or
    OpenCV's rounded integer mean for an exact 2x2 shrink."""
    (h, w), (oh, ow) = img.shape[:2], out_hw
    x = img.reshape(h, w, -1)
    if (h, w) == (2 * oh, 2 * ow):
        s = x.astype(np.int32)
        total = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
        return ((total + 2) >> 2).astype(np.uint8).reshape((oh, ow) + img.shape[2:])
    wh, ww = area_resize_weights(h, oh), area_resize_weights(w, ow)
    xf = x.astype(np.float32)
    cols = np.zeros((h, ow, x.shape[2]), dtype=np.float32)
    for j in range(w):
        for i in np.nonzero(ww[:, j])[0]:
            cols[:, i] += xf[:, j] * ww[i, j]
    out = np.zeros((oh, ow, x.shape[2]), dtype=np.float32)
    for y in range(h):
        for i in np.nonzero(wh[:, y])[0]:
            out[i] += wh[i, y] * cols[y]
    return _round_u8(out).reshape((oh, ow) + img.shape[2:])


def _linear_taps(
    in_size: int, out_size: int, clamp_weights: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Source indices (out, 2) and 11-bit weights (out, 2) of OpenCV's
    half-pixel linear resize. Along x OpenCV clamps the weights at the edges;
    along y it keeps them and clamps the source rows."""
    idx = np.zeros((out_size, 2), dtype=np.int64)
    wts = np.zeros((out_size, 2), dtype=np.int64)
    scale = in_size / out_size
    for i in range(out_size):
        f = np.float32((i + 0.5) * scale - 0.5)
        s = int(math.floor(f))
        f = float(np.float32(f - s))
        if clamp_weights and s < 0:
            s, f = 0, 0.0
        if clamp_weights and s >= in_size - 1:
            s, f = in_size - 1, 0.0
        idx[i] = (min(max(s, 0), in_size - 1), min(max(s + 1, 0), in_size - 1))
        wts[i] = (np.rint(np.float32(1.0 - f) * 2048), np.rint(np.float32(f) * 2048))
    return idx, wts


def resize_linear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(..., INTER_LINEAR)`` on uint8 in OpenCV's fixed point:
    11-bit weights, an exact horizontal pass, and the vertical pass rounded
    as its vectorised path rounds it (within one gray level of OpenCV)."""
    (h, w), (oh, ow) = img.shape[:2], out_hw
    ri, rw = _linear_taps(h, oh, clamp_weights=False)
    ci, cw = _linear_taps(w, ow, clamp_weights=True)
    x = img.reshape(h, w, -1).astype(np.int64)
    hx = x[:, ci[:, 0]] * cw[None, :, 0, None] + x[:, ci[:, 1]] * cw[None, :, 1, None]
    b0, b1 = rw[:, 0, None, None], rw[:, 1, None, None]
    v = (((b0 * (hx[ri[:, 0]] >> 4)) >> 16) + ((b1 * (hx[ri[:, 1]] >> 4)) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8).reshape((oh, ow) + img.shape[2:])


def resize_nearest(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(..., INTER_NEAREST)``: src = floor(dst * in / out)."""
    (h, w), (oh, ow) = img.shape[:2], out_hw
    rows = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))).astype(np.int64), h - 1)
    cols = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))).astype(np.int64), w - 1)
    return img[rows][:, cols]


def invert_affine(mat: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` as ``warpAffine`` inverts its matrix:
    f64, ``1 / det`` times the adjugate, the offsets from the inverted
    coefficients."""
    m = [float(v) for v in np.asarray(mat, np.float64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0.0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, -m[1] * d, -m[3] * d
    return np.asarray(
        [[a11, a12, -a11 * m[2] - a12 * m[5]], [a21, a22, -a21 * m[2] - a22 * m[5]]], np.float64
    )


def warp_affine(img: np.ndarray, mat: np.ndarray, out_wh: Tuple[int, int], border_value: int = 0) -> np.ndarray:
    """``cv2.warpAffine(img, mat, out_wh, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=(v, v, v))`` on uint8, bit for
    bit with OpenCV 5.0 on every column its vector loop covers (all of them
    when the width is a multiple of 32; the last ``width % 32`` come from
    its scalar tail, within one gray level, as ``warp_perspective``'s).

    The matrix is inverted in f64 (``invert_affine``) and rounded to f32;
    destination pixel (x, y) samples ``fma(M0, x, y*M1 + M2)``,
    ``fma(M3, x, y*M4 + M5)`` in f32 (``data.geometry.bilinear_fma``)."""
    m = invert_affine(mat).astype(np.float32).reshape(-1)
    ow, oh = out_wh
    xs = np.arange(ow, dtype=np.float32)[None, :]
    ys = np.arange(oh, dtype=np.float32)[:, None]
    sx = fma_f32(m[0], xs, ys * m[1] + m[2])
    sy = fma_f32(m[3], xs, ys * m[4] + m[5])
    return bilinear_fma(img, sx, sy, border_value)


# ------------------------------------------------------------ regions

@dataclasses.dataclass
class FlattenedTextRegion:
    text_region_polygon: Polygon  # page coords
    bounding_extended_box: Box  # page coords of the extracted crop
    flattening_rotate_angle: float  # degrees fed to rotate_trans_mat
    rotated_trimmed_box: Box  # coords inside the rotated canvas
    shape_before_resize: Tuple[int, int]
    flattened_image: np.ndarray  # (h, w, 3) uint8
    flattened_mask: np.ndarray  # (h, w) uint8
    is_typical: bool
    post_rotate_angle: int = 0
    # Mask of the region's own (mildly dilated) polygon in flattened
    # coordinates; peaks are gated to it instead of flattened_mask.
    flattened_core_mask: Optional[np.ndarray] = None

    @property
    def height(self) -> int:
        return self.flattened_image.shape[0]

    @property
    def width(self) -> int:
        return self.flattened_image.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.flattened_image.shape[:2]

    def to_resized_flattened_text_region(
        self, resized_height: int, resized_width: int
    ) -> "FlattenedTextRegion":
        size = (resized_height, resized_width)
        if resized_height < self.height:
            image = resize_area(self.flattened_image, size)
        else:
            image = resize_linear(self.flattened_image, size)
        core = self.flattened_core_mask
        return dataclasses.replace(
            self,
            flattened_image=image,
            flattened_mask=resize_nearest(self.flattened_mask, size),
            flattened_core_mask=None if core is None else resize_nearest(core, size),
        )


_F32 = np.float32


def _sign(v) -> int:
    return int(v > 0) - int(v < 0)


def _sklansky(pts, start: int, end: int, nsign: int, sign2: int) -> List[int]:
    """One monotone chain of OpenCV's Sklansky hull over x-sorted points."""
    incr = 1 if end > start else -1
    if start == end or (pts[start][0] == pts[end][0] and pts[start][1] == pts[end][1]):
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury, nexty = pts[pcur][1], pts[pnext][1]
        by = _F32(nexty - cury)
        if _sign(by) != nsign:
            ax = _F32(pts[pcur][0] - pts[pprev][0])
            bx = _F32(pts[pnext][0] - pts[pcur][0])
            ay = _F32(cury - pts[pprev][1])
            convexity = float(ay) * float(bx) - float(ax) * float(by)
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                pnext += incr
                stack[1:] = [pcur, pnext]
            else:
                stack[-2] = pnext
                stack.pop()
                pcur = pprev
                pprev = stack[-3]
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def _opencv_convex_hull(points: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(points)`` (counter-clockwise) on f32 points, with
    OpenCV's start point and cyclic shift, as ``minAreaRect`` takes it."""
    data = [(_F32(x), _F32(y)) for x, y in np.asarray(points, dtype=np.float32)]
    order = sorted(range(len(data)), key=lambda i: (data[i][0], data[i][1]))
    pts = [data[i] for i in order]
    total = len(pts)
    miny = maxy = 0
    for i in range(1, total):
        if pts[miny][1] > pts[i][1]:
            miny = i
        if pts[maxy][1] < pts[i][1]:
            maxy = i
    if pts[0] == pts[-1]:
        hull = [order[0]]
    else:
        # Upper chains, swapped for the counter-clockwise output.
        tr = _sklansky(pts, 0, maxy, -1, 1)
        tl = _sklansky(pts, total - 1, maxy, -1, -1)
        out = [tl[i] for i in range(len(tl) - 1)]
        out += [tr[i] for i in range(len(tr) - 1, 0, -1)]
        stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
        bl = _sklansky(pts, 0, miny, 1, -1)
        br = _sklansky(pts, total - 1, miny, 1, 1)
        if stop >= 0:
            check = bl[1] if len(bl) > 2 else br[2 - len(bl)] if len(bl) + len(br) > 2 else -1
            if check == stop or (check >= 0 and pts[check] == pts[stop]):
                bl, br = bl[:2], br[:2]
        out += [bl[i] for i in range(len(bl) - 1)]
        out += [br[i] for i in range(len(br) - 1, 0, -1)]
        hull = [order[k] for k in out]
        # Cyclic shift towards an ascending or descending index sequence.
        nout = len(hull)
        if nout >= 3:
            min_idx = max_idx = lt = 0
            for i in range(1, nout):
                idx = hull[i]
                lt += hull[i - 1] < idx
                if 1 < lt < i - 1:
                    break
                if idx < hull[min_idx]:
                    min_idx = i
                if idx > hull[max_idx]:
                    max_idx = i
            mmdist = abs(max_idx - min_idx)
            if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
                ascending = (max_idx + 1) % nout == min_idx
                i0 = min_idx if ascending else max_idx
                if i0 > 0:
                    shifted, j = [], i0
                    for i in range(nout):
                        cur = hull[j]
                        shifted.append(cur)
                        nj = j + 1 if j + 1 < nout else 0
                        if i < nout - 1 and ascending != (cur < hull[nj]):
                            break
                        j = nj
                    else:
                        hull = shifted
    return np.asarray([data[i] for i in hull], dtype=np.float32)


def _min_area_rect(points: np.ndarray) -> Tuple[float, float, float]:
    """(width, height, angle_deg) of ``cv2.minAreaRect``: OpenCV's rotating
    calipers in f32, including its tie-breaking."""
    hull = _opencv_convex_hull(points)
    n = len(hull)
    if n == 1:
        return 0.0, 0.0, 0.0
    if n == 2:
        dx = float(hull[1, 0] - hull[0, 0])
        dy = float(hull[1, 1] - hull[0, 1])
        return float(_F32(math.hypot(dx, dy))), 0.0, math.degrees(math.atan2(dy, dx))
    p = [(_F32(x), _F32(y)) for x, y in hull]
    vect, inv_len = [], []
    left = bottom = right = top = 0
    left_x = right_x = p[0][0]
    top_y = bottom_y = p[0][1]
    pt0 = p[0]
    for i in range(n):
        if pt0[0] < left_x:
            left_x, left = pt0[0], i
        if pt0[0] > right_x:
            right_x, right = pt0[0], i
        if pt0[1] > top_y:
            top_y, top = pt0[1], i
        if pt0[1] < bottom_y:
            bottom_y, bottom = pt0[1], i
        pt = p[(i + 1) % n]
        dx, dy = float(_F32(pt[0] - pt0[0])), float(_F32(pt[1] - pt0[1]))
        vect.append((_F32(dx), _F32(dy)))
        inv_len.append(_F32(1.0 / math.sqrt(dx * dx + dy * dy)))
        pt0 = pt
    orientation = _F32(0)
    ax, ay = float(vect[-1][0]), float(vect[-1][1])
    for i in range(n):
        bx, by = float(vect[i][0]), float(vect[i][1])
        convexity = ax * by - ay * bx
        if convexity != 0:
            orientation = _F32(1) if convexity > 0 else _F32(-1)
            break
        ax, ay = bx, by
    base_a, base_b = orientation, _F32(0)
    seq = [bottom, right, top, left]
    minarea = _F32(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        dp = [
            base_a * vect[seq[0]][0] + base_b * vect[seq[0]][1],
            -base_b * vect[seq[1]][0] + base_a * vect[seq[1]][1],
            -base_a * vect[seq[2]][0] - base_b * vect[seq[2]][1],
            base_b * vect[seq[3]][0] - base_a * vect[seq[3]][1],
        ]
        maxcos = dp[0] * inv_len[seq[0]]
        main = 0
        for i in range(1, 4):
            cosalpha = dp[i] * inv_len[seq[i]]
            if cosalpha > maxcos:
                main, maxcos = i, cosalpha
        k = seq[main]
        lead_x, lead_y = vect[k][0] * inv_len[k], vect[k][1] * inv_len[k]
        base_a, base_b = (
            (lead_x, lead_y),
            (lead_y, -lead_x),
            (-lead_x, -lead_y),
            (-lead_y, lead_x),
        )[main]
        seq[main] = (seq[main] + 1) % n
        dx = p[seq[1]][0] - p[seq[3]][0]
        dy = p[seq[1]][1] - p[seq[3]][1]
        width = dx * base_a + dy * base_b
        dx = p[seq[2]][0] - p[seq[0]][0]
        dy = p[seq[2]][1] - p[seq[0]][1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (base_a, base_b, width, height)
    a1, b1, width, height = best
    o1 = (float(a1 * width), float(b1 * width))
    o2 = (float(-b1 * height), float(a1 * height))
    w = float(_F32(math.sqrt(o1[0] ** 2 + o1[1] ** 2)))
    h = float(_F32(math.sqrt(o2[0] ** 2 + o2[1] ** 2)))
    angle = _F32(float(_F32(math.atan2(o1[1], o1[0])) * _F32(180)) / math.pi)
    # OpenCV reports the angle in [-90, 0), relabelling the sides.
    while angle >= 0:
        w, h, angle = h, w, angle - _F32(90)
    while angle < -90:
        w, h, angle = h, w, angle + _F32(90)
    return w, h, float(angle)


def _long_side_angle(polygon: Polygon) -> Tuple[float, float]:
    """(rotate_angle_deg, long_side_ratio) from the polygon's minimum-area
    rectangle: the angle that ``rotate_trans_mat`` needs to bring the
    rectangle's long side to horizontal, as the JAX package derives it from
    ``cv2.minAreaRect`` (whose angle lies in (-90, 0])."""
    w, h, angle = _min_area_rect(polygon.points)
    if w < 1e-6 or h < 1e-6:
        return 0.0, 1.0
    if w >= h:
        long_ratio, edge_angle = w / h, angle
    else:
        long_ratio, edge_angle = h / w, angle - 90.0
    if edge_angle <= -90.0:
        edge_angle += 180.0
    return edge_angle, long_ratio


class TextRegionFlattener:
    def __init__(
        self,
        typical_long_side_ratio_min: float,
        text_region_polygon_dilate_ratio: float,
        image: np.ndarray,  # (H, W, 3) uint8 page
        text_region_polygons: Sequence[Polygon],
        core_gate_dilate_ratio: Optional[float] = None,
    ):
        """``core_gate_dilate_ratio``: when set, each region also carries a
        ``flattened_core_mask``, its own polygon dilated by this ratio and
        pushed through the same rotate/trim transform."""
        self.flattened_text_regions: List[FlattenedTextRegion] = []
        page_shape = image.shape[:2]

        for polygon in text_region_polygons:
            dilated = polygon.to_dilated_polygon(text_region_polygon_dilate_ratio)
            box = dilated.bounding_box().clamp_to(page_shape)
            if box.height < 2 or box.width < 2:
                box = polygon.bounding_box().clamp_to(page_shape)

            crop = box.extract(image)
            mask = dilated.to_relative_polygon(box.up, box.left).fill_mask(box.shape)
            core_mask = None
            if core_gate_dilate_ratio is not None:
                core = polygon.to_dilated_polygon(core_gate_dilate_ratio)
                core_mask = core.to_relative_polygon(box.up, box.left).fill_mask(box.shape)

            angle, long_ratio = _long_side_angle(polygon)
            is_typical = long_ratio >= typical_long_side_ratio_min
            # Only regions with a pronounced long side define an orientation.
            if not is_typical or abs(angle) < 1e-3:
                angle = 0.0

            if angle != 0.0:
                mat = rotate_trans_mat(angle, box.shape)
                new_h, new_w = rotated_shape(angle, box.shape)
                # The crop and its masks as channels of one warp: one
                # coordinate pass and one gather; each channel comes out as
                # it would warped alone.
                nc = crop.shape[2] if crop.ndim == 3 else 1
                planes = [crop.reshape(box.shape + (nc,)), mask[..., None]]
                planes += [core_mask[..., None]] if core_mask is not None else []
                warped = warp_affine(np.concatenate(planes, axis=2), mat, (new_w, new_h))
                rotated = warped[..., :nc].reshape(warped.shape[:2] + crop.shape[2:])
                rotated_mask = warped[..., nc]
                rotated_core = warped[..., nc + 1] if core_mask is not None else None
            else:
                rotated, rotated_mask, rotated_core = crop, mask, core_mask

            ys, xs = np.nonzero(rotated_mask)
            if len(ys) == 0:
                trimmed_box = Box.from_shape(rotated_mask.shape)
            else:
                trimmed_box = Box(int(ys.min()), int(ys.max()), int(xs.min()), int(xs.max()))

            flattened_image = trimmed_box.extract(rotated).copy()
            self.flattened_text_regions.append(
                FlattenedTextRegion(
                    text_region_polygon=polygon,
                    bounding_extended_box=box,
                    flattening_rotate_angle=angle,
                    rotated_trimmed_box=trimmed_box,
                    shape_before_resize=flattened_image.shape[:2],
                    flattened_image=flattened_image,
                    flattened_mask=trimmed_box.extract(rotated_mask).copy(),
                    is_typical=is_typical,
                    flattened_core_mask=(
                        trimmed_box.extract(rotated_core).copy()
                        if rotated_core is not None
                        else None
                    ),
                )
            )


def stack_flattened_text_regions(
    page_pad: int,
    flattened_text_regions_pad: int,
    flattened_text_regions: Sequence[FlattenedTextRegion],
) -> Tuple[np.ndarray, List[Box]]:
    """Shelf-pack regions into one image; returns (stacked_image, boxes)
    with boxes in the input order."""
    pad = flattened_text_regions_pad
    if not flattened_text_regions:
        side = max(2 * page_pad, 32)
        return np.zeros((side, side, 3), dtype=np.uint8), []

    widths = [r.width for r in flattened_text_regions]
    total_area = sum(r.height * r.width for r in flattened_text_regions)
    target_width = max(max(widths), int(math.sqrt(total_area) * 1.2))

    placements: List[Tuple[int, int]] = []  # (row index, x)
    rows: List[Tuple[int, int]] = []  # (row width cursor, row height)
    for region in flattened_text_regions:
        if not rows or rows[-1][0] + region.width > target_width:
            rows.append((0, 0))
        cursor, row_h = rows[-1]
        placements.append((len(rows) - 1, cursor))
        rows[-1] = (cursor + region.width + pad, max(row_h, region.height))

    row_tops: List[int] = []
    y = page_pad
    for _, row_h in rows:
        row_tops.append(y)
        y += row_h + pad
    total_h = y - pad + page_pad
    total_w = page_pad * 2 + max(
        placements[i][1] + flattened_text_regions[i].width
        for i in range(len(flattened_text_regions))
    )

    stacked = np.zeros((total_h, total_w, 3), dtype=np.uint8)
    boxes: List[Box] = []
    for region, (row_idx, x) in zip(flattened_text_regions, placements):
        top = row_tops[row_idx]
        left = page_pad + x
        box = Box(top, top + region.height - 1, left, left + region.width - 1)
        # Paste only masked pixels to limit bleed between regions.
        m = region.flattened_mask > 0
        box.extract(stacked)[m] = region.flattened_image[m]
        boxes.append(box)
    return stacked, boxes
