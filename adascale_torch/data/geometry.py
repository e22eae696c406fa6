"""Host-side geometry in numpy and scipy: boxes, polygons, rasterisation,
mask -> polygons and the rotation used by region flattening.

Counterpart of ``adascale/data/geometry.py`` without OpenCV:

  * ``Polygon.fill_mask`` follows ``cv2.fillPoly`` (8-connected edges, no
    shift) on the rounded integer vertices: every edge is drawn as a
    Bresenham line and the scanlines between sorted edge crossings are
    filled, with edge positions in 16.16 fixed point as OpenCV keeps them;
  * ``mask_to_disconnected_polygons`` follows ``cv2.findContours`` with
    ``RETR_EXTERNAL`` + ``CHAIN_APPROX_SIMPLE``: 8-connected components
    (``scipy.ndimage.label``), components inside another's hole dropped, the
    outer border of each traced by Suzuki-Abe border following, only the
    points where the chain direction changes kept, and the polygons returned
    in OpenCV's order (reverse raster order of their first pixel);
  * ``rotate_trans_mat`` builds ``cv2.getRotationMatrix2D`` in closed form;
  * ``distance_transform_l2_3x3`` follows ``cv2.distanceTransform(m,
    cv2.DIST_L2, 3)``: OpenCV's two-pass 3x3 chamfer in f32 (a step costs
    0.955 straight and 1.3693 diagonal; no zero pixel gives FLT_MAX).

Conventions: images are (H, W, ...) arrays; polygon points are float32
(N, 2) in (x, y) order; boxes are inclusive (slice up:down+1, left:right+1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


@dataclasses.dataclass(frozen=True)
class Box:
    up: int
    down: int
    left: int
    right: int

    @property
    def height(self) -> int:
        return self.down + 1 - self.up

    @property
    def width(self) -> int:
        return self.right + 1 - self.left

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @classmethod
    def from_shape(cls, shape: Tuple[int, int]) -> "Box":
        return cls(0, shape[0] - 1, 0, shape[1] - 1)

    def extract(self, mat: np.ndarray) -> np.ndarray:
        return mat[self.up : self.down + 1, self.left : self.right + 1]

    def to_resized_box(self, from_shape: Tuple[int, int], to_shape: Tuple[int, int]) -> "Box":
        ry = to_shape[0] / from_shape[0]
        rx = to_shape[1] / from_shape[1]
        return Box(
            up=int(round(self.up * ry)),
            down=int(round(self.down * ry)),
            left=int(round(self.left * rx)),
            right=int(round(self.right * rx)),
        )

    def clamp_to(self, shape: Tuple[int, int]) -> "Box":
        return Box(
            max(0, self.up),
            min(shape[0] - 1, self.down),
            max(0, self.left),
            min(shape[1] - 1, self.right),
        )


# ------------------------------------------------------------ rasterisation

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine``: returns (inside, x1, y1, x2, y2); the second
    endpoint's clip uses the already clipped first one, as OpenCV does."""
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _draw_line8(mask: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> None:
    """8-connected Bresenham line as OpenCV's LineIterator draws it."""
    h, w = mask.shape
    if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
        ok, x0, y0, x1, y1 = _clip_line(w, h, x0, y0, x1, y1)
        if not ok:
            return
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    # Minor-axis offset after i steps: the count of steps taken with err < 0,
    # err_0 = major - 2 minor, err += 2 major (minor step) - 2 minor.
    i = np.arange(major + 1, dtype=np.int64)
    m = (2 * minor * i + major - 1) // (2 * major) if major else np.zeros_like(i)
    if vert:
        mask[y0 + sy * i, x0 + m] = 1
    else:
        mask[y0 + sy * m, x0 + i] = 1


def fill_poly(mask: np.ndarray, pts: np.ndarray) -> None:
    """``cv2.fillPoly(mask, [pts], 1)`` for integer (x, y) vertices.

    Each edge is drawn as an 8-connected line. An edge with an end outside
    the image takes its scanline positions from the clipped segment (a
    segment clipped to one row is treated as vertical). Scanline spans run
    from the ceiling of the left crossing to the floor of the right one."""
    h, w = mask.shape
    pts = np.asarray(pts, dtype=np.int64).reshape(-1, 2)
    edges = []  # (y0, y1, x at y0 in 16.16 fixed point, dx per row)
    tmp = np.zeros(mask.shape, dtype=np.uint8)
    for k in range(len(pts)):
        x0, y0 = (int(v) for v in pts[k - 1])
        x1, y1 = (int(v) for v in pts[k])
        _draw_line8(tmp, x0, y0, x1, y1)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            _, c0x, c0y, c1x, c1y = _clip_line(w, h, x0, y0, x1, y1)
        if y0 == y1:
            continue
        num, den = (c1x - c0x) << _XY_SHIFT, c1y - c0y
        dx = 0 if den == 0 else abs(num) // abs(den) * (1 if (num >= 0) == (den > 0) else -1)
        if y0 < y1:
            edges.append((y0, y1, (c0x << _XY_SHIFT) + (y0 - c0y) * dx, dx))
        else:
            edges.append((y1, y0, (c1x << _XY_SHIFT) + (y1 - c1y) * dx, dx))
    if len(edges) >= 2:
        e = np.asarray(edges, dtype=np.int64)
        ey0, ey1, ex, edx = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
        for y in range(max(int(ey0.min()), 0), min(int(ey1.max()), h)):
            active = (ey0 <= y) & (y < ey1)
            xs = np.sort(ex[active] + (y - ey0[active]) * edx[active])
            lefts = (xs[0::2] + _XY_ONE - 1) >> _XY_SHIFT
            for a, b in zip(lefts, xs[1::2] >> _XY_SHIFT):
                if a < w and b >= 0:
                    tmp[y, max(int(a), 0) : min(int(b), w - 1) + 1] = 1
    mask[tmp > 0] = 1


@dataclasses.dataclass
class Polygon:
    """Simple polygon; points float32 (N, 2) in (x, y) order. ``score`` is an
    optional detection confidence used for NMS ordering."""

    points: np.ndarray
    score: Optional[float] = None

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float32).reshape(-1, 2)

    @property
    def xs(self) -> np.ndarray:
        return self.points[:, 0]

    @property
    def ys(self) -> np.ndarray:
        return self.points[:, 1]

    def bounding_box(self) -> Box:
        return Box(
            up=int(math.floor(float(self.ys.min()))),
            down=int(math.ceil(float(self.ys.max()))),
            left=int(math.floor(float(self.xs.min()))),
            right=int(math.ceil(float(self.xs.max()))),
        )

    def to_conducted_resized_polygon(
        self, from_shape: Tuple[int, int], to_shape: Tuple[int, int]
    ) -> "Polygon":
        ry = to_shape[0] / from_shape[0]
        rx = to_shape[1] / from_shape[1]
        return Polygon(self.points * np.asarray([rx, ry], dtype=np.float32), score=self.score)

    def to_shifted_polygon(self, offset_y: float, offset_x: float) -> "Polygon":
        return Polygon(
            self.points + np.asarray([offset_x, offset_y], dtype=np.float32), score=self.score
        )

    def to_relative_polygon(self, origin_y: float, origin_x: float) -> "Polygon":
        return self.to_shifted_polygon(-origin_y, -origin_x)

    def to_dilated_polygon(self, ratio: float) -> "Polygon":
        """Scale points away from the centroid by (1 + ratio)."""
        center = self.points.mean(axis=0, keepdims=True)
        return Polygon(center + (self.points - center) * (1.0 + ratio), score=self.score)

    def fill_mask(self, shape: Tuple[int, int]) -> np.ndarray:
        """Rasterize to a uint8 mask of ``shape`` (cv2.fillPoly rule on the
        rounded vertices)."""
        mask = np.zeros(shape, dtype=np.uint8)
        fill_poly(mask, np.round(self.points).astype(np.int64))
        return mask

    def extract_score_map_values(self, score_map: np.ndarray) -> np.ndarray:
        """Values of ``score_map`` inside the polygon (flat array)."""
        return score_map[self.fill_mask(score_map.shape[:2]) > 0]

    def area(self) -> float:
        x, y = self.xs, self.ys
        return float(abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))) / 2.0


# ------------------------------------------------------------ mask -> polygons

# Chain codes (dx, dy): 0 right, 1 up-right, 2 up, ..., 7 down-right.
_CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)


def _trace_outer_border(img: np.ndarray, y: int, x: int) -> List[Tuple[int, int]]:
    """Outer border from its first raster pixel (y, x) of the zero-framed
    binary ``img``, compressed as CHAIN_APPROX_SIMPLE compresses it."""

    def nz(py: int, px: int, s: int) -> bool:
        return img[py + _CODE_DY[s], px + _CODE_DX[s]] != 0

    s = s_end = 4
    while True:
        s = (s - 1) & 7
        if nz(y, x, s) or s == s_end:
            break
    if s == s_end:
        return [(x, y)]
    y1, x1 = y + _CODE_DY[s], x + _CODE_DX[s]
    points: List[Tuple[int, int]] = []
    prev_s = s ^ 4
    cy, cx = y, x
    while True:
        start = s
        while True:
            s += 1
            if nz(cy, cx, s & 7) or s >= start + 8:
                break
        s &= 7
        if s != prev_s:
            points.append((cx, cy))
            prev_s = s
        ny, nx = cy + _CODE_DY[s], cx + _CODE_DX[s]
        if (ny, nx) == (y, x) and (cy, cx) == (y1, x1):
            break
        cy, cx = ny, nx
        s = (s + 4) & 7
    return points


def mask_to_disconnected_polygons(mask: np.ndarray, min_area: float = 1.0) -> List[Polygon]:
    """Connected components of a binary mask -> external contour polygons."""
    img = np.pad((np.asarray(mask) > 0).astype(np.uint8), 1)
    labels, count = ndimage.label(img, structure=np.ones((3, 3), dtype=bool))
    if count == 0:
        return []
    background, _ = ndimage.label(img == 0)  # 4-connected holes and outside
    outside = background[0, 0]
    starts = []
    for k, sl in enumerate(ndimage.find_objects(labels), start=1):
        y = sl[0].start
        x = sl[1].start + int(np.argmax(labels[y, sl[1]] == k))
        if background[y - 1, x] == outside:
            starts.append((y, x))
    polygons: List[Polygon] = []
    for y, x in sorted(starts, reverse=True):
        contour = _trace_outer_border(img, y, x)
        if len(contour) < 3:
            continue
        poly = Polygon(np.asarray(contour, dtype=np.float32) - 1.0)
        if poly.area() >= min_area:
            polygons.append(poly)
    return polygons


# ------------------------------------------------------------ affine

def rotate_trans_mat(angle_deg: float, shape: Tuple[int, int]) -> np.ndarray:
    """(2, 3) affine matrix rotating an image of ``shape`` by ``angle_deg``
    counter-clockwise about its centre, with the canvas expanded to the
    rotated bounds (``cv2.getRotationMatrix2D`` in closed form)."""
    h, w = shape
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    rad = math.radians(angle_deg)
    alpha, beta = math.cos(rad), math.sin(rad)
    mat = np.asarray(
        [
            [alpha, beta, (1 - alpha) * cx - beta * cy],
            [-beta, alpha, beta * cx + (1 - alpha) * cy],
        ],
        dtype=np.float64,
    )
    cos, sin = abs(alpha), abs(beta)
    new_w = int(h * sin + w * cos + 0.5)
    new_h = int(h * cos + w * sin + 0.5)
    mat[0, 2] += (new_w - 1) / 2.0 - cx
    mat[1, 2] += (new_h - 1) / 2.0 - cy
    return mat.astype(np.float32)


def rotated_shape(angle_deg: float, shape: Tuple[int, int]) -> Tuple[int, int]:
    h, w = shape
    rad = math.radians(angle_deg)
    cos, sin = abs(math.cos(rad)), abs(math.sin(rad))
    return (int(h * cos + w * sin + 0.5), int(h * sin + w * cos + 0.5))


def affine_polygons(trans_mat: np.ndarray, polygons: Sequence[Polygon]) -> List[Polygon]:
    """Apply a (2, 3) or (3, 3) affine matrix to polygons."""
    mat = np.asarray(trans_mat, dtype=np.float32)
    if mat.shape == (2, 3):
        mat = np.vstack([mat, np.asarray([[0.0, 0.0, 1.0]], dtype=np.float32)])
    out: List[Polygon] = []
    for poly in polygons:
        pts = np.concatenate(
            [poly.points, np.ones((len(poly.points), 1), dtype=np.float32)], axis=1
        )
        out.append(Polygon((pts @ mat.T)[:, :2], score=poly.score))
    return out


# ------------------------------------------------------ distance transform

_CHAMFER_STRAIGHT = np.float32(0.955)
_CHAMFER_DIAGONAL = np.float32(1.3693)


def _chamfer_pass(init: np.ndarray) -> np.ndarray:
    """One raster-order chamfer pass: ``d[i, j] = min(init[i, j],
    d[i-1, j-1] + diag, d[i-1, j] + hv, d[i-1, j+1] + diag, d[i, j-1] + hv)``
    in f32, outside the image FLT_MAX. Pixel (i, j) needs only pixels of
    smaller ``2 i + j``, so each such anti-diagonal is one vector step."""
    h, w = init.shape
    big = np.finfo(np.float32).max
    d = np.full((h + 1, w + 2), big, np.float32)  # one row above, a column each side
    d[1:, 1:-1] = init
    for t in range(2 * (h - 1) + w):
        i = np.arange(max(0, (t - w + 2) // 2), min(h - 1, t // 2) + 1)
        j = t - 2 * i + 1  # columns in the padded array
        r = i + 1
        best = np.minimum(d[r - 1, j - 1] + _CHAMFER_DIAGONAL, d[r - 1, j] + _CHAMFER_STRAIGHT)
        best = np.minimum(best, d[r - 1, j + 1] + _CHAMFER_DIAGONAL)
        best = np.minimum(best, d[r, j - 1] + _CHAMFER_STRAIGHT)
        d[r, j] = np.minimum(d[r, j], best)
    return d[1:, 1:-1]


def distance_transform_l2_3x3(mask: np.ndarray) -> np.ndarray:
    """f32 distance of every pixel to the nearest zero pixel of ``mask``
    (H, W), as ``cv2.distanceTransform(mask, cv2.DIST_L2, 3)`` computes it:
    a forward pass from the top left, then a backward pass from the bottom
    right over its result, both with the same f32 sums OpenCV takes."""
    init = np.where(mask == 0, np.float32(0.0), np.finfo(np.float32).max).astype(np.float32)
    forward = _chamfer_pass(init)
    return np.ascontiguousarray(_chamfer_pass(forward[::-1, ::-1].copy())[::-1, ::-1])
