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
    0.955 straight and 1.3693 diagonal; no zero pixel gives FLT_MAX);
  * ``get_perspective_transform`` and ``perspective_transform`` follow
    OpenCV 5.0's ``getPerspectiveTransform`` (its f32 products, its LU
    solve in f64) and ``perspectiveTransform`` (f64) bit for bit;
    ``warp_perspective`` follows ``warpPerspective`` (INTER_LINEAR,
    BORDER_CONSTANT: the closed-form f64 inverse, source positions and
    bilinear weights in f32 with fused multiply-adds where its vector code
    fuses them), bit for bit on every column its vector loop covers: all of
    them when the width is a multiple of 32 (the flagship's 768-pixel
    pages); the last ``width % 32`` columns come from its scalar tail, whose
    order is not found yet (within 1 gray level, ROADMAP Queue 3 item 7);
  * ``draw_line`` and ``draw_polyline`` follow ``cv2.line`` and
    ``cv2.polylines`` with ``LINE_8`` bit for bit: at
    thickness 1 the 8-connected line of ``LineIterator``, clipped to the
    image; thicker, the segment clipped to the image grown by the thickness
    on every side, then ``ThickLine``: a convex quadrilateral in 16.16 fixed
    point (``FillConvexPoly``, its edges drawn by ``Line2``) and a filled
    circle on each end.

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


def _draw_line8(mask: np.ndarray, x0: int, y0: int, x1: int, y1: int, value=1) -> None:
    """8-connected Bresenham line as OpenCV's LineIterator draws it."""
    h, w = mask.shape[:2]
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
        mask[y0 + sy * i, x0 + m] = value
    else:
        mask[y0 + sy * m, x0 + i] = value


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


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line2(image: np.ndarray, x1: int, y1: int, x2: int, y2: int, value) -> None:
    """OpenCV's ``Line2``: an 8-connected line between 16.16 fixed-point
    ends, stepped along its major axis, clipped to the image."""
    h, w = image.shape[:2]
    ok, x1, y1, x2, y2 = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, x1, y1, x2, y2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if (dx < 0) if x_major else (dy < 0):
        x1, y1, x2, y2 = x2, y2, x1, y1
    if x_major:
        step = _trunc_div((y2 - y1) << _XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        step = _trunc_div((x2 - x1) << _XY_SHIFT, abs(dy) | 1)
        count = (y2 - y1) >> _XY_SHIFT
    half = _XY_ONE >> 1
    i = np.arange(count + 1, dtype=np.int64)
    if x_major:
        xs, ys = ((x1 + half) >> _XY_SHIFT) + i, (y1 + half + i * step) >> _XY_SHIFT
    else:
        xs, ys = (x1 + half + i * step) >> _XY_SHIFT, ((y1 + half) >> _XY_SHIFT) + i
    xs = np.append(xs, (x2 + half) >> _XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> _XY_SHIFT)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    image[ys[inside], xs[inside]] = value


def _fill_convex_poly(image: np.ndarray, pts: Sequence[Tuple[int, int]], value) -> None:
    """OpenCV's ``FillConvexPoly`` of 16.16 fixed-point vertices with
    ``LINE_8``: the edges by ``_line2``, then each scanline from the top
    vertex down between the two edges walked from it, each edge's x stepped
    by its rounded per-row slope and rounded to a pixel."""
    h, w = image.shape[:2]
    n = len(pts)
    half = _XY_ONE >> 1
    for k in range(n):
        _line2(image, *pts[k - 1], *pts[k], value)
    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
    top = min(range(n), key=lambda k: (ys[k], k))
    xmin, xmax = (min(xs) + half) >> _XY_SHIFT, (max(xs) + half) >> _XY_SHIFT
    ymin, ymax = (ys[top] + half) >> _XY_SHIFT, (max(ys) + half) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # Each edge: [vertex index, index step, x, dx, last row].
    edge = [[top, 1, -_XY_ONE, 0, ymin], [top, n - 1, -_XY_ONE, 0, ymin]]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0 = e[0]
            idx = (idx0 + e[1]) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (ys[idx] + half) >> _XY_SHIFT
                if ty > y:
                    e[0], e[2], e[4] = idx, xs[idx0], ty
                    e[3] = _trunc_div((xs[idx] - xs[idx0]) * 2 + (ty - y), 2 * (ty - y))
                    break
                idx0, idx = idx, (idx + e[1]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted((edge[0][2], edge[1][2]))
            x_a, x_b = (left + half) >> _XY_SHIFT, (right + half) >> _XY_SHIFT
            if x_b >= 0 and x_a < w:
                image[y, max(x_a, 0) : min(x_b, w - 1) + 1] = value
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _fill_circle(image: np.ndarray, cx: int, cy: int, radius: int, value) -> None:
    """OpenCV's ``Circle`` with ``fill``: horizontal spans of the midpoint
    circle, clipped to the image."""
    h, w = image.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and xa < w and xb >= 0:
                image[y, max(xa, 0) : min(xb, w - 1) + 1] = value
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_segment(image: np.ndarray, x0: int, y0: int, x1: int, y1: int, value, thickness: int,
                   caps: Tuple[bool, bool]) -> None:
    """OpenCV's ``ThickLine`` for integer ends and ``LINE_8`` at thickness >
    1: the segment clipped to the image grown by the thickness on every
    side, then a convex quadrilateral in 16.16 fixed point
    (``FillConvexPoly``, its edges drawn by ``Line2``) and a filled circle on
    each end that ``caps`` asks for (``flags`` bits 1 and 2)."""
    h, w = image.shape[:2]
    t = thickness
    ok, x0, y0, x1, y1 = _clip_line(w + 2 * t, h + 2 * t, x0 + t, y0 + t, x1 + t, y1 + t)
    if not ok:
        return
    x0, y0, x1, y1 = (v - t for v in (x0, y0, x1, y1))
    X0, Y0, X1, Y1 = (v << _XY_SHIFT for v in (x0, y0, x1, y1))
    dx, dy = (X0 - X1) / _XY_ONE, (Y1 - Y0) / _XY_ONE
    r = dx * dx + dy * dy
    half_width = t << (_XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half_width + (t & 1) * _XY_ONE * 0.5) / math.sqrt(r)
        # cvRound: half to even.
        px, py = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(image, [(X0 + px, Y0 + py), (X0 - px, Y0 - py), (X1 - px, Y1 - py), (X1 + px, Y1 + py)],
                          value)
    radius = (half_width + (_XY_ONE >> 1)) >> _XY_SHIFT
    for cap, (cx, cy) in zip(caps, ((x0, y0), (x1, y1))):
        if cap:
            _fill_circle(image, cx, cy, radius, value)


def draw_line(image: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], value, thickness: int = 1) -> None:
    """``cv2.line(image, p0, p1, (v, v, v), thickness)`` (``LINE_8``) for
    integer (x, y) ends, bit for bit (module docstring)."""
    (x0, y0), (x1, y1) = (int(v) for v in p0), (int(v) for v in p1)
    if thickness <= 1:
        _draw_line8(image, x0, y0, x1, y1, value)
        return
    _thick_segment(image, x0, y0, x1, y1, value, thickness, (True, True))


def draw_polyline(image: np.ndarray, points: np.ndarray, closed: bool, value, thickness: int = 1) -> None:
    """``cv2.polylines(image, [points], closed, value, thickness)``
    (``LINE_8``, no shift) for integer (x, y) points, bit for bit: OpenCV's
    ``PolyLine``, segment by segment from the last point to the first when
    ``closed``; thicker than 1 pixel, each segment by ``ThickLine``, capped
    at its end (and the first segment of an open line at its start too)."""
    pts = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    if not pts:
        return
    p0 = pts[-1] if closed else pts[0]
    for k in range(0 if closed else 1, len(pts)):
        p1 = pts[k]
        if thickness <= 1:
            _draw_line8(image, *p0, *p1, value)
        else:
            _thick_segment(image, *p0, *p1, value, thickness, (not closed and k == 1, True))
        p0 = p1


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


# ------------------------------------------------------------ perspective

def _solve_lu(a: List[List[float]], b: List[float]) -> List[float]:
    """``a x = b`` by OpenCV's ``hal::LU64f``: Gaussian elimination with
    partial pivoting on Python floats (f64, no fused multiply-add)."""
    m = len(b)
    a, b = [row[:] for row in a], b[:]
    for i in range(m):
        k = max(range(i, m), key=lambda j: (abs(a[j][i]), -j))
        if abs(a[k][i]) < 2.220446049250313e-16 * 10:
            raise ValueError("singular perspective system")
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for c in range(i + 1, m):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return b


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform(src, dst)``: the (3, 3) f64 homography
    taking the four f32 points ``src`` onto ``dst``. OpenCV forms the
    products ``src * dst`` in f32 before the f64 solve."""
    src = np.asarray(src, np.float32).reshape(4, 2)
    dst = np.asarray(dst, np.float32).reshape(4, 2)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        (sx, sy), (dx, dy) = src[i], dst[i]
        a[i][0] = a[i + 4][3] = float(sx)
        a[i][1] = a[i + 4][4] = float(sy)
        a[i][2] = a[i + 4][5] = 1.0
        a[i][6] = float(-(sx * dx))
        a[i][7] = float(-(sy * dx))
        a[i + 4][6] = float(-(sx * dy))
        a[i + 4][7] = float(-(sy * dy))
        b[i], b[i + 4] = float(dx), float(dy)
    return np.asarray(_solve_lu(a, b) + [1.0], np.float64).reshape(3, 3)


def perspective_transform(points: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """``cv2.perspectiveTransform`` of f32 (N, 2) points: f64 arithmetic,
    the division as a product with ``1 / w``, f32 out."""
    p = np.asarray(points, np.float32).reshape(-1, 2).astype(np.float64)
    m = np.asarray(mat, np.float64).reshape(-1)
    x, y = p[:, 0], p[:, 1]
    inv_w = 1.0 / (x * m[6] + y * m[7] + m[8])
    out = np.stack([(x * m[0] + y * m[1] + m[2]) * inv_w, (x * m[3] + y * m[4] + m[5]) * inv_w], axis=1)
    return out.astype(np.float32)


def _invert3(mat: np.ndarray) -> np.ndarray:
    """``cv2.invert`` of a 3x3 f64 matrix (DECOMP_LU): OpenCV's closed form,
    the adjugate times ``1 / det``."""
    m = [[float(v) for v in row] for row in np.asarray(mat, np.float64)]
    det = (
        m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
        - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
        + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0])
    )
    if det == 0.0:
        raise ValueError("singular homography")
    d = 1.0 / det
    return np.asarray(
        [
            (m[1][1] * m[2][2] - m[1][2] * m[2][1]) * d,
            (m[0][2] * m[2][1] - m[0][1] * m[2][2]) * d,
            (m[0][1] * m[1][2] - m[0][2] * m[1][1]) * d,
            (m[1][2] * m[2][0] - m[1][0] * m[2][2]) * d,
            (m[0][0] * m[2][2] - m[0][2] * m[2][0]) * d,
            (m[0][2] * m[1][0] - m[0][0] * m[1][2]) * d,
            (m[1][0] * m[2][1] - m[1][1] * m[2][0]) * d,
            (m[0][1] * m[2][0] - m[0][0] * m[2][1]) * d,
            (m[0][0] * m[1][1] - m[0][1] * m[1][0]) * d,
        ],
        np.float64,
    ).reshape(3, 3)


def fma_f32(a, b, c) -> np.ndarray:
    """``a * b + c`` on f32 operands (broadcast together) with one rounding
    to f32, as a fused multiply-add gives it. The product of two f32 values
    is exact in f64, so rounding the f64 sum again to f32 is right except
    where that sum lands exactly halfway between two f32 values (its 29 low
    fraction bits ``1 << 28``) and was itself rounded: there the sum's
    rounding error (TwoSum) picks the neighbour."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    p = np.multiply(a, b, dtype=np.float64)
    s = np.add(p, c, dtype=np.float64)
    r = s.astype(np.float32)
    halfway = np.flatnonzero((s.view(np.uint64) & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28))
    if halfway.size:
        at = np.unravel_index(halfway, s.shape)
        pi, ci, si = np.broadcast_to(p, s.shape)[at], np.broadcast_to(c, s.shape)[at], s[at]
        bb = si - pi
        err = (pi - (si - bb)) + (ci - bb)
        off = np.flatnonzero(err)
        if off.size:
            r[tuple(v[off] for v in at)] = np.nextafter(si[off], np.copysign(np.inf, err[off])).astype(np.float32)
    return r


def warp_perspective(
    img: np.ndarray, mat: np.ndarray, out_wh: Tuple[int, int], border_value: int = 0
) -> np.ndarray:
    """``cv2.warpPerspective(img, mat, out_wh, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=(v, v, v))`` on uint8 (H, W) or
    (H, W, C), bit for bit with OpenCV 5.0.

    ``mat`` maps source to destination; it is inverted in f64 and rounded to
    f32. For destination pixel (x, y) the source position is
    ``fma(M0, x, y*M1 + M2) / fma(M6, x, y*M7 + M8)`` in f32 (likewise
    y); the four taps (the border value outside the image) are blended as
    ``fma(a, p01 - p00, p00)``, ``fma(a, p11 - p10, p10)``, then
    ``fma(b, v1 - v0, v0)``, and rounded half to even. That is OpenCV's
    vector loop; on its scalar tail, the last ``width % 32`` columns of a
    width that is not a multiple of 32, a pixel may differ by 1."""
    m = _invert3(mat).astype(np.float32).reshape(-1)
    ow, oh = out_wh
    xs = np.arange(ow, dtype=np.float32)[None, :]
    ys = np.arange(oh, dtype=np.float32)[:, None]
    row_x, row_y, row_w = ys * m[1] + m[2], ys * m[4] + m[5], ys * m[7] + m[8]
    w = fma_f32(m[6], xs, row_w)
    sx = fma_f32(m[0], xs, row_x) / w
    sy = fma_f32(m[3], xs, row_y) / w
    return bilinear_fma(img, sx, sy, border_value)


def bilinear_fma(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border_value: int = 0) -> np.ndarray:
    """The bilinear gather of OpenCV 5.0's warp vector loops on uint8 (H, W)
    or (H, W, C): for f32 source positions ``(sx, sy)`` (out_h, out_w), the
    four taps (``border_value`` outside the image) blended as
    ``fma(a, p01 - p00, p00)``, ``fma(a, p11 - p10, p10)``, then
    ``fma(b, v1 - v0, v0)``, rounded half to even."""
    fx, fy = np.floor(sx), np.floor(sy)
    a, b = (sx - fx)[..., None], (sy - fy)[..., None]
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    # A border two pixels wide: a tap pair whose left (upper) tap lies
    # left of -1 or right of w - 1 is border on both taps, so clipping the
    # pair's start to [-2, w] keeps every tap's value and makes one gather.
    padded = np.full((h + 4, w + 4, src.shape[2]), border_value, src.dtype)
    padded[2:-2, 2:-2] = src
    flat = padded.reshape(-1, src.shape[2])
    ix = np.clip(fx.astype(np.int64), -2, w) + 2
    iy = np.clip(fy.astype(np.int64), -2, h) + 2
    i00 = iy * (w + 4) + ix
    p00, p01 = (np.take(flat, i00 + d, axis=0).astype(np.float32) for d in (0, 1))
    p10, p11 = (np.take(flat, i00 + d, axis=0).astype(np.float32) for d in (w + 4, w + 5))
    if np.all((a == 0) | (a >= 2.0**-21)):
        # Each such a is a multiple of 2^-44, so a * d + p with whole |d|,
        # p < 2^8 needs at most 53 bits: exact in f64, rounded once to f32.
        a64 = a.astype(np.float64)
        v0 = (a64 * (p01 - p00) + p00).astype(np.float32)
        v1 = (a64 * (p11 - p10) + p10).astype(np.float32)
    else:
        v0 = fma_f32(a, p01 - p00, p00)
        v1 = fma_f32(a, p11 - p10, p10)
    v = fma_f32(b, v1 - v0, v0)
    out = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out.reshape(sx.shape + img.shape[2:])
