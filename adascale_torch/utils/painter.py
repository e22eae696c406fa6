"""Visualisation painter without OpenCV, on uint8 RGB arrays.

Counterpart of ``adascale/utils/painter.py`` (mask and score-map overlays,
polygons with their index, points, lines, file output), bit for bit with
its OpenCV 5.0 calls:

  * ``paint_mask`` / ``paint_score_map``: the same f32 blends and truncating
    casts; JET is the committed 256-colour table of ``applyColorMap``;
  * ``paint_polygons``: closed ``polylines`` (``data.geometry.draw_polyline``)
    and, with ``enable_index``, the index drawn by ``put_text``;
  * ``paint_points``: filled ``circle`` (``data.geometry._fill_circle``);
  * ``paint_lines``: ``line`` (``data.geometry.draw_line``) on a copy,
    blended back at ``alpha``;
  * ``put_text``: ``putText(..., FONT_HERSHEY_PLAIN, 1.0, colour)`` at
    thickness 1, which OpenCV 5.0 draws as anti-aliased glyph masks at whole
    pixels, each blended in turn as ``(b (255 - a) + c a + 127) // 255``; the
    masks, their offsets from the origin and the advances are the committed
    table (``painter_tables.npz``, written by
    ``tests/fixtures/torch_port/make_painter_tables.py``). Other scales,
    thicknesses and characters outside printable ASCII raise.

``to_file`` writes PNG (``utils/png.py``); the port writes no JPEG, so a
``.jpg`` or ``.jpeg`` path is written as ``.png`` beside it.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Iterable, Sequence, Tuple, Union

import numpy as np

from ..data.geometry import _fill_circle, draw_line, draw_polyline
from .png import write_png

Color = Union[str, Tuple[int, int, int]]

TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "painter_tables.npz")
FIRST_CHAR, LAST_CHAR = 32, 126

_COLORS = {
    "red": (255, 0, 0),
    "green": (0, 200, 0),
    "blue": (0, 0, 255),
    "yellow": (255, 210, 0),
    "cyan": (0, 200, 200),
    "magenta": (230, 0, 230),
    "white": (255, 255, 255),
    "black": (0, 0, 0),
}


def _rgb(color: Color) -> Tuple[int, int, int]:
    if isinstance(color, str):
        return _COLORS[color]
    return tuple(int(c) for c in color)  # type: ignore[return-value]


@functools.lru_cache(maxsize=None)
def tables() -> Dict[str, np.ndarray]:
    with np.load(TABLES) as f:
        return {k: f[k] for k in f.files}


def jet(values: np.ndarray) -> np.ndarray:
    """``applyColorMap(values, COLORMAP_JET)`` in RGB: uint8 (...) -> (..., 3)."""
    return tables()["jet"][np.asarray(values, np.uint8)]


def put_text(
    image: np.ndarray,
    text: str,
    origin: Tuple[int, int],
    color,
    font_scale: float = 1.0,
    thickness: int = 1,
) -> np.ndarray:
    """``cv2.putText(image, text, origin, FONT_HERSHEY_PLAIN, font_scale,
    color, thickness)`` in place on a uint8 (H, W) or (H, W, C) image, for
    ``font_scale`` 1.0 and ``thickness`` 1 (module docstring); ``origin`` is
    the text's bottom-left (x, y)."""
    if font_scale != 1.0:
        raise ValueError(f"put_text: font_scale {font_scale}; the glyph table holds scale 1.0 only")
    if thickness != 1:
        raise ValueError(f"put_text: thickness {thickness}; the glyph table holds thickness 1 only")
    t = tables()
    h, w = image.shape[:2]
    col = np.asarray(color, np.int32).reshape(-1)
    x = int(origin[0])
    for ch in text:
        k = ord(ch) - FIRST_CHAR
        if not 0 <= k <= LAST_CHAR - FIRST_CHAR:
            raise ValueError(f"put_text: {ch!r} is not printable ASCII, which the glyph table holds")
        gh, gw = (int(v) for v in t["shape"][k])
        y0, x0 = int(origin[1]) + int(t["offset"][k][0]), x + int(t["offset"][k][1])
        top, left, bottom, right = max(y0, 0), max(x0, 0), min(y0 + gh, h), min(x0 + gw, w)
        if bottom > top and right > left:
            alpha = t["alpha"][t["start"][k] : t["start"][k + 1]].reshape(gh, gw)
            a = alpha[top - y0 : bottom - y0, left - x0 : right - x0].astype(np.int32)
            region = image[top:bottom, left:right]
            if region.ndim == 3:
                a = a[..., None]
            region[...] = (region.astype(np.int32) * (255 - a) + col * a + 127) // 255
        x += int(t["advance"][k])
    return image


class Painter:
    def __init__(self, image: np.ndarray):
        self.image = np.ascontiguousarray(image.copy())

    def paint_mask(self, mask: np.ndarray, color: Color = "red", alpha: float = 0.5):
        m = np.asarray(mask) > 0
        overlay = self.image.astype(np.float32)
        overlay[m] = (1 - alpha) * overlay[m] + alpha * np.asarray(_rgb(color), np.float32)
        self.image = overlay.astype(np.uint8)
        return self

    def paint_score_map(self, score_map: np.ndarray, alpha: float = 0.5):
        sm = np.asarray(score_map, dtype=np.float32)
        denom = sm.max() if sm.max() > 0 else 1.0
        norm = np.clip(sm / denom * 255.0, 0, 255).astype(np.uint8)
        heat = jet(norm)
        blend = (1 - alpha) * self.image.astype(np.float32) + alpha * heat.astype(np.float32)
        self.image = blend.astype(np.uint8)
        return self

    def paint_polygons(
        self,
        polygons: Iterable,
        color: Union[Color, Sequence[Color]] = "red",
        thickness: int = 1,
        enable_index: bool = False,
    ):
        polygons = list(polygons)
        colors = [color] * len(polygons) if isinstance(color, (str, tuple)) else list(color)
        for idx, (poly, c) in enumerate(zip(polygons, colors)):
            pts = np.round(np.asarray(poly.points)).astype(np.int32)
            draw_polyline(self.image, pts, True, _rgb(c), thickness)
            if enable_index:
                origin = pts.min(axis=0)
                put_text(self.image, str(idx), (int(origin[0]), int(origin[1])), _rgb(c))
        return self

    def paint_points(self, points_xy: np.ndarray, color: Color = "green", radius: int = 2):
        for x, y in np.round(np.asarray(points_xy)).astype(int):
            _fill_circle(self.image, int(x), int(y), radius, _rgb(color))
        return self

    def paint_lines(
        self,
        lines: Sequence[Tuple[Tuple[float, float], Tuple[float, float]]],
        color: Union[Color, Sequence[Color]] = "red",
        thickness: int = 1,
        alpha: float = 1.0,
    ):
        canvas = self.image.copy()
        colors = [color] * len(lines) if isinstance(color, (str, tuple)) else list(color)
        for ((x0, y0), (x1, y1)), c in zip(lines, colors):
            draw_line(
                canvas,
                (int(round(x0)), int(round(y0))),
                (int(round(x1)), int(round(y1))),
                _rgb(c),
                thickness,
            )
        if alpha >= 1.0:
            self.image = canvas
        else:
            self.image = (
                (1 - alpha) * self.image.astype(np.float32) + alpha * canvas.astype(np.float32)
            ).astype(np.uint8)
        return self

    def to_file(self, path) -> str:
        """Write the image as PNG at ``path``, or beside it with the suffix
        ``.png`` where ``path`` ends in ``.jpg`` / ``.jpeg``; returns the path
        written."""
        path = str(path)
        stem, ext = os.path.splitext(path)
        if ext.lower() in (".jpg", ".jpeg"):
            path = stem + ".png"
        write_png(path, self.image)
        return path
