"""Synthetic OCR pages and their char labels, without OpenCV.

Counterpart of ``adascale/data/synth.py``. A page is glyph-textured char
quadrilaterals in (optionally rotated) text lines on a noisy paper
background, with ruled lines, table grids, a vignette and a mild whole-page
homography; its labels are the char mask, the char-height map, the
per-char gaussian heatmap and the per-char regression labels the precise
pass trains on.

Everything flows from a numpy ``Generator``, drawn call for call as the JAX
package draws it, so a (seed, run_idx) pair gives the same page in both
packages. Pixels come from the native renderer (``adascale_torch.native``)
and its glyph tiles from the committed atlas ``glyph_atlas.npz`` (made from
the JAX package's ``cv2.putText`` tiles by
``tests/fixtures/torch_port/make_glyph_atlas.py``); the rest of the page
uses the OpenCV twins of ``data/geometry.py``.

``render_backend``: ``"native"`` and ``"auto"`` draw with the native
renderer (``"auto"`` never falls back). ``"python"`` (the default, as in the
JAX package) draws in numpy as the JAX package's per-char OpenCV path does:
strokes by ``geometry.draw_line`` (``cv2.line``'s twin, bit for bit at both
thicknesses) and each glyph tile warped into its char's box by
``geometry.warp_perspective`` and blended over the page. The warps are
mostly narrower than 32 pixels, so most of their columns come from
``warpPerspective``'s scalar tail, which the twin follows only within one
gray level (ROADMAP Queue 3 item 7): a page's image may differ from the JAX
package's by a few gray levels on a small share of its pixels, its labels
not at all.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .geometry import (
    Box,
    draw_line,
    fill_poly,
    get_perspective_transform,
    perspective_transform,
    warp_perspective,
)

@dataclasses.dataclass(frozen=True)
class SynthPageConfig:
    """Generator knobs (the role of the reference's steps-JSON); the same
    fields and defaults as the JAX package's."""

    page_height: int = 1024
    page_width: int = 1024
    num_lines_min: int = 8
    num_lines_max: int = 18
    char_height_min: int = 14
    char_height_max: int = 64
    char_aspect_min: float = 0.45
    char_aspect_max: float = 1.0
    char_gap_ratio: float = 0.18
    line_rotate_prob: float = 0.35
    line_rotate_max_deg: float = 25.0
    background_gray_min: int = 180
    background_gray_max: int = 250
    noise_sigma: float = 8.0
    ink_gray_max: int = 90
    gaussian_sigma_ratio: float = 0.25
    glyph_stroke_prob: float = 0.25
    block_lines_max: int = 5
    line_spacing_min: float = 1.15
    line_spacing_max: float = 1.7
    perspective_prob: float = 0.3
    perspective_max_ratio: float = 0.02
    ruled_line_prob: float = 0.3
    table_prob: float = 0.15
    vignette_prob: float = 0.4
    # "python" (numpy, the JAX package's per-char path), or "native" / "auto"
    # (the same here: the native renderer).
    render_backend: str = "python"


@dataclasses.dataclass
class CharInstance:
    """One character: quadrilateral corners (4, 2) float32 (x, y) in page
    coords, ordered up-left, up-right, down-right, down-left; height in page
    pixels."""

    corners: np.ndarray
    height: float

    @property
    def center(self) -> np.ndarray:
        return self.corners.mean(axis=0)


@dataclasses.dataclass
class TextLine:
    chars: List[CharInstance]
    char_height: float

    def bounding_box(self) -> Box:
        pts = np.concatenate([c.corners for c in self.chars], axis=0)
        return Box(
            up=int(pts[:, 1].min()),
            down=int(math.ceil(pts[:, 1].max())),
            left=int(pts[:, 0].min()),
            right=int(math.ceil(pts[:, 0].max())),
        )


@dataclasses.dataclass
class SynthPage:
    image: np.ndarray  # (H, W, 3) uint8
    chars: List[CharInstance]
    lines: List[TextLine]
    config: SynthPageConfig


_GLYPH_CHARS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789?!&@#%$=+"
# OpenCV's Hershey font ids: SIMPLEX, DUPLEX, COMPLEX, TRIPLEX, PLAIN,
# SIMPLEX | ITALIC.
_GLYPH_FONTS = (0, 2, 3, 4, 1, 16)
ATLAS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "glyph_atlas.npz")


class GlyphAtlas:
    """The committed glyph tiles, (T, 32, 32) uint8 alpha, and each
    (glyph, font, thickness) key's index among them."""

    def __init__(self, path: str = ATLAS_PATH):
        with np.load(path) as data:
            self.tiles = np.ascontiguousarray(data["tiles"])
            keys = zip(data["glyphs"].tolist(), data["fonts"].tolist(), data["thicknesses"].tolist())
            self.ids = {key: i for i, key in enumerate(keys)}

    def tile_id(self, glyph: str, font: int, thickness: int) -> int:
        return self.ids[(glyph, font, thickness)]


@functools.lru_cache(maxsize=1)
def glyph_atlas() -> GlyphAtlas:
    """The atlas, read once a process."""
    return GlyphAtlas()


def _glyph_commands(corners: np.ndarray, rng: np.random.Generator, ink: int, stroke_prob: float) -> list:
    """All random decisions for texturing one char quad -> draw commands.

    The rng call order is load-bearing: a (seed, run_idx) pair names a
    sample in both packages, so it draws exactly what the JAX package's
    ``_glyph_commands`` draws, in the same order.

    Commands: ("line", thickness, p0_xy, p1_xy, ink) with endpoints already
    rounded to ints, or ("glyph", (glyph, font, thickness), corners, ink).
    """
    cmds = []
    if rng.uniform() < stroke_prob:
        # Strokes (non-letter marks: logos, CJK-ish scribbles, symbols).
        ul, ur, dr, dl = corners
        num_strokes = int(rng.integers(2, 5))
        for _ in range(num_strokes):
            a, b = rng.uniform(size=(2, 2))
            p0 = ul + a[0] * (ur - ul) + a[1] * (dl - ul)
            p1 = ul + b[0] * (ur - ul) + b[1] * (dl - ul)
            thickness = max(1, int(rng.integers(1, 3)))
            cmds.append(("line", thickness, np.round(p0).astype(int), np.round(p1).astype(int), ink))
        # Connect the strokes with a light diagonal so components stay joined.
        cmds.append(("line", 1, np.round(ul).astype(int), np.round(dr).astype(int), ink))
        return cmds
    glyph = _GLYPH_CHARS[int(rng.integers(0, len(_GLYPH_CHARS)))]
    font = _GLYPH_FONTS[int(rng.integers(0, len(_GLYPH_FONTS)))]
    thickness = int(rng.integers(1, 3))
    cmds.append(("glyph", (glyph, font, thickness), corners, ink))
    return cmds


def _raster_commands_native(image: np.ndarray, cmds: list) -> None:
    """One C++ call executes the whole page's ordered command buffer."""
    from .. import native

    atlas = glyph_atlas()
    n = len(cmds)
    types = np.empty(n, np.int32)
    aux = np.empty(n, np.int32)
    inks = np.empty(n, np.uint8)
    geo = np.zeros((n, 8), np.float32)
    for i, cmd in enumerate(cmds):
        if cmd[0] == "line":
            _, thickness, p0, p1, ink = cmd
            types[i] = 1
            aux[i] = thickness
            inks[i] = ink
            geo[i, :4] = (p0[0], p0[1], p1[0], p1[1])
        else:
            _, key, corners, ink = cmd
            types[i] = 0
            aux[i] = atlas.tile_id(*key)
            inks[i] = ink
            geo[i] = corners.reshape(-1)
    native.execute_draw_buffer(image, types, aux, inks, geo, atlas.tiles)


_TILE = 32  # the atlas's tiles are _TILE x _TILE
_TILE_CORNERS = np.asarray([[0, 0], [_TILE, 0], [_TILE, _TILE], [0, _TILE]], dtype=np.float32)


def _raster_commands_python(image: np.ndarray, cmds: list) -> None:
    """The JAX package's ``_raster_commands_python`` in numpy: each command
    in order, a line by ``draw_line``, a glyph tile warped into the ROI of
    its char's box (clamped to the page; skipped under 2 pixels a side) and
    blended over it as ``roi * (1 - a) + ink * a`` in f32, clipped and
    truncated to uint8."""
    atlas = glyph_atlas()
    for cmd in cmds:
        if cmd[0] == "line":
            _, thickness, p0, p1, ink = cmd
            draw_line(image, tuple(p0), tuple(p1), ink, thickness)
            continue
        _, key, corners, ink = cmd
        xs, ys = corners[:, 0], corners[:, 1]
        x0 = max(0, int(math.floor(xs.min())))
        y0 = max(0, int(math.floor(ys.min())))
        x1 = min(image.shape[1], int(math.ceil(xs.max())) + 1)
        y1 = min(image.shape[0], int(math.ceil(ys.max())) + 1)
        if x1 - x0 < 2 or y1 - y0 < 2:
            continue
        dst = (corners - np.asarray([[x0, y0]], dtype=np.float32)).astype(np.float32)
        mat = get_perspective_transform(_TILE_CORNERS, dst)
        alpha = warp_perspective(atlas.tiles[atlas.tile_id(*key)], mat, (x1 - x0, y1 - y0)).astype(np.float32) / 255.0
        roi = image[y0:y1, x0:x1].astype(np.float32)
        blended = roi * (1.0 - alpha[..., None]) + float(ink) * alpha[..., None]
        image[y0:y1, x0:x1] = np.clip(blended, 0, 255).astype(np.uint8)


def check_backend(backend: str) -> None:
    """``"python"``, ``"native"`` and ``"auto"`` pass; anything else is a
    ValueError."""
    if backend not in ("python", "native", "auto"):
        raise ValueError(f"unknown render_backend {backend!r}")


def _draw_background_artifacts(image: np.ndarray, config: SynthPageConfig, rng: np.random.Generator) -> None:
    """Ruled lines / light table grids / vignette — document-texture
    variety the detector must learn to ignore."""
    h, w = image.shape[:2]
    if rng.uniform() < config.vignette_prob:
        gy = rng.uniform(-25, 25)
        gx = rng.uniform(-25, 25)
        ramp = (
            np.linspace(0, 1, h, dtype=np.float32)[:, None] * gy
            + np.linspace(0, 1, w, dtype=np.float32)[None, :] * gx
        )
        image[:] = np.clip(image.astype(np.float32) + ramp[..., None], 0, 255).astype(np.uint8)
    if rng.uniform() < config.ruled_line_prob:
        gray = int(rng.integers(140, 210))
        spacing = int(rng.integers(24, 64))
        offset = int(rng.integers(0, spacing))
        for y in range(offset, h, spacing):
            draw_line(image, (0, y), (w - 1, y), gray)
    if rng.uniform() < config.table_prob:
        gray = int(rng.integers(120, 190))
        x0 = int(rng.integers(0, w // 2))
        y0 = int(rng.integers(0, h // 2))
        x1 = int(rng.integers(x0 + w // 4, w))
        y1 = int(rng.integers(y0 + h // 4, h))
        cols = int(rng.integers(2, 6))
        rows = int(rng.integers(2, 6))
        for i in range(cols + 1):
            x = x0 + (x1 - x0) * i // cols
            draw_line(image, (x, y0), (x, y1), gray)
        for j in range(rows + 1):
            y = y0 + (y1 - y0) * j // rows
            draw_line(image, (x0, y), (x1, y), gray)


def _apply_page_perspective(
    image: np.ndarray,
    chars: List[CharInstance],
    config: SynthPageConfig,
    rng: np.random.Generator,
    bg: int,
) -> np.ndarray:
    """Mild whole-page homography: warps pixels and char corners
    consistently (the role of vkit's page-distortion steps)."""
    h, w = image.shape[:2]
    j = config.perspective_max_ratio
    src = np.asarray([[0, 0], [w, 0], [w, h], [0, h]], dtype=np.float32)
    dst = src + rng.uniform(-j, j, size=(4, 2)).astype(np.float32) * np.asarray([[w, h]], dtype=np.float32)
    mat = get_perspective_transform(src, dst)
    warped = warp_perspective(image, mat, (w, h), bg)
    for char in chars:
        char.corners = perspective_transform(char.corners, mat)
        # Keep the height label consistent with the warped geometry.
        char.height = float(np.linalg.norm(char.corners[3] - char.corners[0]))
    return warped


def generate_page(config: SynthPageConfig, rng: np.random.Generator) -> SynthPage:
    check_backend(config.render_backend)
    h, w = config.page_height, config.page_width
    bg = int(rng.integers(config.background_gray_min, config.background_gray_max + 1))
    image = np.full((h, w, 3), bg, dtype=np.uint8)
    noise = rng.normal(0.0, config.noise_sigma, size=(h, w, 1))
    image = np.clip(image.astype(np.float32) + noise, 0, 255).astype(np.uint8)
    _draw_background_artifacts(image, config, rng)
    draw_buffer: list = []

    lines: List[TextLine] = []
    chars: List[CharInstance] = []

    num_lines = int(rng.integers(config.num_lines_min, config.num_lines_max + 1))
    lines_left = num_lines
    while lines_left > 0:
        # One paragraph block: consistent char height / angle / ink, lines
        # stacked along the block normal.
        block_lines = int(rng.integers(1, min(config.block_lines_max, lines_left) + 1))
        ch = float(rng.uniform(config.char_height_min, config.char_height_max))
        angle = 0.0
        if rng.uniform() < config.line_rotate_prob:
            angle = float(rng.uniform(-config.line_rotate_max_deg, config.line_rotate_max_deg))
        rad = math.radians(angle)
        # y-down coords; positive angle rotates the line downwards to the right.
        direction = np.asarray([math.cos(rad), math.sin(rad)], dtype=np.float32)
        normal = np.asarray([-math.sin(rad), math.cos(rad)], dtype=np.float32)
        spacing = ch * float(rng.uniform(config.line_spacing_min, config.line_spacing_max))
        ink = int(rng.integers(10, config.ink_gray_max))

        line_len = float(rng.uniform(0.3, 0.9)) * w
        x0 = float(rng.uniform(0, max(1.0, w - line_len)))
        # Blocks may start anywhere; lines that fall off-page are clipped by
        # the per-char bounds check below.
        y0 = float(rng.uniform(ch + 4, max(ch + 5.0, h - ch - 4)))
        block_origin = np.asarray([x0, y0], dtype=np.float32)

        for line_idx in range(block_lines):
            origin = block_origin + spacing * line_idx * normal
            line_chars: List[CharInstance] = []
            cursor = 0.0
            while cursor < line_len:
                cw = ch * float(rng.uniform(config.char_aspect_min, config.char_aspect_max))
                ul = origin + cursor * direction
                ur = origin + (cursor + cw) * direction
                dl = ul + ch * normal
                dr = ur + ch * normal
                corners = np.stack([ul, ur, dr, dl]).astype(np.float32)
                # Word gaps: occasionally skip a slot.
                advance = cw * (1.0 + config.char_gap_ratio)
                if rng.uniform() < 0.12:
                    cursor += advance * float(rng.uniform(1.2, 2.2))
                    continue
                cursor += advance
                if (
                    corners[:, 0].min() < 0
                    or corners[:, 1].min() < 0
                    or corners[:, 0].max() >= w
                    or corners[:, 1].max() >= h
                ):
                    continue
                draw_buffer.extend(_glyph_commands(corners, rng, ink, config.glyph_stroke_prob))
                line_chars.append(CharInstance(corners=corners, height=ch))
            if line_chars:
                lines.append(TextLine(chars=line_chars, char_height=ch))
                chars.extend(line_chars)
            lines_left -= 1
            if lines_left <= 0:
                break

    if draw_buffer:
        if config.render_backend == "python":
            _raster_commands_python(image, draw_buffer)
        else:
            _raster_commands_native(image, draw_buffer)

    if rng.uniform() < config.perspective_prob:
        image = _apply_page_perspective(image, chars, config, rng, bg)

    return SynthPage(image=image, chars=chars, lines=lines, config=config)


def render_char_labels(
    chars: Sequence[CharInstance],
    shape: Tuple[int, int],
    downsample_factor: int,
    gaussian_sigma_ratio: float = 0.25,
    backend: str = "python",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render (downsampled) label maps for chars given in *crop* coords.

    Returns (char_mask, char_height_map, char_gaussian_map), each of shape
    ``(shape[0] // f, shape[1] // f)``. Heights are painted in crop-pixel
    units (the unit the rough pass regresses); the gaussian peaks at 1.0 at
    each char center. ``backend`` "native" / "auto" rasterise in C++;
    "python" in numpy, the quads by ``fill_poly`` (``cv2.fillPoly``'s twin),
    with the same result as the JAX package's "python" branch.
    """
    f = downsample_factor
    dh, dw = shape[0] // f, shape[1] // f
    if backend in ("native", "auto"):
        from .. import native

        if not chars:
            return (np.zeros((dh, dw), np.uint8), np.zeros((dh, dw), np.float32), np.zeros((dh, dw), np.float32))
        quads = np.stack([c.corners / f for c in chars]).astype(np.float32)
        heights = np.asarray([c.height for c in chars], np.float32)
        centers = np.stack([c.center / f for c in chars]).astype(np.float32)
        sigmas = np.maximum(0.7, gaussian_sigma_ratio * heights / f).astype(np.float32)
        return native.render_labels_native((dh, dw), quads, heights, centers, sigmas)
    if backend != "python":
        raise ValueError(f"unknown backend {backend!r}")
    mask = np.zeros((dh, dw), dtype=np.uint8)
    height_map = np.zeros((dh, dw), dtype=np.float32)
    gaussian = np.zeros((dh, dw), dtype=np.float32)

    for char in chars:
        corners_d = char.corners / f
        pts = np.round(corners_d).astype(np.int32)
        quad = np.zeros((dh, dw), dtype=np.uint8)
        fill_poly(quad, pts)
        mask[quad > 0] = 1
        height_map[quad > 0] = np.float32(char.height)

        center = char.center / f
        sigma = max(0.7, gaussian_sigma_ratio * char.height / f)
        radius = int(math.ceil(3 * sigma))
        cx, cy = center
        x0, x1 = max(0, int(cx) - radius), min(dw, int(cx) + radius + 1)
        y0, y1 = max(0, int(cy) - radius), min(dh, int(cy) + radius + 1)
        if x0 >= x1 or y0 >= y1:
            continue
        ys = np.arange(y0, y1, dtype=np.float32)[:, None]
        xs = np.arange(x0, x1, dtype=np.float32)[None, :]
        blob = np.exp(-(((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 * sigma * sigma)))
        region = gaussian[y0:y1, x0:x1]
        np.maximum(region, blob, out=region)

    return mask, height_map, gaussian


def char_regression_label(
    char: CharInstance,
    downsample_factor: int,
    downsampled_shape: Tuple[int, int],
) -> Optional[Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]]:
    """Build the per-char regression label, crop coords.

    Returns (label_point_y, label_point_x, up_left_offsets (2,),
    angle_distribution (4,), distances (4,)) or None if degenerate.

    Conventions (they invert exactly under inference's polar
    reconstruction):
      * label point = char center in the downsampled grid (int);
      * the point's position in crop pixels is ``point * f``;
      * offsets = up_left_corner - upsampled_point, (y, x) order;
      * angles: clockwise fractions of 2*pi between consecutive corner
        directions seen from the point; distances: euclidean, corner order
        up-left, up-right, down-right, down-left.
    """
    f = downsample_factor
    dh, dw = downsampled_shape
    center = char.center
    py = int(round(center[1] / f))
    px = int(round(center[0] / f))
    if not (0 <= py < dh and 0 <= px < dw):
        return None
    point = np.asarray([px * f, py * f], dtype=np.float32)  # (x, y)

    deltas = char.corners - point[None, :]  # (4, 2) (dx, dy)
    distances = np.linalg.norm(deltas, axis=1).astype(np.float32)
    if np.any(distances < 1e-3):
        return None

    thetas = np.mod(np.arctan2(deltas[:, 1], deltas[:, 0]), 2 * np.pi)
    diffs = np.mod(np.roll(thetas, -1) - thetas, 2 * np.pi)
    if not np.isclose(diffs.sum(), 2 * np.pi, atol=1e-3):
        # Point outside the quad; angles do not wind once around.
        return None
    angle_distribution = (diffs / (2 * np.pi)).astype(np.float32)

    up_left_offsets = np.asarray([deltas[0, 1], deltas[0, 0]], dtype=np.float32)  # (y, x)
    return py, px, up_left_offsets, angle_distribution, distances
