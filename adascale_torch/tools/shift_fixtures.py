"""Render the distribution-shift fixture pages: real-font documents, with
no PIL or OpenCV.

Counterpart of ``adascale/tools/shift_fixtures.py``, with its seed, sizes,
random draws and output layout: paragraphs of DejaVu Sans / Serif / Mono
characters with their exact ground-truth quadrilaterals, a small page
rotation, a vignette, sensor noise and a JPEG round trip at quality 70,
saved as ``.npz`` for ``eval_checkpoint --shift``. The JAX tool's library
calls become:

  * PIL's glyphs (``ImageDraw.text`` at integer positions, ``textbbox``,
    ``textlength``): the committed atlas ``data/shift_atlas.npz`` (written
    by ``tests/fixtures/torch_port/make_shift_atlas.py``), each glyph's
    alpha mask blended into the L-mode page in draw order with PIL's integer
    ``BLEND`` (``DIV255(page (255 - a) + ink a)``);
  * ``cv2.getRotationMatrix2D``: ``rotation_matrix_2d``; ``cv2.warpAffine``
    (INTER_LINEAR, the page's background as the border):
    ``inference/flatten.py::warp_affine``, bit for bit at the page's width
    (a multiple of 32);
  * ``cv2.imencode(".jpg", quality 70)`` + ``cv2.imdecode(GRAYSCALE)``:
    ``utils/jpeg.py::round_trip_gray``, libjpeg's integer DCTs.

The pages equal the JAX tool's bit for bit (``tests/test_torch_shift_fixtures.py``).

Usage:
  python -m adascale_torch.tools.shift_fixtures [--out tests/fixtures/shift_pages]
      [--num-pages 3] [--seed 20260817]
"""
from __future__ import annotations

import argparse
import functools
import math
import os
from typing import Dict, List, Tuple

import numpy as np

from ..inference.flatten import warp_affine
from ..utils.jpeg import round_trip_gray

ATLAS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "shift_atlas.npz")
NUM_FONTS = 3  # DejaVu Sans, Serif, Sans Mono: the JAX tool's FONTS
# The JAX tool's CHARS: full-bodied glyphs only.
CHARS = "".join(
    c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789" if c not in "iljI1"
)


@functools.lru_cache(maxsize=None)
def atlas() -> Dict[str, np.ndarray]:
    with np.load(ATLAS) as f:
        out = {k: f[k] for k in f.files}
    if str(out["chars"]) != CHARS or len(out["fonts"]) != NUM_FONTS:
        raise ValueError(f"{ATLAS}: its keys do not match the tool's characters and fonts")
    return out


def glyph_index(font: int, size: int, ch: str) -> int:
    sizes = atlas()["sizes"]
    return (font * len(sizes) + size - int(sizes[0])) * len(CHARS) + CHARS.index(ch)


def draw_glyph(page: np.ndarray, k: int, x: int, y: int, ink: int) -> None:
    """``ImageDraw.text((x, y), ch, font=font, fill=ink)`` of glyph ``k`` on
    an L-mode page, in place (module docstring)."""
    a = atlas()
    gh, gw = (int(v) for v in a["shape"][k])
    x0, y0 = x + int(a["offset"][k][0]), y + int(a["offset"][k][1])
    top, left, bottom, right = max(y0, 0), max(x0, 0), min(y0 + gh, page.shape[0]), min(x0 + gw, page.shape[1])
    if bottom <= top or right <= left:
        return
    mask = a["alpha"][a["start"][k] : a["start"][k + 1]].reshape(gh, gw)
    m = mask[top - y0 : bottom - y0, left - x0 : right - x0].astype(np.int32)
    t = page[top:bottom, left:right].astype(np.int32) * (255 - m) + ink * m + 128
    page[top:bottom, left:right] = ((t >> 8) + t) >> 8


def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) f64, the centre as f32."""
    cx, cy = (float(np.float32(v)) for v in center)
    rad = angle * (math.pi / 180)
    alpha, beta = math.cos(rad) * scale, math.sin(rad) * scale
    return np.asarray(
        [[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64
    )


def _draw_text(rng: np.random.Generator, page_h: int, page_w: int):
    """The JAX tool's text layout: (L-mode page, background, corners, heights)."""
    a = atlas()
    bg = int(rng.integers(200, 245))
    page = np.full((page_h, page_w), bg, np.uint8)
    font = int(rng.integers(NUM_FONTS))
    corners: List[np.ndarray] = []
    heights: List[float] = []
    y = int(rng.integers(30, 70))
    while True:
        size = int(rng.integers(18, 54))
        line_gap = int(size * float(rng.uniform(1.25, 1.8)))
        if y + line_gap + 30 > page_h:
            break
        x = int(rng.integers(25, 60))
        n_words = int(rng.integers(3, 9))
        ink = int(rng.integers(10, 100))
        for _ in range(n_words):
            word_len = int(rng.integers(2, 9))
            for _ in range(word_len):
                ch = CHARS[int(rng.integers(len(CHARS)))]
                k = glyph_index(font, size, ch)
                l, t, r, b = (int(v) for v in a["bbox"][k] + np.asarray([x, y, x, y]))
                if r >= page_w - 20:
                    x = page_w  # line full
                    break
                draw_glyph(page, k, x, y, ink)
                corners.append(np.asarray([[l, t], [r, t], [r, b], [l, b]], dtype=np.float32))
                heights.append(float(b - t))
                x += int(a["advance"][k]) + int(rng.integers(0, 3))
            x += int(size * 0.5)
            if x >= page_w - 60:
                break
        y += line_gap
    return page, bg, np.stack(corners).astype(np.float32), heights


def _degrade(rng: np.random.Generator, page: np.ndarray, bg: int, quads: np.ndarray):
    """Skew, vignette and noise, before the JPEG round trip: (page, quads)."""
    page_h, page_w = page.shape
    angle = float(rng.uniform(-3.0, 3.0))
    mat = rotation_matrix_2d((page_w / 2, page_h / 2), angle, 1.0)
    arr = warp_affine(page, mat, (page_w, page_h), border_value=bg)
    flat = quads.reshape(-1, 2)
    flat = flat @ mat[:, :2].T + mat[:, 2]
    quads = flat.reshape(-1, 4, 2).astype(np.float32)
    yy, xx = np.mgrid[0:page_h, 0:page_w].astype(np.float32)
    vignette = 1.0 - 0.15 * np.hypot((yy / page_h) - 0.5, (xx / page_w) - 0.5)
    arr = arr.astype(np.float32) * vignette
    arr = arr + rng.normal(0.0, 6.0, size=arr.shape)
    return np.clip(arr, 0, 255).astype(np.uint8), quads


def _render_page(
    rng: np.random.Generator, page_h: int = 1024, page_w: int = 768
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (image uint8 (H, W, 3), corners float32 (N, 4, 2) xy, heights (N,))."""
    page, bg, quads, heights = _draw_text(rng, page_h, page_w)
    arr, quads = _degrade(rng, page, bg, quads)
    arr = round_trip_gray(arr, 70)
    # Engine contract is (H, W, 3) uint8 (SynthPage.image).
    arr = np.repeat(arr[:, :, None], 3, axis=2)
    return arr, quads, np.asarray(heights, dtype=np.float32)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="tests/fixtures/shift_pages")
    parser.add_argument("--num-pages", type=int, default=3)
    parser.add_argument("--seed", type=int, default=20260817)
    args = parser.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    for i in range(args.num_pages):
        image, quads, heights = _render_page(np.random.default_rng([args.seed, i]))
        path = os.path.join(args.out, f"page_{i}.npz")
        np.savez_compressed(path, image=image, corners=quads, heights=heights)
        print(f"{path}: {image.shape}, {len(quads)} chars")


if __name__ == "__main__":
    main()
