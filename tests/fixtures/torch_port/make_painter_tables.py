"""Write the painter's tables, ``adascale_torch/utils/painter_tables.npz``.

The JAX package's painter (``adascale/utils/painter.py``) colours score maps
with ``cv2.applyColorMap(..., COLORMAP_JET)`` and writes polygon indices with
``cv2.putText(..., FONT_HERSHEY_PLAIN, 1.0, colour)``. The port carries both
as data, so it needs no OpenCV:

  * ``jet``: the 256 RGB colours of the JET map;
  * the glyphs of printable ASCII (32-126): OpenCV 5.0 draws this font as
    anti-aliased alpha masks at whole-pixel positions, one glyph after the
    other, each blended into the image as ``(b (255 - a) + c a + 127) //
    255``. For each glyph the table holds its alpha mask (``alpha``, all
    masks flat, glyph k at ``start[k]:start[k + 1]``, shaped ``shape[k]``),
    the mask's top-left corner relative to the text origin (``offset``, rows
    then columns) and the pen's advance to the next glyph (``advance``).

This script is not part of the port: it imports cv2. Run it from the
repository's root after a change of OpenCV (a second on the CPU):

    python tests/fixtures/torch_port/make_painter_tables.py

``tests/test_torch_painter.py`` regenerates a sample of the table and
compares it byte for byte.
"""
import os

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
OUT = os.path.join(ROOT, "adascale_torch", "utils", "painter_tables.npz")
FIRST, LAST = 32, 126
FONT = cv2.FONT_HERSHEY_PLAIN
ORIGIN = (40, 60)  # (x, y): far enough from every edge of CANVAS for any glyph
CANVAS = (100, 160)
FOLLOWER = "|"  # drawn after a glyph to find its advance


def jet_table() -> np.ndarray:
    """(256, 3) uint8 RGB: ``applyColorMap`` of 0..255, BGR reversed."""
    return cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)[:, 0, ::-1].copy()


def _render(text: str) -> np.ndarray:
    canvas = np.zeros(CANVAS, np.uint8)
    cv2.putText(canvas, text, ORIGIN, FONT, 1.0, 255)
    return canvas


def glyph_stamp(ch: str):
    """(alpha mask, (row, column) offset of its corner from the origin)."""
    canvas = _render(ch)
    ys, xs = np.nonzero(canvas)
    if not len(ys):
        return np.zeros((0, 0), np.uint8), (0, 0)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    return canvas[y0:y1, x0:x1].copy(), (int(y0 - ORIGIN[1]), int(x0 - ORIGIN[0]))


def _blend(canvas: np.ndarray, alpha: np.ndarray, offset, x: int) -> None:
    y0, x0 = ORIGIN[1] + offset[0], x + offset[1]
    b = canvas[y0 : y0 + alpha.shape[0], x0 : x0 + alpha.shape[1]].astype(np.int32)
    a = alpha.astype(np.int32)
    canvas[y0 : y0 + alpha.shape[0], x0 : x0 + alpha.shape[1]] = (b * (255 - a) + 255 * a + 127) // 255


def glyph_advance(ch: str) -> int:
    """The pen's step after ``ch``: the shift at which the glyph and a
    following ``FOLLOWER``, blended in turn, give ``putText(ch + FOLLOWER)``."""
    want = _render(ch + FOLLOWER)
    alpha, offset = glyph_stamp(ch)
    f_alpha, f_offset = glyph_stamp(FOLLOWER)
    for k in range(0, 40):
        got = np.zeros(CANVAS, np.uint8)
        if alpha.size:
            _blend(got, alpha, offset, ORIGIN[0])
        _blend(got, f_alpha, f_offset, ORIGIN[0] + k)
        if np.array_equal(got, want):
            return k
    raise RuntimeError(f"no advance reproduces putText({ch!r} + {FOLLOWER!r})")


def build_tables(chars=None):
    chars = [chr(c) for c in range(FIRST, LAST + 1)] if chars is None else list(chars)
    stamps = [glyph_stamp(ch) for ch in chars]
    sizes = [a.size for a, _ in stamps]
    return {
        "jet": jet_table(),
        "alpha": np.concatenate([a.reshape(-1) for a, _ in stamps]).astype(np.uint8),
        "start": np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        "shape": np.asarray([a.shape for a, _ in stamps], np.int32).reshape(-1, 2),
        "offset": np.asarray([o for _, o in stamps], np.int32).reshape(-1, 2),
        "advance": np.asarray([glyph_advance(ch) for ch in chars], np.int32),
    }


if __name__ == "__main__":
    tables = build_tables()
    np.savez_compressed(OUT, **tables)
    print(f"{OUT}: {len(tables['advance'])} glyphs, {tables['alpha'].size} alpha values, "
          f"{os.path.getsize(OUT)} bytes")
