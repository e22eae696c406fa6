"""Write the shift pages' glyph atlas, ``adascale_torch/data/shift_atlas.npz``.

The JAX package's ``adascale/tools/shift_fixtures.py`` draws single
characters of three DejaVu fonts with PIL (``ImageDraw.text`` at integer
positions, sizes 18-53, the characters of its ``CHARS``), records each
glyph's ``textbbox`` and steps the pen by its ``textlength``. At an integer
position PIL draws the same alpha mask wherever the glyph lands, blended
into the L-mode page by its ``BLEND`` macro, ``DIV255(page (255 - a) + ink
a)`` with ``DIV255(t) = (u + (u >> 8)) >> 8``, ``u = t + 128``. The port
carries those masks as data, so it needs no PIL or font files:

  * ``alpha``: every mask flat, glyph k at ``start[k]:start[k + 1]``,
    shaped ``shape[k]`` (rows, columns);
  * ``offset``: where ``getmask2`` puts the mask's corner relative to the
    text position (x, y);
  * ``bbox``: ``textbbox((0, 0), ch)`` (left, top, right, bottom);
  * ``advance``: ``textlength(ch)`` (f64);

glyph k = (font * len(SIZES) + size - SIZES[0]) * len(CHARS) + the
character's index in ``CHARS``; ``fonts``, ``sizes`` and ``chars`` name the
keys.

This script is not part of the port: it imports PIL and the JAX package and
reads the system's DejaVu fonts. Run it from the repository's root after a
change of the JAX tool's fonts, sizes or characters, or of Pillow (a few
seconds on the CPU):

    python tests/fixtures/torch_port/make_shift_atlas.py

``tests/test_torch_shift_fixtures.py`` regenerates a sample of the atlas and
compares it byte for byte.
"""
import os
import sys

import numpy as np
from PIL import Image, ImageDraw, ImageFont

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, ROOT)

from adascale.tools.shift_fixtures import CHARS, FONTS  # noqa: E402

OUT = os.path.join(ROOT, "adascale_torch", "data", "shift_atlas.npz")
SIZES = tuple(range(18, 54))  # the JAX tool's rng.integers(18, 54)


def glyph(font: ImageFont.FreeTypeFont, ch: str):
    """(mask, offset, bbox, advance) of ``ch`` drawn at an integer position."""
    draw = ImageDraw.Draw(Image.new("L", (1, 1)))
    core, offset = font.getmask2(ch, "L", start=(0.0, 0.0))
    mask = np.asarray(Image.Image()._new(core), np.uint8).reshape(core.size[1], core.size[0])
    return mask, tuple(offset), draw.textbbox((0, 0), ch, font=font), float(draw.textlength(ch, font=font))


def build_atlas(keys=None):
    """The atlas over every (font, size, char) key, or over ``keys``."""
    if keys is None:
        keys = [(f, s, c) for f in range(len(FONTS)) for s in SIZES for c in CHARS]
    fonts = {}
    glyphs = []
    for f, s, c in keys:
        if (f, s) not in fonts:
            fonts[f, s] = ImageFont.truetype(FONTS[f], size=s)
        glyphs.append(glyph(fonts[f, s], c))
    sizes = [g[0].size for g in glyphs]
    return {
        "fonts": np.asarray([os.path.basename(p) for p in FONTS]),
        "sizes": np.asarray(SIZES, np.int32),
        "chars": np.asarray(CHARS),
        "alpha": np.concatenate([g[0].reshape(-1) for g in glyphs]).astype(np.uint8),
        "start": np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        "shape": np.asarray([g[0].shape for g in glyphs], np.int32),
        "offset": np.asarray([g[1] for g in glyphs], np.int32),
        "bbox": np.asarray([g[2] for g in glyphs], np.int32),
        "advance": np.asarray([g[3] for g in glyphs], np.float64),
    }


if __name__ == "__main__":
    atlas = build_atlas()
    np.savez_compressed(OUT, **atlas)
    print(f"{OUT}: {len(atlas['advance'])} glyphs, {atlas['alpha'].size} alpha values, "
          f"{os.path.getsize(OUT)} bytes")
