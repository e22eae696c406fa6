"""Write the port's glyph atlas, ``adascale_torch/data/glyph_atlas.npz``.

The native renderer blends glyphs from pre-rasterised 32x32 alpha tiles.
The JAX package draws each tile with ``cv2.putText``
(``adascale/data/synth.py::_glyph_tile``); the port carries them as data, so
it needs no text renderer and no OpenCV. The tiles are a fixed function of
(glyph, font, thickness): 71 glyphs x 6 Hershey fonts x 2 thicknesses = 852
tiles, stored in that key order (glyph outermost, thickness innermost) with
the key table beside them.

This script is not part of the port: it imports the JAX package and cv2.
Run it from the repository's root after a change to the JAX package's
glyph set, fonts or tile size (a few seconds on the CPU):

    python tests/fixtures/torch_port/make_glyph_atlas.py

``tests/test_torch_synth.py`` holds the committed atlas against
``_glyph_tile`` for every key.
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, ROOT)

from adascale.data.synth import _GLYPH_CHARS, _GLYPH_FONTS, _glyph_tile  # noqa: E402

OUT = os.path.join(ROOT, "adascale_torch", "data", "glyph_atlas.npz")
THICKNESSES = (1, 2)


def build_atlas():
    keys = [(g, f, t) for g in _GLYPH_CHARS for f in _GLYPH_FONTS for t in THICKNESSES]
    tiles = np.stack([_glyph_tile(g, f, t) for g, f, t in keys])
    return {
        "tiles": tiles,
        "glyphs": np.asarray([g for g, _, _ in keys]),
        "fonts": np.asarray([f for _, f, _ in keys], np.int32),
        "thicknesses": np.asarray([t for _, _, t in keys], np.int32),
    }


if __name__ == "__main__":
    atlas = build_atlas()
    np.savez_compressed(OUT, **atlas)
    print(f"{OUT}: {atlas['tiles'].shape} tiles, {os.path.getsize(OUT)} bytes")
