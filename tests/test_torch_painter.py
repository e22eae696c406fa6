"""The port's painter (``adascale_torch/utils/painter.py``) against the JAX
package's cv2-based one, bit for bit on shared seeded inputs: every method,
the JET table over all 256 values against ``cv2.applyColorMap``, and
``put_text`` against ``cv2.putText`` at integer origins inside the image
and across its border. The committed glyph and colour tables are
regenerated in part by their fixture script and compared byte for byte."""
import importlib.util
import os

import numpy as np
import pytest

from adascale.data.geometry import Polygon as JaxPolygon
from adascale.utils.painter import Painter as JaxPainter
from adascale_torch.data.geometry import Polygon
from adascale_torch.utils import painter as P
from adascale_torch.utils.png import read_png_bytes

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRINTABLE = [chr(c) for c in range(32, 127)]


def _fixture_script():
    path = os.path.join(ROOT, "tests", "fixtures", "torch_port", "make_painter_tables.py")
    spec = importlib.util.spec_from_file_location("make_painter_tables", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_jet_table_equals_apply_color_map():
    values = np.arange(256, dtype=np.uint8)
    want = cv2.applyColorMap(values[:, None], cv2.COLORMAP_JET)[:, 0, ::-1]
    np.testing.assert_array_equal(P.jet(values), want)


def test_committed_tables_regenerate_byte_for_byte():
    chars = "0123456789 |AgW~"
    fresh = _fixture_script().build_tables(chars)
    t = P.tables()
    np.testing.assert_array_equal(fresh["jet"], t["jet"])
    for i, ch in enumerate(chars):
        k = ord(ch) - P.FIRST_CHAR
        got = t["alpha"][t["start"][k] : t["start"][k + 1]].tobytes()
        assert got == fresh["alpha"][fresh["start"][i] : fresh["start"][i + 1]].tobytes(), ch
        assert tuple(t["shape"][k]) == tuple(fresh["shape"][i]), ch
        assert tuple(t["offset"][k]) == tuple(fresh["offset"][i]), ch
        assert t["advance"][k] == fresh["advance"][i], ch


def _text_case(rng, inside):
    text = "".join(rng.choice(PRINTABLE, int(rng.integers(1, 8))))
    h, w = int(rng.integers(20, 60)), int(rng.integers(20, 90))
    width = sum(int(P.tables()["advance"][ord(c) - 32]) for c in text)
    if inside:
        w = max(w, width + 4)
        org = (int(rng.integers(1, w - width - 2)), int(rng.integers(15, h - 4)))
    else:
        org = (int(rng.integers(-30, w + 5)), int(rng.integers(-5, h + 20)))
    channels = int(rng.choice([1, 3]))
    image = rng.integers(0, 256, (h, w, channels) if channels == 3 else (h, w)).astype(np.uint8)
    color = tuple(int(v) for v in rng.integers(0, 256, channels))
    return text, org, image, color


@pytest.mark.parametrize("inside", [True, False], ids=["inside", "border"])
def test_put_text_equals_cv2(inside):
    rng = np.random.default_rng(int(inside))
    for _ in range(300):
        text, org, image, color = _text_case(rng, inside)
        want = image.copy()
        cv2.putText(want, text, org, cv2.FONT_HERSHEY_PLAIN, 1.0, color)
        got = P.put_text(image.copy(), text, org, color)
        np.testing.assert_array_equal(got, want, err_msg=f"{text!r} at {org}")


@pytest.mark.parametrize(
    "kwargs,match", [({"font_scale": 1.5}, "font_scale"), ({"thickness": 2}, "thickness"), ({}, "ASCII")]
)
def test_put_text_refuses_what_the_table_lacks(kwargs, match):
    text = "7" if kwargs else "é"
    with pytest.raises(ValueError, match=match):
        P.put_text(np.zeros((20, 20, 3), np.uint8), text, (2, 15), (255, 0, 0), **kwargs)


def _image(rng, h=61, w=83):
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


def _polygons(rng, n, h, w):
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 8))
        c = rng.uniform(-5, [w + 5, h + 5])
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(2, 25)
        out.append(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1).astype(np.float32))
    return out


def _methods(rng, image):
    """(name, call on a painter) pairs with shared seeded arguments."""
    h, w = image.shape[:2]
    mask = rng.random((h, w)) < 0.3
    score = (rng.random((h, w)) * rng.uniform(0.1, 40)).astype(np.float32)
    polys = _polygons(rng, 6, h, w)
    points = rng.uniform(-3, [w + 3, h + 3], (20, 2))
    lines = [(tuple(rng.uniform(-5, w + 5, 2)), tuple(rng.uniform(-5, h + 5, 2))) for _ in range(12)]
    palette = ["green", "yellow", "red", (12, 200, 77)]
    colors = [palette[int(i)] for i in rng.integers(0, len(palette), len(lines))]
    return {
        "mask": lambda p, poly: p.paint_mask(mask, color="cyan", alpha=0.35),
        "score_map": lambda p, poly: p.paint_score_map(score),
        "score_map_alpha1": lambda p, poly: p.paint_score_map(score, alpha=1.0),
        "score_map_zero": lambda p, poly: p.paint_score_map(np.zeros_like(score)),
        "polygons": lambda p, poly: p.paint_polygons([poly(q) for q in polys]),
        "polygons_index": lambda p, poly: p.paint_polygons([poly(q) for q in polys], enable_index=True),
        "polygons_colors_thick": lambda p, poly: p.paint_polygons(
            [poly(q) for q in polys], color=["red", "blue"] * 3, thickness=2, enable_index=True
        ),
        "points": lambda p, poly: p.paint_points(points),
        "points_radius": lambda p, poly: p.paint_points(points, color="magenta", radius=4),
        "lines": lambda p, poly: p.paint_lines(lines, color=colors),
        "lines_alpha": lambda p, poly: p.paint_lines(lines, color=colors, thickness=1, alpha=0.8),
        "lines_thick": lambda p, poly: p.paint_lines(lines, color="white", thickness=3, alpha=0.5),
    }


METHODS = list(_methods(np.random.default_rng(0), np.zeros((8, 8, 3), np.uint8)))


@pytest.mark.parametrize("name", METHODS)
def test_method_equals_the_jax_painter(name):
    for seed in range(3):
        rng = np.random.default_rng([seed, METHODS.index(name)])
        image = _image(rng, int(rng.integers(40, 90)), int(rng.integers(40, 120)))
        call = _methods(np.random.default_rng(seed), image)[name]
        want = call(JaxPainter(image), JaxPolygon).image
        got = call(P.Painter(image), Polygon).image
        np.testing.assert_array_equal(got, want)


def test_to_file_writes_png(tmp_path):
    image = _image(np.random.default_rng(5))
    written = P.Painter(image).to_file(tmp_path / "viz.jpg")
    assert written == str(tmp_path / "viz.png") and not (tmp_path / "viz.jpg").exists()
    with open(written, "rb") as f:
        np.testing.assert_array_equal(read_png_bytes(f.read()), image)
    assert P.Painter(image).to_file(tmp_path / "a.png") == str(tmp_path / "a.png")
