"""The port's synthetic pages (``adascale_torch/data/synth.py``), its native
renderer and the OpenCV twins they use, against the JAX package and cv2 on
the CPU. Every bar is bit-equality but the one on the warp's scalar tail:

  * the committed glyph atlas equals ``_glyph_tile`` (cv2.putText) for all
    852 (glyph, font, thickness) keys;
  * ``get_perspective_transform``, ``perspective_transform`` and
    ``warp_perspective`` equal cv2's on random quads, pages and points (the
    warp at widths that are multiples of 32; at other widths its last
    ``w % 32`` columns, OpenCV's scalar tail, are held within 1 on <= 0.3 %
    of their values, ROADMAP Queue 3 item 7);
    ``draw_line`` equals ``cv2.line`` at thickness 1 on axis lines (the
    ruled lines and tables); ``fma_f32``
    equals exact rational arithmetic rounded once;
  * ``generate_page`` with the native renderer gives the JAX package's
    pixels, char corners, heights and lines on seeded pages (~256²) with
    the page homography off and on, and ruled lines and tables forced on;
  * ``render_char_labels`` (native and numpy branches) and
    ``char_regression_label`` equal the JAX package's;
  * the ``"python"`` backend (``tests/test_torch_render_python.py``) on a
    small page; an unknown backend and a failing g++ build raise.
"""
import dataclasses
from fractions import Fraction

import cv2
import numpy as np
import pytest

from adascale.data import synth as JS
from adascale_torch import native
from adascale_torch.data import geometry as TG
from adascale_torch.data import synth as TS


def _quad(rng, w, h, ratio=0.02):
    src = np.asarray([[0, 0], [w, 0], [w, h], [0, h]], dtype=np.float32)
    dst = src + rng.uniform(-ratio, ratio, size=(4, 2)).astype(np.float32) * np.asarray([[w, h]], np.float32)
    return src, dst


def _paper(rng, h, w):
    """A noisy gray page with dark rectangles, the kind of image the page
    homography warps."""
    img = np.clip(rng.normal(215, 8, (h, w, 1)) + np.zeros((1, 1, 3)), 0, 255).astype(np.uint8)
    for _ in range(60):
        y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
        img[y : y + rng.integers(2, 12), x : x + rng.integers(2, 12)] = rng.integers(10, 90)
    return img


def test_glyph_atlas_equals_put_text_tiles():
    atlas = TS.GlyphAtlas()
    keys = [(g, f, t) for g in JS._GLYPH_CHARS for f in JS._GLYPH_FONTS for t in (1, 2)]
    assert len(keys) == len(atlas.ids) == len(atlas.tiles) == 852
    assert TS._GLYPH_CHARS == JS._GLYPH_CHARS and TS._GLYPH_FONTS == tuple(int(f) for f in JS._GLYPH_FONTS)
    for key in keys:
        np.testing.assert_array_equal(atlas.tiles[atlas.tile_id(*key)], JS._glyph_tile(*key), err_msg=str(key))


def _warp_case(rng, h, w, ratio):
    src, dst = _quad(rng, w, h, ratio)
    mat = TG.get_perspective_transform(src, dst)
    np.testing.assert_array_equal(mat, cv2.getPerspectiveTransform(src, dst))
    pts = rng.uniform(-10, max(h, w) + 10, (64, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        TG.perspective_transform(pts, mat), cv2.perspectiveTransform(pts.reshape(1, -1, 2), mat)[0]
    )
    img = _paper(rng, h, w) if rng.uniform() < 0.5 else rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    bg = int(rng.integers(180, 251))
    want = cv2.warpPerspective(
        img, mat, (w, h), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT, borderValue=(bg, bg, bg)
    )
    return TG.warp_perspective(img, mat, (w, h), bg), want


def test_perspective_twins_equal_cv2():
    """Widths that are multiples of 32: OpenCV's vector loop covers every
    column, and the warp is bit-equal."""
    rng = np.random.default_rng(0)
    for t in range(12):
        h, w = [(256, 256), (131, 96), (300, 256), (64, 224)][t % 4]
        got, want = _warp_case(rng, h, w, 0.02 if t % 2 else 0.08)
        np.testing.assert_array_equal(got, want)


def test_warp_perspective_scalar_tail_is_bounded():
    """Other widths: bit-equal outside the last ``w % 32`` columns (OpenCV's
    scalar tail), where a pixel may differ by 1 (ROADMAP Queue 3 item 7)."""
    rng = np.random.default_rng(1)
    tail_values = tail_diffs = 0
    for t in range(16):
        h, w = int(rng.integers(40, 200)), int(rng.integers(40, 300))
        w += 1 if w % 32 == 0 else 0
        got, want = _warp_case(rng, h, w, 0.08)
        head = w - w % 32
        np.testing.assert_array_equal(got[:, :head], want[:, :head])
        diff = np.abs(got[:, head:].astype(int) - want[:, head:])
        assert diff.max(initial=0) <= 1
        tail_values += diff.size
        tail_diffs += int((diff > 0).sum())
    assert tail_diffs <= 0.003 * tail_values, (tail_diffs, tail_values)


def test_axis_line_equals_cv2_line():
    rng = np.random.default_rng(1)
    got = np.zeros((40, 50, 3), np.uint8)
    want = got.copy()
    for _ in range(20):
        gray = int(rng.integers(100, 200))
        if rng.uniform() < 0.5:
            y, x0, x1 = int(rng.integers(-3, 43)), int(rng.integers(-5, 55)), int(rng.integers(-5, 55))
            p0, p1 = (x0, y), (x1, y)
        else:
            x, y0, y1 = int(rng.integers(-3, 53)), int(rng.integers(-5, 45)), int(rng.integers(-5, 45))
            p0, p1 = (x, y0), (x, y1)
        TG.draw_line(got, p0, p1, gray)
        cv2.line(want, p0, p1, (gray, gray, gray), 1)
    np.testing.assert_array_equal(got, want)
    # Any other segment too (tests/test_torch_render_python.py: 600 of them).
    TG.draw_line(got, (0, 0), (3, 4), 1)
    cv2.line(want, (0, 0), (3, 4), (1, 1, 1), 1)
    np.testing.assert_array_equal(got, want)


def _round_f32(value: Fraction) -> np.float32:
    r = np.float32(float(value))
    cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - value), int(np.float32(c).view(np.uint32)) & 1))


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(2)
    a, b, c = (rng.uniform(-300, 300, 400).astype(np.float32) for _ in range(3))
    # Sums whose f64 value falls halfway between two f32 values, where a
    # second rounding would pick the wrong one.
    a = np.concatenate([a, np.full(3, 2**-24 * (1 + 2**-23), np.float32)])
    b = np.concatenate([b, np.asarray([1 - 2**-23, 1 + 2**-23, 1 - 2**-23], np.float32)])
    c = np.concatenate([c, np.asarray([1 + 2**-23, 1 + 2**-23, 1.0], np.float32)])
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))) for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(TG.fma_f32(a, b, c), np.asarray(want, np.float32))


PAGE_CASES = [
    dict(perspective_prob=0.0),
    dict(perspective_prob=1.0),
    dict(perspective_prob=0.0, ruled_line_prob=1.0, table_prob=1.0),
    dict(perspective_prob=1.0, ruled_line_prob=1.0, table_prob=1.0, vignette_prob=1.0),
]


@pytest.mark.parametrize("case", range(len(PAGE_CASES)), ids=["flat", "warped", "ruled_table", "warped_ruled_table"])
def test_generate_page_equals_jax(case):
    kwargs = dict(page_height=240, page_width=256, render_backend="native", **PAGE_CASES[case])
    for seed in (case, 10 + case):
        want = JS.generate_page(JS.SynthPageConfig(**kwargs), np.random.default_rng(seed))
        got = TS.generate_page(TS.SynthPageConfig(**kwargs), np.random.default_rng(seed))
        np.testing.assert_array_equal(got.image, want.image)
        assert len(got.chars) == len(want.chars) > 0
        for g, w in zip(got.chars, want.chars):
            np.testing.assert_array_equal(g.corners, w.corners)
            assert g.corners.dtype == w.corners.dtype and g.height == w.height
        assert [(len(line.chars), line.char_height, line.bounding_box()) for line in got.lines] == [
            (len(line.chars), line.char_height, TG.Box(**dataclasses.asdict(line.bounding_box())))
            for line in want.lines
        ]


def test_auto_backend_is_native():
    kwargs = dict(page_height=128, page_width=128)
    a = TS.generate_page(TS.SynthPageConfig(render_backend="auto", **kwargs), np.random.default_rng(3))
    b = TS.generate_page(TS.SynthPageConfig(render_backend="native", **kwargs), np.random.default_rng(3))
    np.testing.assert_array_equal(a.image, b.image)


def _chars(rng, n, extent):
    chars_t, chars_j = [], []
    for _ in range(n):
        x, y = rng.uniform(-6, extent - 10, size=2)
        hgt = float(rng.uniform(6, 26))
        wid, ang = hgt * float(rng.uniform(0.4, 1.0)), float(rng.uniform(-0.5, 0.5))
        d = np.asarray([np.cos(ang), np.sin(ang)])
        nrm = np.asarray([-np.sin(ang), np.cos(ang)])
        ul = np.asarray([x, y])
        corners = np.stack([ul, ul + wid * d, ul + wid * d + hgt * nrm, ul + hgt * nrm]).astype(np.float32)
        chars_t.append(TS.CharInstance(corners=corners, height=hgt))
        chars_j.append(JS.CharInstance(corners=corners.copy(), height=hgt))
    return chars_t, chars_j


@pytest.mark.parametrize("backend", ["native", "python"])
def test_render_char_labels_equal_jax(backend):
    rng = np.random.default_rng(4)
    for shape, f in (((96, 96), 2), ((64, 80), 1), ((128, 96), 4)):
        chars_t, chars_j = _chars(rng, 25, min(shape))
        got = TS.render_char_labels(chars_t, shape, f, 0.25, backend=backend)
        want = JS.render_char_labels(chars_j, shape, f, 0.25, backend=backend)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert got[0].sum() > 0
    empty = TS.render_char_labels([], (32, 32), 2, backend=backend)
    assert all(m.shape == (16, 16) and not m.any() for m in empty)


def test_char_regression_label_equals_jax():
    rng = np.random.default_rng(5)
    chars_t, chars_j = _chars(rng, 200, 90)
    labelled = 0
    for ct, cj in zip(chars_t, chars_j):
        got, want = TS.char_regression_label(ct, 2, (45, 45)), JS.char_regression_label(cj, 2, (45, 45))
        assert (got is None) == (want is None)
        if got is not None:
            labelled += 1
            assert got[:2] == want[:2]
            for g, w in zip(got[2:], want[2:]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    assert labelled > 100


def test_python_backend_draws_the_jax_page_and_unknown_backends_raise():
    """The ``"python"`` backend (the default) draws the JAX package's page;
    an unknown backend raises."""
    config = dict(page_height=96, page_width=96, num_lines_min=3, num_lines_max=4, glyph_stroke_prob=0.5)
    got = TS.generate_page(TS.SynthPageConfig(**config), np.random.default_rng(0))
    want = JS.generate_page(JS.SynthPageConfig(**config), np.random.default_rng(0))
    assert len(got.chars) == len(want.chars) > 0
    np.testing.assert_array_equal(got.image, want.image)
    with pytest.raises(ValueError, match="unknown render_backend"):
        TS.generate_page(TS.SynthPageConfig(page_height=64, page_width=64, render_backend="cv2"), np.random.default_rng(0))


def test_failing_gxx_build_raises_with_its_output(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("extern \"C\" void asr_execute( {\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g[+][+] failed") as info:
        native.load_library()
    assert "error" in str(info.value)
    assert not list((tmp_path / "_build").glob("*.so"))
