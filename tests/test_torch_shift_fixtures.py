"""The port's shift-page renderer (``adascale_torch/tools/shift_fixtures.py``,
no PIL or OpenCV) against the JAX tool and the committed pages, bit for bit:
the committed ``tests/fixtures/shift_pages/page_{0,1,2}.npz`` (image,
corners, heights); the drawn page before the skew and the degraded page
before the JPEG round trip against the JAX tool's, taken by test-side wraps
of ``cv2.warpAffine`` and ``cv2.imencode``; its parts (``warp_affine`` with
a border value, the JPEG round trip, the rotation matrix) against OpenCV;
and a sample of the committed glyph atlas regenerated by its fixture
script."""
import importlib.util
import os

import numpy as np
import pytest

from adascale.tools import shift_fixtures as jax_tool
from adascale_torch.inference.flatten import warp_affine
from adascale_torch.tools import shift_fixtures as S
from adascale_torch.utils.jpeg import round_trip_gray

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGES = os.path.join(ROOT, "tests", "fixtures", "shift_pages")
SEED = 20260817


@pytest.mark.parametrize("index", [0, 1, 2])
def test_page_equals_the_committed_page(index):
    image, corners, heights = S._render_page(np.random.default_rng([SEED, index]))
    with np.load(os.path.join(PAGES, f"page_{index}.npz")) as want:
        np.testing.assert_array_equal(corners, want["corners"])
        np.testing.assert_array_equal(heights, want["heights"])
        np.testing.assert_array_equal(image, want["image"])
    assert image.dtype == np.uint8 and corners.dtype == heights.dtype == np.float32


def test_drawn_and_degraded_pages_equal_the_jax_tool(monkeypatch):
    captured = {}
    warp, encode = cv2.warpAffine, cv2.imencode

    def spy_warp(src, mat, *args, **kwargs):
        captured["drawn"], captured["mat"] = src.copy(), np.array(mat)
        return warp(src, mat, *args, **kwargs)

    def spy_encode(ext, arr, params):
        captured["degraded"] = arr.copy()
        return encode(ext, arr, params)

    monkeypatch.setattr(cv2, "warpAffine", spy_warp)
    monkeypatch.setattr(cv2, "imencode", spy_encode)
    jax_tool._render_page(np.random.default_rng([SEED, 0]))

    rng = np.random.default_rng([SEED, 0])
    page, bg, quads, _ = S._draw_text(rng, 1024, 768)
    np.testing.assert_array_equal(page, captured["drawn"])
    degraded, _ = S._degrade(rng, page, bg, quads)
    np.testing.assert_array_equal(degraded, captured["degraded"])
    angle = np.degrees(np.arctan2(captured["mat"][0, 1], captured["mat"][0, 0]))
    np.testing.assert_array_equal(
        S.rotation_matrix_2d((384.0, 512.0), float(angle), 1.0),
        cv2.getRotationMatrix2D((384.0, 512.0), float(angle), 1.0),
    )


def test_warp_affine_with_border_equals_cv2():
    rng = np.random.default_rng(0)
    for _ in range(30):
        h, w = int(rng.integers(8, 120)), 32 * int(rng.integers(1, 5))
        img = rng.integers(0, 256, (h, w) if rng.random() < 0.5 else (h, w, 3)).astype(np.uint8)
        mat = S.rotation_matrix_2d((w / 2, h / 2), float(rng.uniform(-30, 30)), float(rng.uniform(0.7, 1.3)))
        mat[:, 2] += rng.uniform(-6, 6, 2)
        border = int(rng.integers(0, 256))
        want = cv2.warpAffine(img, mat, (w, h), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                              borderValue=(border, border, border))
        np.testing.assert_array_equal(warp_affine(img, mat, (w, h), border_value=border), want)


@pytest.mark.parametrize("quality", [10, 45, 70, 95])
def test_jpeg_round_trip_equals_cv2(quality):
    rng = np.random.default_rng(quality)
    for _ in range(8):
        h, w = (int(v) for v in rng.integers(1, 70, 2))  # sizes off the 8x8 grid: edge replication
        smooth = np.cumsum(np.cumsum(rng.normal(0, 4, (h, w)), 0), 1)
        img = np.clip(smooth - smooth.mean() + rng.normal(128, 40, (h, w)), 0, 255).astype(np.uint8)
        ok, enc = cv2.imencode(".jpg", img, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
        assert ok
        np.testing.assert_array_equal(round_trip_gray(img, quality), cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE))


def test_committed_atlas_regenerates_byte_for_byte():
    path = os.path.join(ROOT, "tests", "fixtures", "torch_port", "make_shift_atlas.py")
    spec = importlib.util.spec_from_file_location("make_shift_atlas", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    keys = [(0, 18, "A"), (1, 33, "g"), (2, 53, "W"), (1, 27, "0"), (0, 41, "Q"), (2, 18, "m")]
    fresh = script.build_atlas(keys)
    a = S.atlas()
    assert list(script.CHARS) == list(S.CHARS) and len(script.FONTS) == S.NUM_FONTS
    for i, key in enumerate(keys):
        k = S.glyph_index(*key)
        assert a["alpha"][a["start"][k] : a["start"][k + 1]].tobytes() == (
            fresh["alpha"][fresh["start"][i] : fresh["start"][i + 1]].tobytes()
        ), key
        for name in ("shape", "offset", "bbox", "advance"):
            assert a[name][k].tobytes() == fresh[name][i].tobytes(), (key, name)


def test_main_writes_the_jax_layout(tmp_path):
    S.main(["--out", str(tmp_path), "--num-pages", "1"])
    assert sorted(os.listdir(tmp_path)) == ["page_0.npz"]
    with np.load(tmp_path / "page_0.npz") as got, np.load(os.path.join(PAGES, "page_0.npz")) as want:
        assert sorted(got.files) == sorted(want.files) == ["corners", "heights", "image"]
        for name in want.files:
            np.testing.assert_array_equal(got[name], want[name])
