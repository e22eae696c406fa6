"""The port's ``"python"`` render backend (``data/synth.py``,
``data/geometry.py::draw_line``) against the JAX package's per-char OpenCV
path, on the CPU:

  * ``draw_line`` against ``cv2.line`` (``LINE_8``) on 600 random segments
    at each of thickness 1 and 2, a third of them with ends outside the image
    (clipped at the border) and a quarter of them a few pixels long, on 3-channel
    images: bit for bit;
  * ``generate_page`` at the default config cut to 512x512 for six seeds,
    and at 500x500 (a width that is not a multiple of 32, so the page
    homography also runs ``warpPerspective``'s scalar tail): the chars bit
    for bit, every label map of ``render_char_labels`` bit for bit, and the
    image within IMAGE_BOUND;
  * the port's dataset on ``examples/synthetic_training/steps.json`` (no
    ``render_backend`` key: the ``"python"`` default) against the JAX
    dataset: every label array bit for bit, the images within IMAGE_BOUND.

IMAGE_BOUND: the glyph warps are mostly narrower than 32 pixels, so they
run in ``warpPerspective``'s scalar tail, which ``warp_perspective``
follows only within one gray level (ROADMAP Queue 3 item 7). Over 600 pages
(512x512, 500x500 and 512x400, seeds 1000-1199,
``tests/fixtures/torch_port/render_bound.py``) the largest difference was 1
gray level on 8.4e-8 of the values; the bar is 1 gray level on at most 1e-5
of them.
"""
import json
import os

import cv2
import numpy as np
import pytest

from adascale.data import dataset as JD
from adascale.data import synth as JS
from adascale_torch.data import dataset as TD
from adascale_torch.data import synth as TS
from adascale_torch.data.geometry import draw_line

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_STEPS = os.path.join(ROOT, "examples", "synthetic_training", "steps.json")
IMAGE_BOUND = (1, 1e-5)  # largest difference in gray levels, share of values that differ


def _segments(rng, n):
    for k in range(n):
        h, w = int(rng.integers(3, 72)), int(rng.integers(3, 72))
        reach = 12 if k % 3 == 0 else 0
        p0 = (int(rng.integers(-reach, w + reach)), int(rng.integers(-reach, h + reach)))
        if k % 4 == 1:
            p1 = (p0[0] + int(rng.integers(-3, 4)), p0[1] + int(rng.integers(-3, 4)))
        else:
            p1 = (int(rng.integers(-reach, w + reach)), int(rng.integers(-reach, h + reach)))
        yield h, w, p0, p1


@pytest.mark.parametrize("thickness", [1, 2])
def test_draw_line_equals_cv2(thickness):
    rng = np.random.default_rng(thickness)
    clipped = 0
    for h, w, p0, p1 in _segments(rng, 600):
        background = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ink = int(rng.integers(0, 256))
        want = background.copy()
        cv2.line(want, p0, p1, (ink, ink, ink), thickness)
        got = background.copy()
        draw_line(got, p0, p1, ink, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w, p0, p1)}")
        clipped += not all(0 <= x < w and 0 <= y < h for x, y in (p0, p1))
    assert clipped >= 150


def _assert_image_within_bound(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= IMAGE_BOUND[0], diff.max()
    assert (diff > 0).mean() <= IMAGE_BOUND[1], (diff > 0).mean()


@pytest.mark.parametrize("hw,seed", [((512, 512), s) for s in range(6)] + [((500, 500), 6)])
def test_generate_page_matches_jax(hw, seed):
    h, w = hw
    assert TS.SynthPageConfig().render_backend == JS.SynthPageConfig().render_backend == "python"
    want = JS.generate_page(JS.SynthPageConfig(page_height=h, page_width=w), np.random.default_rng(seed))
    got = TS.generate_page(TS.SynthPageConfig(page_height=h, page_width=w), np.random.default_rng(seed))
    assert len(got.chars) == len(want.chars) > 0 and len(got.lines) == len(want.lines)
    for a, b in zip(got.chars, want.chars):
        np.testing.assert_array_equal(a.corners, b.corners)
        assert a.height == b.height
    _assert_image_within_bound(got.image, want.image)
    for f in (2, 4):
        for g, wl in zip(TS.render_char_labels(got.chars, (h, w), f), JS.render_char_labels(want.chars, (h, w), f)):
            assert g.dtype == wl.dtype
            np.testing.assert_array_equal(g, wl)


def _samples(module, steps, n):
    dataset = module.AdaptiveScalingIterableDataset(module.AdaptiveScalingDatasetConfig(
        steps_json=steps, num_page_char_regression_labels=100, num_samples=n, rng_seed=1337, is_dev=True,
    ))
    try:
        return [module.collate_samples([pair]) for _, pair in zip(range(n), dataset)]
    finally:
        dataset.pool.cleanup()


def test_example_dataset_matches_jax():
    with open(EXAMPLE_STEPS) as f:
        assert "render_backend" not in json.load(f)["page"]
    got, want = _samples(TD, EXAMPLE_STEPS, 4), _samples(JD, EXAMPLE_STEPS, 4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for part in ("rough", "precise"):
            assert set(g[part]) == set(w[part])
            for key, value in w[part].items():
                if key == "image":
                    _assert_image_within_bound(g[part][key], value)
                elif isinstance(value, np.ndarray):
                    assert g[part][key].dtype == value.dtype, key
                    np.testing.assert_array_equal(g[part][key], value, err_msg=key)
                else:
                    assert g[part][key] == value or tuple(g[part][key]) == tuple(value), key
