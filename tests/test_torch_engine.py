"""The port's two-pass detect() against the JAX engine on the overfit micro
fixture (page [42, 0] of the detection-quality spec), both on the CPU."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_detection_quality import MODEL_SPEC, PAGE_SPEC, _load_fixture_params  # noqa: E402

from adascale.data.synth import generate_page  # noqa: E402
from adascale.inference import AdaptiveScalingInference as JaxEngine  # noqa: E402
from adascale.inference import AdaptiveScalingInferenceConfig as JaxEngineConfig  # noqa: E402
from adascale_torch import (  # noqa: E402
    AdaptiveScalingConfig,
    AdaptiveScalingInference,
    AdaptiveScalingInferenceConfig,
)
from adascale_torch.inference.eval import evaluate_char_detection, match_polygons  # noqa: E402

# Height maps agree to f32 rounding of the same arithmetic (measured 1.5e-5
# at heights ~30); 1e-3 leaves room for summation order only.
HEIGHT_TOL = 1e-3


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def results():
    torch.set_num_threads(2)
    params = _load_fixture_params()
    page = generate_page(PAGE_SPEC, np.random.default_rng([42, 0]))
    jax_result = JaxEngine(JaxEngineConfig(model=MODEL_SPEC), params=params).detect(page.image)
    config = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(
            size="tiny",
            neck_head_type="fpn",
            custom_block_channels_and_num_layers=MODEL_SPEC.custom_block_channels_and_num_layers,
        ),
        use_pallas_backbone=True,
        device="cpu",
    )
    port_result = AdaptiveScalingInference(config, params=params).detect(page.image)
    return page, jax_result, port_result


def test_rough_maps_match_jax(results):
    _, want, got = results
    assert got["rough"].resized_shape == want["rough"].resized_shape
    np.testing.assert_array_equal(got["rough"].rough_char_mask, want["rough"].rough_char_mask)
    np.testing.assert_allclose(
        got["rough"].rough_char_height_score_map,
        want["rough"].rough_char_height_score_map,
        atol=HEIGHT_TOL,
        rtol=HEIGHT_TOL,
    )


def test_regions_and_stack_match_jax(results):
    _, want, got = results
    assert [r.shape for r in got["regions"]] == [r.shape for r in want["regions"]]
    assert got["num_precise_chunks"] == want["num_precise_chunks"]
    assert got["stacked_image"].shape == want["stacked_image"].shape
    diff = np.abs(got["stacked_image"].astype(np.int16) - want["stacked_image"])
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_char_polygons_match_jax_both_ways(results):
    _, want, got = results
    ours, theirs = got["char_polygons"], want["char_polygons"]
    matched = len(match_polygons(ours, theirs, 0.5))
    assert matched >= 0.95 * len(theirs), (matched, len(theirs))
    assert matched >= 0.95 * len(ours), (matched, len(ours))


def test_port_detect_meets_quality_bars(results):
    """The bars of test_detection_quality.py, on the port's output."""
    page, _, got = results
    m = evaluate_char_detection(got["char_polygons"], [c.corners for c in page.chars], iou_thr=0.5)
    assert m.f1 >= 0.80, m.as_dict()
    assert m.precision >= 0.78, m.as_dict()
    assert m.recall >= 0.78, m.as_dict()
    assert all(p.score is not None and p.score >= 0.6 for p in got["char_polygons"])


def test_multi_chunk_detect_matches_jax():
    """A small stack-area cap splits the regions into several precise
    stacks; chunking, the per-chunk passes and the merged NMS follow the JAX
    engine."""
    params = _load_fixture_params()
    page = generate_page(PAGE_SPEC, np.random.default_rng([42, 1]))
    cap = 60_000
    want = JaxEngine(
        JaxEngineConfig(model=MODEL_SPEC, precise_stacked_image_max_area=cap), params=params
    ).detect(page.image)
    config = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(
            custom_block_channels_and_num_layers=MODEL_SPEC.custom_block_channels_and_num_layers
        ),
        precise_stacked_image_max_area=cap,
        device="cpu",
    )
    got = AdaptiveScalingInference(config, params=params).detect(page.image)
    assert got["num_precise_chunks"] == want["num_precise_chunks"] > 1
    ours, theirs = got["char_polygons"], want["char_polygons"]
    matched = len(match_polygons(ours, theirs, 0.5))
    assert matched >= 0.95 * len(theirs) and matched >= 0.95 * len(ours), (
        matched, len(ours), len(theirs)
    )


def test_fused_neck_heads_detect_matches_jax(results):
    """``use_pallas_neck_heads=True``: the FPN neck's level 0 and the heads
    run through their kernels' plain versions on the CPU; detect() still
    matches the JAX engine (the same function as its module path)."""
    page, want, _ = results
    config = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(
            custom_block_channels_and_num_layers=MODEL_SPEC.custom_block_channels_and_num_layers
        ),
        use_pallas_neck_heads=True,
        device="cpu",
    )
    got = AdaptiveScalingInference(config, params=_load_fixture_params()).detect(page.image)
    agreement = (got["rough"].rough_char_mask == want["rough"].rough_char_mask).mean()
    assert agreement >= 0.995, agreement
    ours, theirs = got["char_polygons"], want["char_polygons"]
    matched = len(match_polygons(ours, theirs, 0.5))
    assert matched >= 0.95 * len(theirs), (matched, len(theirs))
    assert matched >= 0.95 * len(ours), (matched, len(ours))


@pytest.fixture(scope="module")
def blank_jax():
    """The JAX engine on a blank page: the overfit micro model still fires on
    it, so its precise maps are near-flat and the 5x5 peak pick decides ties."""
    torch.set_num_threads(2)
    image = np.zeros((100, 700, 3), np.uint8)
    return image, JaxEngine(JaxEngineConfig(model=MODEL_SPEC), params=_load_fixture_params()).detect(image)


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
def test_blank_page_matches_jax_both_ways(blank_jax, fused):
    """A page with no text: the same bars as ``test_char_polygons_match_jax_
    both_ways``. The module-path heads compute the phase form as Flax does,
    so the peak pick breaks the near-ties of the flat maps as JAX does."""
    image, want = blank_jax
    config = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(
            custom_block_channels_and_num_layers=MODEL_SPEC.custom_block_channels_and_num_layers
        ),
        use_pallas_neck_heads=fused,
        device="cpu",
    )
    got = AdaptiveScalingInference(config, params=_load_fixture_params()).detect(image)
    np.testing.assert_array_equal(got["rough"].rough_char_mask, want["rough"].rough_char_mask)
    ours, theirs = got["char_polygons"], want["char_polygons"]
    assert theirs, "the micro model finds polygons on the blank page"
    matched = len(match_polygons(ours, theirs, 0.5))
    assert matched >= 0.95 * len(theirs), (matched, len(theirs))
    assert matched >= 0.95 * len(ours), (matched, len(ours))


def test_unported_options_raise():
    """matmul_precision other than "highest" is not ported (compute_dtype
    "bfloat16" is: tests/test_torch_bf16.py)."""
    for field, value in [
        ("matmul_precision", "default"),
        ("matmul_precision", "high"),
    ]:
        config = AdaptiveScalingInferenceConfig(device="cpu", **{field: value})
        with pytest.raises(NotImplementedError, match=field):
            AdaptiveScalingInference(config, params={})


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
def test_band_recall_detect_matches_jax(results, fused):
    """``precise_band_recall_center_dist_ratio``: peaks in a region's full
    dilated mask but outside its core are ranked by their distance to the
    core (the chamfer twin of cv2.distanceTransform) and merged after NMS;
    detect() matches the JAX engine with the same bars."""
    page, _, _ = results
    ratio = 0.5
    want = JaxEngine(
        JaxEngineConfig(model=MODEL_SPEC, precise_band_recall_center_dist_ratio=ratio),
        params=_load_fixture_params(),
    ).detect(page.image)
    config = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(
            custom_block_channels_and_num_layers=MODEL_SPEC.custom_block_channels_and_num_layers
        ),
        precise_band_recall_center_dist_ratio=ratio,
        use_pallas_neck_heads=fused,
        device="cpu",
    )
    engine = AdaptiveScalingInference(config, params=_load_fixture_params())
    got = engine.detect(page.image)
    _, band, dists = engine.precise_build_grouped_polygons(
        got["precise"], got["regions"], got["boxes"], collect_band=True
    )
    assert sum(map(len, band)) > 0 and all(len(b) == len(d) for b, d in zip(band, dists))
    plain = AdaptiveScalingInference(
        dataclasses.replace(config, precise_band_recall_center_dist_ratio=None),
        params=_load_fixture_params(),
    ).detect(page.image)
    assert len(got["char_polygons"]) > len(plain["char_polygons"])
    ours, theirs = got["char_polygons"], want["char_polygons"]
    matched = len(match_polygons(ours, theirs, 0.5))
    assert matched >= 0.95 * len(theirs), (matched, len(theirs))
    assert matched >= 0.95 * len(ours), (matched, len(ours))


def test_merge_band_polygons_equals_jax():
    from adascale.data.geometry import Polygon as JaxPolygon
    from adascale_torch.data.geometry import Polygon

    rng = np.random.default_rng(3)
    quads = [rng.uniform(0, 5, (4, 2)) + rng.uniform(0, 60, 2) for _ in range(40)]
    ratio = 0.7
    jax_engine = JaxEngine(
        JaxEngineConfig(model=MODEL_SPEC, precise_band_recall_center_dist_ratio=ratio), params={}
    )
    # merge_band_polygons reads the config only: no model is built.
    port = AdaptiveScalingInference.__new__(AdaptiveScalingInference)
    port.config = AdaptiveScalingInferenceConfig(precise_band_recall_center_dist_ratio=ratio, device="cpu")
    kept, band = quads[:15], quads[15:]
    want = jax_engine.merge_band_polygons([JaxPolygon(q) for q in kept], [JaxPolygon(q) for q in band])
    got = port.merge_band_polygons([Polygon(q) for q in kept], [Polygon(q) for q in band])
    assert len(got) == len(want) > len(kept)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.points, w.points)
    for q in quads:
        c, s = AdaptiveScalingInference._polygon_center_size(Polygon(q))
        jc, js = JaxEngine._polygon_center_size(JaxPolygon(q))
        np.testing.assert_allclose(c, jc, rtol=1e-12)
        assert abs(s - js) <= 1e-9 * js
