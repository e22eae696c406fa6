"""The port's batched ``detect_many`` on the CPU with the overfit micro
fixture: each page's result equals the port's own single-page ``detect()``
(the same rough mask in the valid region, the same polygon count, points
within 1e-3, as tests/test_batch_inference.py holds the JAX package) and
matches the JAX package's ``detect_many`` (>= 95 % of char polygons matched
one-to-one at IoU >= 0.5 both ways); on a world-size-1 mesh it equals the
mesh-less run bit for bit."""
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
from adascale.inference.batch import BatchedAdaptiveScalingInference as JaxBatched  # noqa: E402
from adascale_torch import AdaptiveScalingConfig, AdaptiveScalingInference  # noqa: E402
from adascale_torch import AdaptiveScalingInferenceConfig  # noqa: E402
from adascale_torch.inference import batch as TB  # noqa: E402
from adascale_torch.inference.eval import match_polygons  # noqa: E402


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _engine():
    config = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(
            custom_block_channels_and_num_layers=MODEL_SPEC.custom_block_channels_and_num_layers
        ),
        device="cpu",
    )
    return AdaptiveScalingInference(config, params=_load_fixture_params())


@pytest.fixture(scope="module")
def pages():
    """Three 384x384 text pages (one rough bucket, padded to a batch of 4)
    and a blank 100x700 page (its own bucket)."""
    texts = [generate_page(PAGE_SPEC, np.random.default_rng([42, k])).image for k in range(3)]
    return texts + [np.zeros((100, 700, 3), np.uint8)]


def test_detect_many_equals_single_page_detect(pages):
    engine = _engine()
    many = TB.BatchedAdaptiveScalingInference(engine).detect_many(pages)
    assert len(many) == len(pages)
    for image, res in zip(pages, many):
        single = engine.detect(image)
        vh, vw = single["rough"].resized_shape
        assert res["rough"].resized_shape == (vh, vw)
        np.testing.assert_array_equal(
            res["rough"].rough_char_mask[:vh, :vw], single["rough"].rough_char_mask[:vh, :vw]
        )
        assert single["num_precise_chunks"] == 1
        assert res["stacked_image"].shape == single["stacked_image"].shape
        sp, bp = single["char_polygons"], res["char_polygons"]
        assert len(sp) == len(bp)
        for a, b in zip(sp, bp):
            np.testing.assert_allclose(a.points, b.points, atol=1e-3)
    assert sum(len(r["char_polygons"]) for r in many[:3]) > 0


def test_detect_many_matches_jax(pages):
    want = JaxBatched(JaxEngine(JaxEngineConfig(model=MODEL_SPEC), params=_load_fixture_params())).detect_many(
        pages[:3]
    )
    got = TB.BatchedAdaptiveScalingInference(_engine()).detect_many(pages[:3])
    for res, ref in zip(got, want):
        agreement = (res["rough"].rough_char_mask == ref["rough"].rough_char_mask).mean()
        assert agreement >= 0.995, agreement
        ours, theirs = res["char_polygons"], ref["char_polygons"]
        assert theirs
        matched = len(match_polygons(ours, theirs, 0.5))
        assert matched >= 0.95 * len(theirs), (matched, len(theirs))
        assert matched >= 0.95 * len(ours), (matched, len(ours))


def test_detect_many_on_a_one_rank_mesh(pages):
    """``detect_many`` on a world-size-1 mesh (gloo, in this process) equals
    the mesh-less run bit for bit; a mesh that is not a ``DeviceMesh`` is
    refused (the 2-rank mesh: ``tests/test_torch_mesh_paths.py``)."""
    import torch.distributed as dist

    from adascale_torch.parallel import create_mesh

    with pytest.raises(TypeError, match="DeviceMesh"):
        TB.BatchedAdaptiveScalingInference(None, mesh=object())
    engine = _engine()
    want = TB.BatchedAdaptiveScalingInference(engine).detect_many(pages[2:])
    assert not dist.is_initialized()
    try:
        got = TB.BatchedAdaptiveScalingInference(engine, mesh=create_mesh(device="cpu")).detect_many(pages[2:])
    finally:
        dist.destroy_process_group()
    for res, ref in zip(got, want):
        np.testing.assert_array_equal(res["rough"].rough_char_mask, ref["rough"].rough_char_mask)
        np.testing.assert_array_equal(res["precise"].precise_char_prob_score_map,
                                      ref["precise"].precise_char_prob_score_map)
        assert [p.points.tolist() for p in res["char_polygons"]] == [p.points.tolist() for p in ref["char_polygons"]]


def test_groups_split_at_the_kernel_limits():
    # A 960x768 rough input is 240x192 at stage 0: 91 pages fit the block
    # kernel's row tiles, so groups hold at most 64.
    assert TB.max_group_batch((960, 768)) == 64
    assert TB.max_group_batch((64, 64)) == 8192
    assert TB.max_group_batch((8000, 8000)) == 1
    with pytest.raises(ValueError):
        TB.max_group_batch((8192, 8192))
    groups = TB._groups([(960, 768)] * 130 + [(64, 64)] * 3)
    assert [(shape, len(idxs)) for shape, idxs in groups] == [
        ((960, 768), 64), ((960, 768), 64), ((960, 768), 2), ((64, 64), 3)
    ]
    assert [i for _, idxs in groups for i in idxs] == list(range(133))
    assert [TB.BatchedAdaptiveScalingInference._pad_batch(n) for n in (1, 2, 3, 5, 16, 17)] == [
        1, 2, 4, 8, 16, 32
    ]
