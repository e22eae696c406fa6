"""The port's tiled full-resolution rough pass against the JAX package on the
CPU: the tile origins and ownership spans equal JAX's, stitching partitions
the page, and ``detect(tiled=True)`` with the overfit micro fixture matches
the JAX engine's (rough mask agreement >= 99.5 %, >= 95 % of char polygons
matched one-to-one at IoU >= 0.5 both ways)."""
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
from adascale.inference import tiled as JT  # noqa: E402
from adascale_torch import AdaptiveScalingConfig, AdaptiveScalingInference  # noqa: E402
from adascale_torch import AdaptiveScalingInferenceConfig  # noqa: E402
from adascale_torch.inference import tiled as TT  # noqa: E402
from adascale_torch.inference.eval import match_polygons  # noqa: E402

TILE, OVERLAP = 256, 64


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("tile,stride", [(256, 192), (128, 96), (768, 640), (64, 1)])
def test_tile_origins_and_ownership_equal_jax(tile, stride):
    for length in range(tile, tile + 5 * stride + 7, max(1, stride // 7)):
        origins = TT.compute_tile_origins(length, tile, stride)
        assert origins == JT.compute_tile_origins(length, tile, stride)
        for margin in (0, (tile - stride) // 2):
            assert TT._ownership(origins, tile, margin, length) == JT._ownership(
                origins, tile, margin, length
            )


def test_tile_origins_refuse_a_short_page():
    with pytest.raises(ValueError):
        TT.compute_tile_origins(100, 128, 96)


def test_stitching_partitions_the_page():
    """With the forward a stride-2 subsample, the stitched maps are the
    whole page's subsample exactly."""
    fdf = 2
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (192, 320, 3)).astype(np.float32))

    def forward(t):
        m = t[:, ::fdf, ::fdf, :1]
        return m, m * 2.0

    mask, height = TT.tiled_rough_forward(forward, img, tile=128, overlap=32, fdf=fdf)
    torch.testing.assert_close(mask, img[::fdf, ::fdf, 0], rtol=0, atol=0)
    torch.testing.assert_close(height, img[::fdf, ::fdf, 0] * 2.0, rtol=0, atol=0)


def test_tiles_past_one_launch_go_in_chunks():
    """A page of more tiles than the kernels take in one launch runs the
    forward chunk by chunk, and the stitched maps are those of one call. At
    768 a launch takes 64 tiles; a 600 dpi A3 scan (7016x9921) has 176."""
    assert TT.max_group_batch((768, 768)) == 64
    a3 = [len(TT.compute_tile_origins(n, 768, 640)) for n in (7016, 9922)]
    assert a3[0] * a3[1] == 176
    fdf = 2
    img = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (192, 320, 3)).astype(np.float32))
    sizes = []

    def forward(t):
        sizes.append(t.shape[0])
        m = t[:, ::fdf, ::fdf, :1]
        return m, m * 2.0

    whole = TT.tiled_rough_forward(forward, img, tile=128, overlap=32, fdf=fdf)
    assert sizes == [6]
    chunked = TT.tiled_rough_forward(forward, img, tile=128, overlap=32, fdf=fdf, max_batch=4)
    assert sizes == [6, 4, 2]
    for got, want in zip(chunked, whole):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(chunked[0], img[::fdf, ::fdf, 0], rtol=0, atol=0)


def _port_engine(**kw):
    config = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(
            custom_block_channels_and_num_layers=MODEL_SPEC.custom_block_channels_and_num_layers
        ),
        tiled_rough_tile_size=TILE,
        tiled_rough_tile_overlap=OVERLAP,
        device="cpu",
        **kw,
    )
    return AdaptiveScalingInference(config, params=_load_fixture_params())


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
def test_detect_tiled_matches_jax(fused):
    """A 384x448 page: 2 x 2 tiles of 256 with overlap 64, so every tile
    edge but the page's is an interior seam."""
    page = generate_page(dataclasses.replace(PAGE_SPEC, page_width=448), np.random.default_rng([42, 2]))
    want = JaxEngine(
        JaxEngineConfig(model=MODEL_SPEC, tiled_rough_tile_size=TILE, tiled_rough_tile_overlap=OVERLAP),
        params=_load_fixture_params(),
    ).detect(page.image, tiled=True)
    got = _port_engine(use_pallas_neck_heads=fused).detect(page.image, tiled=True)
    rough, ref = got["rough"], want["rough"]
    assert rough.resized_image_shape == ref.resized_image_shape == (384, 448)
    assert rough.padded_image_shape == ref.padded_image_shape
    assert rough.resized_shape == ref.resized_shape == (192, 224)
    agreement = (rough.rough_char_mask == ref.rough_char_mask).mean()
    assert agreement >= 0.995, agreement
    ours, theirs = got["char_polygons"], want["char_polygons"]
    assert theirs
    matched = len(match_polygons(ours, theirs, 0.5))
    assert matched >= 0.95 * len(theirs), (matched, len(theirs))
    assert matched >= 0.95 * len(ours), (matched, len(ours))


def test_tiled_auto_switch_and_small_page():
    """``tiled_rough_long_side_min`` turns tiling on by the page's long
    side; a page smaller than a tile is padded up to one tile."""
    engine = _port_engine(tiled_rough_long_side_min=200)
    image = np.zeros((150, 210, 3), np.uint8)
    rough = engine.detect(image)["rough"]
    assert rough.padded_image_shape == (TILE, TILE)
    assert rough.resized_image_shape == (150, 210)
    assert rough.resized_shape == (75, 105)
    assert rough.rough_char_mask.shape == (TILE // 2, TILE // 2)
    assert engine.detect(image, tiled=False)["rough"].padded_image_shape == (192, 256)
    assert not rough.rough_char_mask[75:].any() and not rough.rough_char_mask[:, 105:].any()
