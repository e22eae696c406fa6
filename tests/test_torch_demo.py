"""The port's demo (``adascale_torch/inference/demo.py::infer``) against the
JAX package's ``adascale/inference/demo.py::infer`` on the CPU.

A 192x192 synth page through each engine on the same weights: the micro
model at a seeded init carried across to the JAX package's parameter tree
(``utils/params.py::jax_from_state_dict``, written to an ``.npz`` that both
engines load) and the overfit fixture (a trained model, so that regions, indices
and polygons are drawn). The port writes the ten stems as PNG; the JAX
demo's images are taken in memory by a test-side ``monkeypatch`` of its
painter's ``to_file``. Bars: >= 99.5 % of the pixels equal for the rough
images, >= 98 % for the rest (the measured shares are printed).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_detection_quality import FIXTURE, MODEL_SPEC  # noqa: E402

from adascale.data.synth import SynthPageConfig, generate_page  # noqa: E402
from adascale.inference import AdaptiveScalingInference as JaxEngine  # noqa: E402
from adascale.inference import AdaptiveScalingInferenceConfig as JaxEngineConfig  # noqa: E402
from adascale.inference.demo import infer as jax_infer  # noqa: E402
from adascale.models import AdaptiveScalingConfig as JaxModelConfig  # noqa: E402
from adascale.tools.export_params import flatten_params  # noqa: E402
from adascale.utils import painter as jax_painter  # noqa: E402
from adascale.utils.config import config_to_dict  # noqa: E402
from adascale_torch.inference.demo import STEMS, infer  # noqa: E402
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig  # noqa: E402
from adascale_torch.models.adaptive_scaling import init_like_flax_  # noqa: E402
from adascale_torch.utils.params import jax_from_state_dict  # noqa: E402
from adascale_torch.utils.png import read_image, write_png  # noqa: E402

MICRO_SPEC = ((8, 1), (16, 1), (32, 1), (64, 1))
ROUGH_BAR, OTHER_BAR = 0.995, 0.98
PAGE = SynthPageConfig(
    page_height=192, page_width=192, num_lines_min=2, num_lines_max=3, char_height_min=20, char_height_max=36
)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _weights(kind, folder):
    """(model config, .npz path) of the micro model at a seeded init or the
    overfit fixture."""
    if kind == "fixture":
        return MODEL_SPEC, FIXTURE
    model = AdaptiveScaling(AdaptiveScalingConfig(custom_block_channels_and_num_layers=MICRO_SPEC))
    init_like_flax_(model, torch.Generator().manual_seed(0))
    path = str(folder / "micro.npz")
    np.savez(path, **flatten_params(jax_from_state_dict(model.state_dict())))
    return JaxModelConfig(size="tiny", neck_head_type="fpn", custom_block_channels_and_num_layers=MICRO_SPEC), path


@pytest.mark.parametrize("kind", ["micro", "fixture"])
def test_demo_images_match_the_jax_demo(kind, tmp_path, monkeypatch):
    model_cfg, weights = _weights(kind, tmp_path)
    page = generate_page(PAGE, np.random.default_rng([7, 1])).image
    page_path = str(tmp_path / "page.png")
    write_png(page_path, page)

    captured = {}
    monkeypatch.setattr(
        jax_painter.Painter, "to_file",
        lambda self, path: captured.__setitem__(os.path.splitext(os.path.basename(path))[0], self.image.copy()),
    )
    jax_engine = JaxEngine(JaxEngineConfig(checkpoint=weights, model=model_cfg))
    want = jax_infer(None, page_path, str(tmp_path / "jax"), engine=jax_engine, image=read_image(page_path))

    config = tmp_path / "infer.json"
    config.write_text(json.dumps({"checkpoint": weights, "model": config_to_dict(model_cfg)}))
    out = tmp_path / "port"
    got = infer(str(config), page_path, str(out), device="cpu")

    assert sorted(os.listdir(out)) == sorted(f"{s}.png" for s in STEMS)
    assert sorted(captured) == sorted(STEMS)
    print(f"{kind}: {len(got['char_polygons'])} port chars, {len(want['char_polygons'])} JAX chars")
    for stem in STEMS:
        ours = read_image(str(out / f"{stem}.png"))
        theirs = captured[stem]
        assert ours.shape == theirs.shape, stem
        share = float((ours == theirs).all(axis=2).mean())
        bar = ROUGH_BAR if stem.startswith("rough") else OTHER_BAR
        print(f"  {stem}: {share:.6f} equal (bar {bar})")
        assert share >= bar, (stem, share)
