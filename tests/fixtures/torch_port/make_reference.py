"""Regenerate ``flagship_fpn_reference.npz``: the JAX engine's detect() on a
committed page with the tiny/FPN flagship weights, f32, for the PyTorch
port to be held against on the card (``chip_smoke.py``).

Settings are the engine's defaults (f32, matmul precision "highest", short
side 720, shape bucket 64, core gating 0.4, NMS 0.3). The backbone runs as
the Flax blocks: the Pallas block kernel compiles only for a TPU, and the
repo's ``tests/test_pallas.py`` holds the two to 1e-5.

The page is the first of ``tests/fixtures/shift_pages/page_{0,1,2}.npz`` on
which the engine finds at least 100 char polygons.

Run from the repository root (takes a few minutes on a CPU):

    JAX_PLATFORMS=cpu python tests/fixtures/torch_port/make_reference.py
"""
import os
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from adascale.inference import (  # noqa: E402
    AdaptiveScalingInference,
    AdaptiveScalingInferenceConfig,
)
from adascale.inference.engine import load_params  # noqa: E402
from adascale.models import AdaptiveScalingConfig  # noqa: E402

WEIGHTS = "examples/flagship_training/flagship_fpn_params.f16.npz"
PAGES = [f"tests/fixtures/shift_pages/page_{i}.npz" for i in range(3)]
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "flagship_fpn_reference.npz")
MIN_POLYGONS = 100


def main() -> None:
    model = AdaptiveScalingConfig(size="tiny", neck_head_type="fpn")
    cfg = AdaptiveScalingInferenceConfig(model=model)
    params = load_params(os.path.join(ROOT, WEIGHTS), model)
    engine = AdaptiveScalingInference(cfg, params=params)
    for page_path in PAGES:
        image = np.load(os.path.join(ROOT, page_path))["image"]
        result = engine.detect(image)
        polys = result["char_polygons"]
        print(page_path, "char polygons:", len(polys), flush=True)
        if len(polys) >= MIN_POLYGONS:
            break
    else:
        raise SystemExit("no shift page reaches the polygon count")
    np.savez_compressed(
        OUT,
        page=np.asarray(page_path),
        weights=np.asarray(WEIGHTS),
        rough_char_mask=result["rough"].rough_char_mask,
        rough_resized_shape=np.asarray(result["rough"].resized_shape),
        char_polygons=np.stack([p.points for p in polys]).astype(np.float32),
        char_scores=np.asarray([p.score for p in polys], dtype=np.float32),
        num_regions=np.asarray(len(result["regions"])),
        num_precise_chunks=np.asarray(result["num_precise_chunks"]),
    )
    print("wrote", OUT, os.path.getsize(OUT), "bytes")


if __name__ == "__main__":
    main()
