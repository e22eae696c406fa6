"""Regenerate the JAX references that ``chip_smoke.py`` holds the PyTorch port
against on the card: the JAX engine's detect() with the tiny/FPN flagship
weights, f32, one ``.npz`` per case:

  * ``flagship_fpn_reference.npz``: a committed text page, engine defaults;
  * ``flagship_fpn_multichunk_reference.npz``: the same page with
    ``precise_stacked_image_max_area`` small enough that the regions are
    stacked into several precise chunks;
  * ``flagship_fpn_blank_reference.npz``: a blank page (no text);
  * ``flagship_upernext_reference.npz`` (case ``upernext``): the tiny/UPerNeXt
    flagship (``examples/flagship_upernext/``) on the same page, engine
    defaults;
  * ``flagship_fpn_tiled_band_reference.npz`` (case ``tiled_band``): the
    tiny/FPN flagship on a 1024x1536 page, ``page_0`` and ``page_1`` side by
    side, with ``detect(tiled=True)`` (6 tiles of 768 with overlap 128, the
    engine's defaults) and ``precise_band_recall_center_dist_ratio=0.5``;
  * ``flagship_fpn_train_reference.npz`` (case ``train``): one two-task
    training step of the flagship, deterministic (no drop path, which the
    two frameworks cannot draw alike), on a seeded batch of B = 2 at the
    flagship's training shapes (``adascale_torch.training.seeded_batches``:
    512x512 rough crops, core margin 16; 320x320 precise crops, core margin
    8; 200 label points; uint8 images and masks): ``jax.value_and_grad`` of
    ``_two_task_loss`` and one step of ``build_optimizer(OptimizerConfig(),
    steps_per_epoch=1000)``. It keeps the two losses, the global gradient
    norm, the batch's checksum and, for every leaf under the port's names,
    the gradient's and the update's L2 norm and projection on a seeded unit
    vector (``adascale_torch.utils.params.leaf_fingerprints``), their largest
    magnitude and a strided sample of 64 of their elements
    (``leaf_sample``), not the arrays themselves;
  * ``flagship_fpn_bf16_reference.npz`` (case ``fpn_bf16``): the page case at
    ``compute_dtype="bfloat16"``, the Flax module path (f32 residual stream);
  * ``flagship_fpn_fused_bf16_reference.npz`` (case ``fpn_fused_bf16``): the
    same with ``use_pallas_backbone=True, use_pallas_neck_heads=True`` (bf16
    residual between blocks, the fused neck level 0 and heads), the Pallas
    kernels in interpret mode on the CPU;
  * ``flagship_upernext_bf16_reference.npz`` (case ``upernext_bf16``): the
    UPerNeXt case at ``compute_dtype="bfloat16"`` with
    ``use_pallas_backbone=True, use_pallas_neck_heads=True`` (the Pallas
    backbone in interpret mode; the JAX engine keeps UPerNeXt's neck and
    heads on their Flax modules).

  The bf16 cases run the JAX engine under ``jax.disable_jit()``: each
  operation then rounds its bf16 result, as the Flax modules and the Pallas
  kernels state it and as the port computes it, where XLA's fusions under
  ``jit`` keep some bf16 intermediates in f32. They also keep the rough
  height score map at every HEIGHT_STRIDE-th row and column
  (``rough_char_height_score_map_strided``): a function of the bf16 height
  logit, so a port that rounds where JAX rounds reproduces most of its
  values bit for bit, and one that computes in f32 almost none.

Settings are otherwise the engine's defaults (f32 but for the bf16 cases, matmul precision
"highest", short side 720, shape bucket 64, core gating 0.4, NMS 0.3). The
backbone runs as the Flax blocks: the Pallas block kernel compiles only for a
TPU, and the repo's ``tests/test_pallas.py`` holds the two to 1e-5.

The text page is the first of ``tests/fixtures/shift_pages/page_{0,1,2}.npz``
on which the engine finds at least 100 char polygons.

Run from the repository root (a few minutes a case on a CPU); with case
names (``page``, ``multichunk``, ``blank``, ``train``, ``upernext``,
``tiled_band``, ``fpn_bf16``, ``fpn_fused_bf16``, ``upernext_bf16``) it makes
only those:

    JAX_PLATFORMS=cpu python tests/fixtures/torch_port/make_reference.py [case ...]
"""
import dataclasses
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
from adascale_torch.training import batch_checksum, seeded_batches  # noqa: E402
from adascale_torch.utils.params import (  # noqa: E402
    leaf_fingerprints, leaf_sample, state_dict_from_jax,
)

WEIGHTS = "examples/flagship_training/flagship_fpn_params.f16.npz"
UPERNEXT_WEIGHTS = "examples/flagship_upernext/flagship_upernext_params.f16.npz"
PAGES = [f"tests/fixtures/shift_pages/page_{i}.npz" for i in range(3)]
HERE = os.path.dirname(os.path.abspath(__file__))
MIN_POLYGONS = 100
# Stack-area cap of the multi-chunk case: page_0's one 1024x832 stack
# becomes several.
MULTICHUNK_MAX_AREA = 300_000
BLANK_SHAPE = (100, 700, 3)
TRAIN_SEED, TRAIN_BATCH, FINGERPRINT_SEED = 0, 2, 0
# The tiled band-recall case: two shift pages side by side, band recall on.
TILED_PAGES = PAGES[:2]
BAND_RATIO = 0.5
# The bf16 cases' strided copy of the rough height score map.
HEIGHT_STRIDE = 4


def save(name: str, result, page: str, weights: str = WEIGHTS, **extra) -> None:
    polys = result["char_polygons"]
    out = os.path.join(HERE, name)
    np.savez_compressed(
        out,
        page=np.asarray(page),
        weights=np.asarray(weights),
        rough_char_mask=result["rough"].rough_char_mask,
        rough_resized_shape=np.asarray(result["rough"].resized_shape),
        char_polygons=np.asarray([p.points for p in polys], np.float32).reshape(-1, 4, 2),
        char_scores=np.asarray([p.score for p in polys], dtype=np.float32),
        num_regions=np.asarray(len(result["regions"])),
        num_precise_chunks=np.asarray(result["num_precise_chunks"]),
        **extra,
    )
    print("wrote", out, os.path.getsize(out), "bytes;", len(polys), "char polygons,",
          result["num_precise_chunks"], "precise chunks", flush=True)


def train_reference() -> None:
    import jax.numpy as jnp
    import optax

    from adascale.losses import CoreBox
    from adascale.models import AdaptiveScaling
    from adascale.training import OptimizerConfig, TrainStepConfig, build_optimizer
    from adascale.training.train_step import _two_task_loss

    config = AdaptiveScalingConfig(size="tiny", neck_head_type="fpn")
    model = AdaptiveScaling(config=config)
    params = jax.tree_util.tree_map(jnp.asarray, load_params(os.path.join(ROOT, WEIGHTS), config))
    rough, precise, rough_box, precise_box = seeded_batches(TRAIN_SEED, TRAIN_BATCH)
    cfg = TrainStepConfig(rough_core_box=CoreBox(*rough_box), precise_core_box=CoreBox(*precise_box))
    fn = jax.jit(jax.value_and_grad(
        lambda p, r, q: _two_task_loss(model, p, r, q, jax.random.PRNGKey(0), cfg, True), has_aux=True
    ))
    with jax.default_matmul_precision("highest"):
        (_, (r_loss, p_loss)), grads = fn(params, rough, precise)
        tx, _ = build_optimizer(OptimizerConfig(), steps_per_epoch=1000)
        updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
        new = optax.apply_updates(params, updates)
    to_np = lambda tree: state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
    old, grads_sd, new = to_np(params), to_np(grads), to_np(new)
    names = sorted(grads_sd)
    updates = {k: new[k] - old[k] for k in names}
    grad_prints = leaf_fingerprints(grads_sd, FINGERPRINT_SEED)
    update_prints = leaf_fingerprints(updates, FINGERPRINT_SEED)
    out = os.path.join(HERE, "flagship_fpn_train_reference.npz")
    np.savez_compressed(
        out,
        weights=np.asarray(WEIGHTS),
        seed=np.asarray(TRAIN_SEED),
        batch_size=np.asarray(TRAIN_BATCH),
        fingerprint_seed=np.asarray(FINGERPRINT_SEED),
        checksum=np.asarray(batch_checksum(rough, precise)),
        rough_loss=np.asarray(float(r_loss)),
        precise_loss=np.asarray(float(p_loss)),
        grad_norm=np.asarray(float(optax.global_norm(grads))),
        names=np.asarray(names),
        grad_norms=np.asarray([grad_prints[k][0] for k in names]),
        grad_projections=np.asarray([grad_prints[k][1] for k in names]),
        update_norms=np.asarray([update_prints[k][0] for k in names]),
        update_projections=np.asarray([update_prints[k][1] for k in names]),
        grad_maxes=np.asarray([np.abs(np.asarray(grads_sd[k])).max() for k in names]),
        grad_samples=np.concatenate([leaf_sample(grads_sd[k]) for k in names]),
        update_maxes=np.asarray([np.abs(np.asarray(updates[k])).max() for k in names]),
        update_samples=np.concatenate([leaf_sample(updates[k]) for k in names]),
    )
    print("wrote", out, os.path.getsize(out), "bytes; rough", float(r_loss), "precise", float(p_loss),
          "grad norm", float(optax.global_norm(grads)), len(names), "leaves", flush=True)


def upernext_reference() -> None:
    model = AdaptiveScalingConfig(size="tiny", neck_head_type="upernext")
    engine = AdaptiveScalingInference(
        AdaptiveScalingInferenceConfig(model=model),
        params=load_params(os.path.join(ROOT, UPERNEXT_WEIGHTS), model),
    )
    image = np.load(os.path.join(ROOT, PAGES[0]))["image"]
    save("flagship_upernext_reference.npz", engine.detect(image), PAGES[0], weights=UPERNEXT_WEIGHTS)


def tiled_band_reference(params) -> None:
    model = AdaptiveScalingConfig(size="tiny", neck_head_type="fpn")
    engine = AdaptiveScalingInference(
        AdaptiveScalingInferenceConfig(model=model, precise_band_recall_center_dist_ratio=BAND_RATIO),
        params=params,
    )
    image = np.concatenate([np.load(os.path.join(ROOT, p))["image"] for p in TILED_PAGES], axis=1)
    result = engine.detect(image, tiled=True)
    save("flagship_fpn_tiled_band_reference.npz", result, "", pages=np.asarray(TILED_PAGES),
         image_shape=np.asarray(image.shape),
         precise_band_recall_center_dist_ratio=np.asarray(BAND_RATIO),
         rough_padded_image_shape=np.asarray(result["rough"].padded_image_shape))


def interpret_pallas() -> None:
    """Run the JAX engine's Pallas paths in interpret mode (the CPU has no
    Mosaic): the backbone and the fused rough and precise forwards."""
    import functools

    from adascale.ops import pallas

    for name in ("convnext_forward_pallas", "forward_rough_from_features_fused",
                 "forward_precise_from_features_fused"):
        setattr(pallas, name, functools.partial(getattr(pallas, name), interpret=True))


def bf16_reference(case: str) -> None:
    """One of the three bf16 cases on ``page_0``, timed."""
    import time

    neck = "upernext" if case == "upernext_bf16" else "fpn"
    weights = UPERNEXT_WEIGHTS if neck == "upernext" else WEIGHTS
    model = AdaptiveScalingConfig(size="tiny", neck_head_type=neck)
    fused = case != "fpn_bf16"
    if fused:
        interpret_pallas()
    engine = AdaptiveScalingInference(
        AdaptiveScalingInferenceConfig(
            model=model, compute_dtype="bfloat16",
            use_pallas_backbone=fused, use_pallas_neck_heads=fused,
        ),
        params=load_params(os.path.join(ROOT, weights), model),
    )
    image = np.load(os.path.join(ROOT, PAGES[0]))["image"]
    start = time.perf_counter()
    with jax.disable_jit():
        result = engine.detect(image)
    print(case, "took", round(time.perf_counter() - start, 1), "s on the CPU", flush=True)
    name = {"fpn_bf16": "flagship_fpn_bf16_reference.npz",
            "fpn_fused_bf16": "flagship_fpn_fused_bf16_reference.npz",
            "upernext_bf16": "flagship_upernext_bf16_reference.npz"}[case]
    height = result["rough"].rough_char_height_score_map
    save(name, result, PAGES[0], weights=weights, compute_dtype=np.asarray("bfloat16"),
         use_pallas_backbone=np.asarray(fused), use_pallas_neck_heads=np.asarray(fused),
         eager=np.asarray(True), height_stride=np.asarray(HEIGHT_STRIDE),
         rough_char_height_score_map_strided=np.asarray(
             height[::HEIGHT_STRIDE, ::HEIGHT_STRIDE], np.float32))


def main(cases) -> None:
    for case in ("fpn_bf16", "fpn_fused_bf16", "upernext_bf16"):
        if case in cases:
            bf16_reference(case)
    if "train" in cases:
        train_reference()
    if "upernext" in cases:
        upernext_reference()
    if not {"page", "multichunk", "blank", "tiled_band"} & set(cases):
        return
    model = AdaptiveScalingConfig(size="tiny", neck_head_type="fpn")
    cfg = AdaptiveScalingInferenceConfig(model=model)
    params = load_params(os.path.join(ROOT, WEIGHTS), model)
    if "tiled_band" in cases:
        tiled_band_reference(params)
    engine = AdaptiveScalingInference(cfg, params=params)
    if "page" in cases:
        for page_path in PAGES:
            image = np.load(os.path.join(ROOT, page_path))["image"]
            result = engine.detect(image)
            print(page_path, "char polygons:", len(result["char_polygons"]), flush=True)
            if len(result["char_polygons"]) >= MIN_POLYGONS:
                break
        else:
            raise SystemExit("no shift page reaches the polygon count")
        save("flagship_fpn_reference.npz", result, page_path)
    if "multichunk" in cases:
        chunked = AdaptiveScalingInference(
            dataclasses.replace(cfg, precise_stacked_image_max_area=MULTICHUNK_MAX_AREA),
            params=params,
        )
        image = np.load(os.path.join(ROOT, PAGES[0]))["image"]
        result = chunked.detect(image)
        if result["num_precise_chunks"] < 2:
            raise SystemExit("the cap does not split the stack")
        save("flagship_fpn_multichunk_reference.npz", result, PAGES[0],
             precise_stacked_image_max_area=np.asarray(MULTICHUNK_MAX_AREA))
    if "blank" in cases:
        result = engine.detect(np.zeros(BLANK_SHAPE, np.uint8))
        save("flagship_fpn_blank_reference.npz", result, "", image_shape=np.asarray(BLANK_SHAPE),
             stacked_image_shape=np.asarray(result["stacked_image"].shape))


if __name__ == "__main__":
    main(sys.argv[1:] or ["page", "multichunk", "blank", "train", "upernext", "tiled_band",
                          "fpn_bf16", "fpn_fused_bf16", "upernext_bf16"])
