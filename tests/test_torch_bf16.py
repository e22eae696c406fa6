"""bf16 serving (``compute_dtype="bfloat16"``): the port against the JAX
package in bf16, both on the CPU (the kernels' plain twins here).

Per module, on the same numpy-seeded inputs and weights: the block in both of
its modes (the Flax ``ConvNeXtBlockLayer`` at dtype=bfloat16 for the module
mode, the Pallas ``fused_convnext_block`` in interpret mode on a bf16 input
for the Pallas mode), the FPN neck (module and fused), both heads (module and
fused) and UPerNeXt's neck and head. Bars: the largest difference <= 1e-2 and
the mean difference <= 1e-3 of the reference's largest magnitude (bf16 keeps
8 bits: one rounding that another summation order flips is 2^-8 = 3.9e-3 of
its value). The whole model, all six heads, module path and fused path:
<= 3e-2 of the largest magnitude (rounding flips carried through 8 blocks,
the neck and the heads).

detect() on the overfit micro fixture in both configurations, and the tiled
rough pass, against the JAX engine in bf16 run under ``jax.disable_jit()``
(each operation rounds its bf16 result, as the Flax modules and Pallas
kernels state it and as the port computes it; under ``jit`` XLA's fusions
keep some bf16 intermediates in f32): rough mask agreement >= 99 % and the
polygons matched at IoU >= 0.5 both ways >= 90 %, and the char F1 against the
page's ground truth within F1_TOL of the JAX engine's. Polygons alone do not
tell bf16 from f32 here (the port's f32 matches the JAX bf16 polygons as
well), so the rough height map does: where the rough heads are Flax modules
(the module path) their bf16 logits make it equal to the JAX engine's bit
for bit at >= HEIGHT_EQUAL_BAR of the pixels (an f32 run: none); the fused
heads' map is f32, and must lie nearer the JAX bf16 map than the port's f32
run does. One flipped rounding can move a region and with it the polygons
(the tiled case on the first page: 81 / 80 % both ways, at 98-100 % on the
other two), so the tiled case is held over the three fixture pages
together. detect_many against single-page bf16 detect(): mask >= 99 %,
polygons >= 90 % both ways.
"""
import contextlib
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_detection_quality import MODEL_SPEC, PAGE_SPEC, _load_fixture_params  # noqa: E402
from test_torch_fpn_heads import MICRO_SPEC, micro_models  # noqa: E402

from adascale.data.synth import generate_page  # noqa: E402
from adascale.inference import AdaptiveScalingInference as JaxEngine  # noqa: E402
from adascale.inference import AdaptiveScalingInferenceConfig as JaxEngineConfig  # noqa: E402
from adascale.models import AdaptiveScaling as FlaxModel  # noqa: E402
from adascale.models import AdaptiveScalingConfig as FlaxConfig  # noqa: E402
from adascale.models.convnext import ConvNeXtBlockLayer  # noqa: E402
from adascale.models.fpn import FpnHead as FlaxFpnHead  # noqa: E402
from adascale.models.fpn import FpnNeck as FlaxFpnNeck  # noqa: E402
from adascale.models.upernext import UperNextHead as FlaxUperNextHead  # noqa: E402
from adascale.models.upernext import UperNextNeck as FlaxUperNextNeck  # noqa: E402
from adascale.ops import pallas  # noqa: E402
from adascale.ops.pallas.convnext_block import fused_convnext_block  # noqa: E402
from adascale.ops.pallas.fpn_heads import fused_rough_heads as jax_fused_rough_heads  # noqa: E402
from adascale.ops.pallas.fpn_neck import fpn_neck_forward_fused as jax_fpn_neck_forward_fused  # noqa: E402
from adascale.ops.pallas.precise_heads import (  # noqa: E402
    forward_precise_from_features_fused as jax_forward_precise_from_features_fused,
)
from adascale_torch import (  # noqa: E402
    AdaptiveScalingConfig,
    AdaptiveScalingInference,
    AdaptiveScalingInferenceConfig,
    BatchedAdaptiveScalingInference,
)
from adascale_torch.inference.eval import evaluate_char_detection, match_polygons  # noqa: E402
from adascale_torch.kernels import convnext_block as KB  # noqa: E402
from adascale_torch.kernels import fpn_heads as KH  # noqa: E402
from adascale_torch.kernels import fpn_neck as KN  # noqa: E402
from adascale_torch.kernels import precise_heads as KP  # noqa: E402
from adascale_torch.models.adaptive_scaling import AdaptiveScaling  # noqa: E402
from adascale_torch.models.fpn import FpnHead, FpnNeck  # noqa: E402
from adascale_torch.models.upernext import UperNextHead, UperNextNeck  # noqa: E402
from adascale_torch.tools.bf16_drift import drift, format_drift  # noqa: E402
from adascale_torch.utils.params import jax_from_state_dict, state_dict_from_jax  # noqa: E402

BF16 = torch.bfloat16
MAX_TOL, MEAN_TOL = 1e-2, 1e-3
MODEL_TOL = 3e-2
MASK_BAR = 0.99
POLYGON_BAR = 0.90
F1_TOL = 0.15
HEIGHT_EQUAL_BAR = 0.75
MANY_POLYGON_BAR = 0.90
# The tiled case's pages: the fixture page's seed, then two more.
TILED_SEEDS = ([42, 0], [42, 1], [42, 2])
CHANS = tuple(c for c, _ in MICRO_SPEC)  # (8, 16, 32, 64)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _np(t):
    return np.asarray(t.detach().float().numpy() if torch.is_tensor(t) else jnp.asarray(t).astype(jnp.float32))


def assert_bf16_close(got, want, max_tol=MAX_TOL, mean_tol=MEAN_TOL):
    """got against want: the largest and the mean difference over want's
    largest magnitude."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    diff = np.abs(got - want)
    assert diff.max() <= max_tol * scale, (diff.max() / scale, max_tol)
    assert diff.mean() <= mean_tol * scale, (diff.mean() / scale, mean_tol)


def _perturbed(params, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, scale, a.shape)).astype(np.float32), params
    )


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


# ------------------------------------------------------------------ per module


def _block_case(c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 12, 10, c)).astype(np.float32)
    layer = ConvNeXtBlockLayer(channels=c, dtype=jnp.bfloat16)
    params = _perturbed(layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"], rng)
    # A layer scale of order 1, so that the branch shows in the output.
    params["block_scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    p = state_dict_from_jax(params)
    return layer, params, p, x


@pytest.mark.parametrize("c", [16, 32])
def test_block_module_mode_matches_flax(c):
    """Module mode: f32 residual in and out, bf16 rounding inside, against
    the Flax block at dtype=bfloat16."""
    layer, params, p, x = _block_case(c, c)
    want = layer.apply({"params": params}, jnp.asarray(x))
    got = KB.convnext_block(torch.from_numpy(x), p, BF16)
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    assert_bf16_close(got, want)


def test_block_pallas_mode_matches_pallas_interpret():
    """Pallas mode: bf16 in and out, against the Pallas block kernel on a
    bf16 input in interpret mode."""
    layer, params, p, x = _block_case(16, 7)
    xb = _bf16(x)
    want = fused_convnext_block(
        xb, params["dwconv"]["kernel"], params["dwconv"]["bias"], params["ln"]["scale"],
        params["ln"]["bias"], params["mlp_up"]["kernel"], params["mlp_up"]["bias"],
        params["mlp_down"]["kernel"], params["mlp_down"]["bias"], params["block_scale"],
        interpret=True,
    )
    got = KB.convnext_block(torch.from_numpy(x).to(BF16), p, BF16)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_bf16_close(got, want)


def _neck_case(seed, cls=FlaxFpnNeck, port_cls=FpnNeck, out=32):
    rng = np.random.default_rng(seed)
    feats = [
        rng.standard_normal((1, 16 // 2**i, 12 // 2**i, c)).astype(np.float32) for i, c in enumerate(CHANS)
    ]
    flax_neck = cls(in_channels_group=CHANS, out_channels=out, dtype=jnp.bfloat16)
    params = _perturbed(flax_neck.init(jax.random.PRNGKey(seed), [_bf16(f) for f in feats])["params"], rng)
    neck = port_cls(CHANS, out, BF16)
    neck.load_state_dict(state_dict_from_jax(params), strict=True)
    return flax_neck, params, neck.eval(), feats


def test_fpn_neck_module_matches_flax():
    flax_neck, params, neck, feats = _neck_case(1)
    want = flax_neck.apply({"params": params}, [_bf16(f) for f in feats])
    with torch.no_grad():
        got = neck([torch.from_numpy(f).to(BF16) for f in feats])
    assert got.dtype == BF16
    assert_bf16_close(got, want)


def test_fpn_neck_fused_matches_jax_fused():
    """Level 0 through the fused neck's plain twin, levels 1..3 the module's,
    against the JAX fused neck at dtype=bfloat16 (Pallas in interpret mode)."""
    _, params, neck, feats = _neck_case(2)
    want = jax_fpn_neck_forward_fused(
        params, [_bf16(f) for f in feats], dtype=jnp.bfloat16, interpret=True
    )
    with torch.no_grad():
        got = KN.fpn_neck_forward_fused(neck, [torch.from_numpy(f).to(BF16) for f in feats])
    assert got.dtype == BF16
    assert_bf16_close(got, want)


def _head_case(seed, outs, cls=FlaxFpnHead, port_cls=FpnHead, factor=2, c=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 8, 12, c)).astype(np.float32)
    flax_heads, trees, ports = [], [], []
    for k, m in enumerate(outs):
        head = cls(out_channels=m, upsampling_factor=factor, dtype=jnp.bfloat16)
        tree = _perturbed(head.init(jax.random.PRNGKey(seed + k), _bf16(x))["params"], rng)
        port = port_cls(c, m, factor, BF16)
        port.load_state_dict(state_dict_from_jax(tree), strict=True)
        flax_heads.append(head)
        trees.append(tree)
        ports.append(port.eval())
    return x, flax_heads, trees, ports


def test_fpn_head_module_matches_flax():
    x, (head,), (tree,), (port,) = _head_case(3, (4,))
    want = head.apply({"params": tree}, _bf16(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16
    assert_bf16_close(got, want)


def test_fused_rough_heads_match_jax_fused():
    """The fused rough heads' bf16 twin against the Pallas rough-heads kernel
    on a bf16 input (interpret mode): f32 out."""
    x, _, trees, ports = _head_case(4, (1, 1))
    leaves = [
        leaf for t in trees for leaf in (
            t["step1"]["conv"]["kernel"], t["step1"]["conv"]["bias"], t["step1"]["ln"]["scale"],
            t["step1"]["ln"]["bias"], t["step2"]["kernel"], t["step2"]["bias"],
        )
    ]
    want = jax_fused_rough_heads(_bf16(x), *leaves, interpret=True)
    got = KH.fused_rough_heads(torch.from_numpy(x).to(BF16), *(KH.head_params(p) for p in ports))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_bf16_close(g, w)


def test_fused_precise_heads_match_jax_fused():
    """The fused precise heads' bf16 twin against the Pallas precise-heads
    kernel (interpret mode) on the same bf16 neck output: the Flax module
    neck of a micro model at bf16 feeds both."""
    model, flax_model, params = micro_models(5)
    port = AdaptiveScaling(model.config, BF16)
    port.load_state_dict(model.state_dict(), strict=True)
    flax_model = FlaxModel(config=flax_model.config, dtype=jnp.bfloat16)
    rng = np.random.default_rng(6)
    feats = [
        _bf16(rng.standard_normal((1, 12 // 2**i, 16 // 2**i, c)).astype(np.float32))
        for i, c in enumerate(CHANS)
    ]
    neck = flax_model.apply({"params": params}, list(feats), method=lambda m, fs: m.precise_neck(fs))
    want = jax_forward_precise_from_features_fused(flax_model, params, feats, fuse_neck=False, interpret=True)
    with torch.no_grad():
        got = KP.fused_precise_heads(
            torch.from_numpy(np.asarray(neck.astype(jnp.float32))).to(BF16),
            [KH.head_params(getattr(port, name)) for name in KP.HEAD_NAMES],
        )
    got[-1] = torch.nn.functional.softplus(got[-1])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_bf16_close(g, w)


def test_upernext_neck_matches_flax():
    flax_neck, params, neck, feats = _neck_case(8, FlaxUperNextNeck, UperNextNeck)
    want = flax_neck.apply({"params": params}, [_bf16(f) for f in feats])
    with torch.no_grad():
        got = neck([torch.from_numpy(f).to(BF16) for f in feats])
    assert got.dtype == BF16
    assert_bf16_close(got, want)


def test_upernext_head_matches_flax():
    x, (head,), (tree,), (port,) = _head_case(9, (2,), FlaxUperNextHead, UperNextHead)
    want = head.apply({"params": tree}, _bf16(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16
    assert_bf16_close(got, want)


# ---------------------------------------------------------------- whole model


def _model_outputs(neck):
    rng = np.random.default_rng(11)
    torch.manual_seed(11)
    spec = MICRO_SPEC
    model = AdaptiveScaling(AdaptiveScalingConfig(neck_head_type=neck, custom_block_channels_and_num_layers=spec))
    sd = {
        k: v + torch.from_numpy(rng.normal(0.0, 0.1, tuple(v.shape)).astype(np.float32))
        for k, v in model.state_dict().items()
    }
    params = jax_from_state_dict(sd)
    x = rng.uniform(0.0, 255.0, (1, 64, 64, 3)).astype(np.float32)
    return sd, params, x, spec


@pytest.mark.parametrize("neck", ["fpn", "upernext"])
def test_model_module_path_matches_flax(neck):
    """All six heads, the module path (f32 residual in the backbone)."""
    sd, params, x, spec = _model_outputs(neck)
    port = AdaptiveScaling(AdaptiveScalingConfig(neck_head_type=neck, custom_block_channels_and_num_layers=spec), BF16)
    port.load_state_dict(sd, strict=True)
    flax_model = FlaxModel(
        config=FlaxConfig(size="tiny", neck_head_type=neck, custom_block_channels_and_num_layers=spec),
        dtype=jnp.bfloat16,
    )
    want = [
        *flax_model.apply({"params": params}, jnp.asarray(x), method=flax_model.forward_rough),
        *flax_model.apply({"params": params}, jnp.asarray(x), method=flax_model.forward_precise),
    ]
    with torch.no_grad():
        got = [*port.forward_rough(torch.from_numpy(x)), *port.forward_precise(torch.from_numpy(x))]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert_bf16_close(g, w, MODEL_TOL, MODEL_TOL / 10)


def test_model_fused_path_matches_jax_fused():
    """All six heads, the fused path (the Pallas backbone's bf16 residual,
    the fused neck level 0 and heads), against the JAX engine's forward with
    use_pallas_backbone and use_pallas_neck_heads (Pallas in interpret mode)."""
    sd, params, x, spec = _model_outputs("fpn")
    cfg = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(custom_block_channels_and_num_layers=spec), compute_dtype="bfloat16",
        use_pallas_backbone=True, use_pallas_neck_heads=True, device="cpu",
    )
    port = AdaptiveScalingInference(cfg, params=params)
    flax_model = FlaxModel(
        config=FlaxConfig(size="tiny", neck_head_type="fpn", custom_block_channels_and_num_layers=spec),
        dtype=jnp.bfloat16,
    )
    feats = pallas.convnext_forward_pallas(params["backbone"], _bf16(x), spec, interpret=True)
    want = [
        *pallas.forward_rough_from_features_fused(flax_model, params, feats, interpret=True),
        *pallas.forward_precise_from_features_fused(flax_model, params, feats, interpret=True),
    ]
    with torch.no_grad():
        got = [*port._forward(torch.from_numpy(x), "rough"), *port._forward(torch.from_numpy(x), "precise")]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_bf16_close(g, w, MODEL_TOL, MODEL_TOL / 10)


# -------------------------------------------------------------------- engine


def _port_config(fused, **kw):
    return AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(
            size="tiny", neck_head_type="fpn",
            custom_block_channels_and_num_layers=MODEL_SPEC.custom_block_channels_and_num_layers,
        ),
        compute_dtype="bfloat16", use_pallas_backbone=fused, use_pallas_neck_heads=fused, device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def page():
    return generate_page(PAGE_SPEC, np.random.default_rng([42, 0]))


@contextlib.contextmanager
def pallas_interpret():
    """The JAX engine's Pallas paths in interpret mode (the CPU has no
    Mosaic) while within."""
    saved = {name: getattr(pallas, name) for name in (
        "convnext_forward_pallas", "forward_rough_from_features_fused", "forward_precise_from_features_fused")}
    for name, fn in saved.items():
        setattr(pallas, name, functools.partial(fn, interpret=True))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(pallas, name, fn)


def jax_bf16_engine(fused, **kw):
    return JaxEngine(
        JaxEngineConfig(model=MODEL_SPEC, compute_dtype="bfloat16", use_pallas_backbone=fused,
                        use_pallas_neck_heads=fused, **kw),
        params=_load_fixture_params(),
    )


def jax_bf16_detect(engine, image, **kw):
    """The JAX engine's detect() run eagerly (``jax.disable_jit()``), Pallas
    in interpret mode."""
    with pallas_interpret(), jax.disable_jit():
        return engine.detect(image, **kw)


@pytest.fixture(scope="module")
def jax_bf16(page):
    """The JAX engine in bf16 on the fixture page, module path and fused."""
    torch.set_num_threads(2)
    return {fused: jax_bf16_detect(jax_bf16_engine(fused), page.image) for fused in (False, True)}


def height_parity(got, want):
    """The rough height maps: the share equal bit for bit, and the median
    absolute difference."""
    a, b = (r["rough"].rough_char_height_score_map for r in (got, want))
    return float((a == b).mean()), float(np.median(np.abs(a.astype(np.float64) - b)))


def polygon_counts(got, want):
    """(matched at IoU >= 0.5, got's polygons, want's polygons)."""
    ours, theirs = got["char_polygons"], want["char_polygons"]
    return len(match_polygons(ours, theirs, 0.5)), len(ours), len(theirs)


def assert_detect_close(got, want, label, page=None, bar=POLYGON_BAR):
    """Mask agreement, polygons matched both ways at ``bar`` and, given the
    page, char F1 against its ground truth within F1_TOL of ``want``'s."""
    agreement = (got["rough"].rough_char_mask == want["rough"].rough_char_mask).mean()
    ours, theirs = got["char_polygons"], want["char_polygons"]
    matched = len(match_polygons(ours, theirs, 0.5))
    f1 = ""
    if page is not None:
        gt = [c.corners for c in page.chars]
        f1s = [evaluate_char_detection(r["char_polygons"], gt, iou_thr=0.5).f1 for r in (got, want)]
        f1 = f", char F1 {f1s[0]:.4f} / {f1s[1]:.4f}"
    print(f"{label}: mask agreement {agreement:.6f}, polygons {len(ours)} / {len(theirs)}, matched {matched}{f1}")
    assert agreement >= MASK_BAR, agreement
    assert theirs, "the micro model finds polygons on its page"
    assert matched >= bar * len(theirs), (matched, len(theirs))
    assert matched >= bar * len(ours), (matched, len(ours))
    if page is not None:
        assert abs(f1s[0] - f1s[1]) <= F1_TOL, f1s


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_detect_matches_jax_bf16(page, jax_bf16, fused):
    """detect() at bf16 against the JAX engine at bf16 on the micro fixture;
    the drift of the port's bf16 against its f32 printed beside it."""
    params = _load_fixture_params()
    got = AdaptiveScalingInference(_port_config(fused), params=params).detect(page.image)
    assert_detect_close(got, jax_bf16[fused], f"bf16 {'fused' if fused else 'module'} vs JAX bf16", page)
    f32 = AdaptiveScalingInference(
        dataclasses.replace(_port_config(fused), compute_dtype="float32"), params=params
    ).detect(page.image)
    matched = len(match_polygons(got["char_polygons"], f32["char_polygons"], 0.5))
    print(
        f"port bf16 vs port f32: mask agreement "
        f"{(got['rough'].rough_char_mask == f32['rough'].rough_char_mask).mean():.6f}, polygons "
        f"{len(got['char_polygons'])} / {len(f32['char_polygons'])}, matched {matched}"
    )
    (equal, median), (equal32, median32) = (height_parity(r, jax_bf16[fused]) for r in (got, f32))
    print(f"rough height map vs JAX bf16: bf16 {equal:.4f} equal, median {median:.3e}; "
          f"f32 {equal32:.4f} equal, median {median32:.3e}")
    if fused:
        assert median < median32, (median, median32)
    else:
        assert equal >= HEIGHT_EQUAL_BAR, equal
    for m in (got["precise"].precise_char_prob_score_map, got["rough"].rough_char_height_score_map):
        assert m.dtype == np.float32


def test_detect_many_matches_detect_bf16(page):
    """detect_many at bf16 (the fixture page twice, and a blank page) against
    single-page bf16 detect()."""
    engine = AdaptiveScalingInference(_port_config(True), params=_load_fixture_params())
    pages = [page.image, page.image[:, ::-1].copy(), np.zeros((100, 300, 3), np.uint8)]
    for image, res in zip(pages, BatchedAdaptiveScalingInference(engine).detect_many(pages)):
        single = engine.detect(image)
        if single["char_polygons"] or res["char_polygons"]:
            assert_detect_close(res, single, "bf16 detect_many vs detect", bar=MANY_POLYGON_BAR)


def test_tiled_detect_bf16_matches_jax_tiled_bf16(page, jax_bf16):
    """detect(tiled=True) at bf16 (tiles of 256, overlap 64, the fused
    configuration) against the JAX engine's tiled detect() at bf16 on the
    same settings, on the three TILED_SEEDS pages: mask agreement on each,
    the polygons matched both ways over the three together at detect()'s
    bar (each page's printed); the whole-page pass printed beside."""
    tiles = {"tiled_rough_tile_size": 256, "tiled_rough_tile_overlap": 64}
    engine = AdaptiveScalingInference(_port_config(True, **tiles), params=_load_fixture_params())
    reference = jax_bf16_engine(True, **tiles)
    totals = np.zeros(3, int)
    for seed in TILED_SEEDS:
        image = page.image if seed == TILED_SEEDS[0] else generate_page(PAGE_SPEC, np.random.default_rng(seed)).image
        got = engine.detect(image, tiled=True)
        want = jax_bf16_detect(reference, image, tiled=True)
        assert got["rough"].padded_image_shape == want["rough"].padded_image_shape
        agreement = (got["rough"].rough_char_mask == want["rough"].rough_char_mask).mean()
        counts = polygon_counts(got, want)
        print(f"bf16 tiled vs JAX bf16 tiled, page {seed}: mask agreement {agreement:.6f}, "
              f"matched {counts[0]} of {counts[1]} / {counts[2]}")
        assert agreement >= MASK_BAR, agreement
        totals += counts
        if seed == TILED_SEEDS[0]:
            whole = polygon_counts(got, jax_bf16[True])
            print(f"bf16 tiled vs JAX bf16 whole page: matched {whole[0]} of {whole[1]}")
    matched, ours, theirs = totals
    assert theirs, "the micro model finds polygons on its pages"
    assert matched >= POLYGON_BAR * theirs and matched >= POLYGON_BAR * ours, totals


def test_bf16_drift_on_micro_fixture(page):
    """adascale_torch.tools.bf16_drift on the JAX tool's case: the overfit
    micro fixture on its page, bf16 against f32."""
    d = drift(_load_fixture_params(), dataclasses.replace(_port_config(False), compute_dtype="float32"),
              page.image, [c.corners for c in page.chars])
    print("bf16 drift (micro fixture, CPU):", format_drift(d))
    assert d["mask_agreement"] >= MASK_BAR
    assert abs(d["df1"]) <= 0.1


# ------------------------------------------------------------------- refusals


def test_engine_accepts_bfloat16_and_refuses_other_dtypes():
    """compute_dtype="bfloat16" builds a bf16 model (f32 parameters); an
    unknown compute dtype raises."""
    engine = AdaptiveScalingInference(_port_config(True), params=_load_fixture_params())
    assert engine.dtype == BF16 and engine.model.dtype == BF16
    assert all(p.dtype == torch.float32 for p in engine.model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        AdaptiveScalingInference(dataclasses.replace(_port_config(False), compute_dtype="float16"), params={})


def test_wrappers_refuse_other_dtypes_and_bf16_gradients():
    """A dtype the kernels do not take raises in every wrapper; the bf16
    block has no gradient path and raises where one is wanted."""
    layer, params, p, x = _block_case(16, 12)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="float16"):
        KB.convnext_block(xt.half(), p, BF16)
    with pytest.raises(ValueError, match="compute dtype"):
        KB.convnext_block(xt.to(BF16), p)
    p["mlp_up.weight"].requires_grad_()
    with pytest.raises(NotImplementedError, match="bf16"):
        KB.convnext_block(xt, p, BF16)
    x16 = torch.zeros(1, 4, 4, 32, dtype=torch.float16)
    model, _, _ = micro_models(1)
    heads = [KH.head_params(getattr(model, name)) for name in KP.HEAD_NAMES]
    with pytest.raises(ValueError, match="float16"):
        KH.fused_rough_heads(x16, heads[0], heads[1])
    with pytest.raises(ValueError, match="float16"):
        KP.fused_precise_heads(x16, heads)
    neck = KN.level0_params(model.rough_neck)
    with pytest.raises(ValueError, match="float16"):
        KN.fused_neck_l0(torch.zeros(1, 4, 4, 8, dtype=torch.float16), torch.zeros(1, 4, 4, 32, dtype=torch.float16), neck)
