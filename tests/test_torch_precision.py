"""matmul_precision "default" / "high" in the port (utils/precision.py): the
TF32 rounding, the kernels' plain TF32 twins, the scope, and the engine at
the three precisions on the CPU, against itself and against the JAX engine.

On the CPU the wrappers run their plain f32 versions whatever the scope, so
"default" and "high" compute what "highest" computes there, bit for bit; the
TF32 entries run only on the card (chip_smoke.py phase tf32). The JAX
engine on the CPU: its "default" and "high" equal its "highest" bit for bit
too (XLA's CPU backend computes every f32 product in f32), checked below, so
the port at "default" meets the JAX engine at "default" with
tests/test_torch_engine.py's bars.
"""
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
    BatchedAdaptiveScalingInference,
)
from adascale_torch.inference.eval import match_polygons  # noqa: E402
from adascale_torch.kernels import convnext_block as K  # noqa: E402
from adascale_torch.kernels import fpn_heads, fpn_neck, precise_heads  # noqa: E402
from adascale_torch.utils import precision as P  # noqa: E402

# tests/test_torch_engine.py's bar on the height maps.
HEIGHT_TOL = 1e-3
# A plain TF32 twin against f64 on the unrounded operands: at least
# TWIN_RATIO times the f32 plain version's error (it rounds), at most
# TWIN_BAR of the largest value (one TF32 pass, 2^-11 an operand).
TWIN_RATIO, TWIN_BAR = 10.0, 1e-2


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _numpy_round_tf32(v: np.ndarray) -> np.ndarray:
    bits = v.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_round_tf32_matches_a_numpy_bit_reference():
    rng = np.random.default_rng(0)
    normal = rng.standard_normal(20000).astype(np.float32) * np.float32(10.0) ** rng.integers(-30, 30, 20000)
    # Ties: exactly half a TF32 step above a TF32 value, both signs.
    ties = ((rng.integers(0, 0x7F000000, 4000, dtype=np.uint32) & np.uint32(0xFFFFE000)) | np.uint32(0x1000))
    ties = np.concatenate([ties, ties | np.uint32(0x80000000)]).view(np.float32)
    special = np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 3.0e38, np.inf, -np.inf], np.float32)
    v = np.concatenate([normal.astype(np.float32), ties, special])
    got = P.round_tf32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _numpy_round_tf32(v).view(np.uint32))
    # Round to nearest with ties away from zero; 10 mantissa bits kept.
    one_and_half_step = np.float32(1 + 2.0 ** -11)
    assert P.round_tf32(torch.tensor([one_and_half_step, -one_and_half_step])).tolist() == [
        1 + 2.0 ** -10, -(1 + 2.0 ** -10)]
    assert (got.view(np.uint32)[np.isfinite(got)] & 0x1FFF == 0).all()


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))


def _block_case(rng):
    c = 32
    p = {
        "dwconv.weight": _rand(rng, c, 1, 7, 7, scale=0.1), "dwconv.bias": _rand(rng, c, scale=0.1),
        "ln.weight": _rand(rng, c, scale=0.1, shift=1.0), "ln.bias": _rand(rng, c, scale=0.1),
        "mlp_up.weight": _rand(rng, 4 * c, c, scale=c ** -0.5), "mlp_up.bias": _rand(rng, 4 * c, scale=0.1),
        "mlp_down.weight": _rand(rng, c, 4 * c, scale=(4 * c) ** -0.5), "mlp_down.bias": _rand(rng, c, scale=0.1),
        "block_scale": torch.from_numpy(rng.uniform(0, 1, c).astype(np.float32)),
    }
    return K.convnext_block_plain, (_rand(rng, 1, 12, 10, c), p)


def _neck_case(rng):
    c0, cm, co = 16, 64, 16
    p = {
        "step1_0.conv.weight": _rand(rng, cm, c0, scale=c0 ** -0.5), "step1_0.conv.bias": _rand(rng, cm, scale=0.1),
        "step1_0.ln.weight": _rand(rng, cm, scale=0.1, shift=1.0), "step1_0.ln.bias": _rand(rng, cm, scale=0.1),
        "step2_0.conv.weight": _rand(rng, co, cm, 3, 3, scale=(9 * cm) ** -0.5),
        "step2_0.conv.bias": _rand(rng, co, scale=0.1),
        "step2_0.ln.weight": _rand(rng, co, scale=0.1, shift=1.0), "step2_0.ln.bias": _rand(rng, co, scale=0.1),
    }
    return fpn_neck.fused_neck_l0_plain, (_rand(rng, 1, 12, 10, c0), _rand(rng, 1, 12, 10, cm), p)


def _head(rng, c, m):
    f = (c + m) // 2
    return {
        "step1.conv.weight": _rand(rng, f, c, 3, 3, scale=(9 * c) ** -0.5),
        "step1.conv.bias": _rand(rng, f, scale=0.1),
        "step1.ln.weight": _rand(rng, f, scale=0.1, shift=1.0), "step1.ln.bias": _rand(rng, f, scale=0.1),
        "step2.weight": _rand(rng, m, f, scale=f ** -0.5), "step2.bias": _rand(rng, m, scale=0.1),
    }


def _rough_heads_case(rng):
    c = 64
    return fpn_heads.fused_rough_heads_plain, (_rand(rng, 1, 12, 10, c), _head(rng, c, 1), _head(rng, c, 1))


def _precise_heads_case(rng):
    c = 64
    return precise_heads.fused_precise_heads_plain, (_rand(rng, 1, 12, 10, c), [_head(rng, c, m) for m in (1, 2, 4, 4)])


def _to_f64(v):
    if torch.is_tensor(v):
        return v.double()
    if isinstance(v, dict):
        return {k: _to_f64(t) for k, t in v.items()}
    return [_to_f64(t) for t in v]


@pytest.mark.parametrize(
    "case", [_block_case, _neck_case, _rough_heads_case, _precise_heads_case],
    ids=["convnext_block", "fpn_neck_l0", "fpn_heads", "precise_heads"],
)
def test_plain_tf32_twin_rounds_once(case):
    """Each kernel's plain TF32 twin (``tf32=True``), which the card's TF32
    entry is held against, against its plain version run in f64 on the
    unrounded operands: at least TWIN_RATIO times the f32 plain version's
    error, so that it really rounds, and at most TWIN_BAR of the largest
    value, one TF32 pass."""
    plain, args = case(np.random.default_rng(0))

    def listed(v):
        return [v] if torch.is_tensor(v) else list(v)

    exact = listed(plain(*_to_f64(args)))
    scale = max(float(e.abs().max()) for e in exact)

    def error(outs):
        return max(float((o.double() - e).abs().max()) for o, e in zip(listed(outs), exact)) / scale

    f32, tf32 = error(plain(*args)), error(plain(*args, tf32=True))
    print(f"{case.__name__}: against f64, f32 {f32:.3e}, TF32 {tf32:.3e}")
    assert TWIN_RATIO * f32 <= tf32 <= TWIN_BAR, (f32, tf32)


def test_scope_sets_and_restores_the_flags():
    """``matmul_precision`` lets TF32 into cuDNN and cuBLAS for "default"
    and "high", pins it out for "highest", and restores the flags and the
    enclosing precision on exit, also on an error; an unknown name raises
    naming the three."""
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)  # noqa: E731
    saved = flags()
    try:
        P.pin_full_f32()
        assert flags() == (False, False) and not P.tf32_products()
        with P.matmul_precision("default"):
            assert flags() == (True, True) and P.tf32_products()
            with P.matmul_precision("highest"):
                assert flags() == (False, False) and not P.tf32_products()
            assert flags() == (True, True) and P.tf32_products()
            with pytest.raises(RuntimeError, match="inside"):
                with P.matmul_precision("high"):
                    assert flags() == (True, True) and P.tf32_products()
                    raise RuntimeError("inside")
            assert flags() == (True, True) and P.tf32_products()
        assert flags() == (False, False) and not P.tf32_products()
        with pytest.raises(ValueError, match="'highest', 'high', 'default'"):
            with P.matmul_precision("tensorfloat32"):
                pass
        assert flags() == (False, False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------- the engine

CONFIGS = {
    "module": dict(),
    "fused": dict(use_pallas_neck_heads=True),
    "module_bf16": dict(compute_dtype="bfloat16"),
    "fused_bf16": dict(compute_dtype="bfloat16", use_pallas_backbone=True, use_pallas_neck_heads=True),
}


def _engine(config: str, precision: str = "highest") -> AdaptiveScalingInference:
    cfg = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(
            size="tiny", neck_head_type="fpn",
            custom_block_channels_and_num_layers=MODEL_SPEC.custom_block_channels_and_num_layers,
        ),
        matmul_precision=precision, tiled_rough_tile_size=384, tiled_rough_tile_overlap=64, device="cpu",
        **CONFIGS[config],
    )
    return AdaptiveScalingInference(cfg, params=_load_fixture_params())


def _assert_same(got, want):
    np.testing.assert_array_equal(got["rough"].rough_char_mask, want["rough"].rough_char_mask)
    np.testing.assert_array_equal(got["rough"].rough_char_height_score_map, want["rough"].rough_char_height_score_map)
    assert [p.points.tolist() for p in got["char_polygons"]] == [p.points.tolist() for p in want["char_polygons"]]


@pytest.fixture(scope="module")
def page():
    return generate_page(PAGE_SPEC, np.random.default_rng([42, 0]))


@pytest.fixture(scope="module")
def highest(page):
    """Each configuration's detect() at "highest", computed once."""
    torch.set_num_threads(2)
    return {config: _engine(config).detect(page.image) for config in CONFIGS}


@pytest.mark.parametrize("precision", ["default", "high"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_detect_at_tf32_precisions_equals_highest_on_the_cpu(page, highest, config, precision):
    _assert_same(_engine(config, precision).detect(page.image), highest[config])


@pytest.mark.parametrize("config", ["fused", "fused_bf16"])
def test_tiled_and_detect_many_at_default_equal_highest_on_the_cpu(page, config):
    """The tiled rough pass and detect_many open the scope too; on the CPU
    they compute at "default" what they compute at "highest"."""
    engines = {p: _engine(config, p) for p in ("highest", "default")}
    tiled = {p: e.detect(page.image, tiled=True) for p, e in engines.items()}
    _assert_same(tiled["default"], tiled["highest"])
    pages = [page.image, page.image[:320, :256]]
    many = {p: BatchedAdaptiveScalingInference(e).detect_many(pages) for p, e in engines.items()}
    for got, want in zip(many["default"], many["highest"]):
        _assert_same(got, want)


def test_engines_at_two_precisions_each_run_at_their_own(page, monkeypatch):
    """Two engines at different precisions in one process, in either order:
    each forward of each runs inside its own engine's scope (the kernels'
    entry choice and the flags seen by every block), and the flags are back
    to full f32 after each detect()."""
    seen = []
    block = K._block

    def spy(x, p, mode, tf32=False):
        seen.append((tf32, P.tf32_products(), torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return block(x, p, mode, tf32)

    monkeypatch.setattr(K, "_block", spy)
    engines = {p: _engine("module", p) for p in ("highest", "default")}
    results = {}
    for order in (("highest", "default"), ("default", "highest")):
        for precision in order:
            seen.clear()
            results[precision] = engines[precision].detect(page.image)
            want = precision != "highest"
            assert seen and all(s == (want,) * 4 for s in seen), (precision, set(seen))
            assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    _assert_same(results["default"], results["highest"])


@pytest.fixture(scope="module")
def jax_results(page):
    params = _load_fixture_params()
    return {
        p: JaxEngine(JaxEngineConfig(model=MODEL_SPEC, matmul_precision=p), params=params).detect(page.image)
        for p in ("highest", "default", "high")
    }


def test_jax_cpu_default_and_high_equal_its_highest(jax_results):
    """The JAX engine on the CPU computes "default" and "high" as it
    computes "highest", bit for bit."""
    for p in ("default", "high"):
        _assert_same(jax_results[p], jax_results["highest"])


@pytest.mark.parametrize("precision", ["default", "high"])
def test_detect_at_tf32_precisions_matches_jax(page, jax_results, precision):
    """The port at "default" / "high" against the JAX engine at the same
    precision, with tests/test_torch_engine.py's bars."""
    want = jax_results[precision]
    got = _engine("module", precision).detect(page.image)
    np.testing.assert_array_equal(got["rough"].rough_char_mask, want["rough"].rough_char_mask)
    np.testing.assert_allclose(got["rough"].rough_char_height_score_map, want["rough"].rough_char_height_score_map,
                               atol=HEIGHT_TOL, rtol=HEIGHT_TOL)
    ours, theirs = got["char_polygons"], want["char_polygons"]
    matched = len(match_polygons(ours, theirs, 0.5))
    assert matched >= 0.95 * len(theirs) and matched >= 0.95 * len(ours), (matched, len(ours), len(theirs))


def test_exported_program_runs_at_highest_in_a_tf32_scope(tmp_path):
    """A loaded program's module runs inside matmul_precision("highest"),
    whatever scope it is called in (the JAX export has no precision knob)."""
    from adascale_torch.inference.export import load_program

    class Probe(torch.nn.Module):
        def forward(self, x):
            return x + 1

    path = str(tmp_path / "probe.pt2")
    torch.export.save(torch.export.export(Probe(), (torch.randn(2, 3),)), path)
    module = load_program(path).module()
    seen = []
    module.program.register_forward_pre_hook(
        lambda *_: seen.append((P.tf32_products(), torch.backends.cudnn.allow_tf32)))
    with P.matmul_precision("default"):
        out = module(torch.zeros(2, 3))
        assert P.tf32_products()
    assert seen == [(False, False)]
    assert torch.equal(out, torch.ones(2, 3))


def test_engine_precision_field_is_the_jax_engines():
    """The port's config keeps the JAX engine's field and default."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxEngineConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(AdaptiveScalingInferenceConfig)}
    assert port_fields["matmul_precision"] == jax_fields["matmul_precision"] == "highest"
