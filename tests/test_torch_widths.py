"""The fused neck and heads at the widths of the ``base`` and ``large``
backbones (neck Cm 512 / 768, Co 128 / 192; heads F 256-258 / 384-386),
where the kernels split the features into slices of their tiles: the port's
fused functions (their plain twins on the CPU) against the Flax ``FpnNeck``,
``FpnHead`` and ``forward_rough_from_features`` /
``forward_precise_from_features`` on random-init weights from a seed, at
small spatial shapes, f32 at 1e-3 (the full-model bar), and the heads'
single-pass TF32 twins (``matmul_precision("default")``'s form) against the
same Flax heads at TF32_TOL, and the neck's likewise. Also the packed
layouts of a sliced neck and heads: each slice is the one-pass layout of
its features. The kernels
themselves run only on the card (``chip_smoke.py`` phase widths)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adascale.models import AdaptiveScaling as FlaxModel
from adascale.models import AdaptiveScalingConfig as FlaxConfig
from adascale.models.convnext import CONVNEXT_PRESETS
from adascale.models.fpn import FpnHead as FlaxFpnHead
from adascale.models.fpn import FpnNeck as FlaxFpnNeck
from adascale_torch.kernels import fpn_heads as KH
from adascale_torch.kernels import fpn_neck as KN
from adascale_torch.kernels import packing
from adascale_torch.kernels import precise_heads as KP
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from adascale_torch.models.fpn import FpnHead, FpnNeck
from adascale_torch.utils.params import state_dict_from_jax

TOL = 1e-3
# The TF32 twin (x and the collapsed taps rounded to TF32, 10 mantissa
# bits) against Flax at "highest": a product's rounding error of ~2^-11,
# through a LayerNorm.
TF32_TOL = 1e-2
PRESETS = ["base", "large"]
# The Flax heads' inputs, parameters and outputs by (size, outs), kept by
# test_fused_heads_match_flax for the TF32 case (one interpret call each).
_FLAX_HEADS = {}


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _group(size):
    return tuple(c for c, _ in CONVNEXT_PRESETS[size])


def _features(size, seed, hw0=(8, 6)):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((1, max(1, hw0[0] // 2**i), max(1, hw0[1] // 2**i), c)).astype(np.float32)
        for i, c in enumerate(_group(size))
    ]


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.1, a.shape)).astype(np.float32), params
    )


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("size", PRESETS)
def test_fused_neck_matches_flax(size):
    group = _group(size)
    cm = group[-2]
    feats = _features(size, 1)
    flax_neck = FlaxFpnNeck(in_channels_group=group, out_channels=cm)
    params = _perturbed(flax_neck.init(jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats])["params"], 2)
    neck = FpnNeck(group, cm)
    neck.load_state_dict(state_dict_from_jax(params), strict=True)
    co = cm // len(group)
    assert [(step[1], step[2]) for step in KN.plan("f32", group[0], cm, co)] == {
        "base": [(256, 2), (128, 1)], "large": [(384, 2), (192, 1)]}[size]
    with torch.no_grad():
        got = KN.fpn_neck_forward_fused(neck.eval(), [torch.from_numpy(f) for f in feats])
    with jax.default_matmul_precision("highest"):
        want = flax_neck.apply({"params": params}, [jnp.asarray(f) for f in feats])
    _close(got.numpy(), want)


def _flax_heads(size, outs):
    """(x, the port's head parameters, the Flax heads' outputs) at ``size``'s
    widths, computed once per (size, outs)."""
    if (size, outs) not in _FLAX_HEADS:
        c = _group(size)[-2]
        x = np.random.default_rng(3).standard_normal((1, 6, 5, c)).astype(np.float32)
        heads, want = [], []
        for k, m in enumerate(outs):
            flax_head = FlaxFpnHead(out_channels=m, upsampling_factor=2)
            tree = _perturbed(flax_head.init(jax.random.PRNGKey(k), jnp.asarray(x))["params"], 4 + k)
            head = FpnHead(c, m, 2)
            head.load_state_dict(state_dict_from_jax(tree), strict=True)
            heads.append(KH.head_params(head))
            with jax.default_matmul_precision("highest"):
                want.append(np.asarray(flax_head.apply({"params": tree}, jnp.asarray(x))))
        _FLAX_HEADS[(size, outs)] = (x, heads, want)
    return _FLAX_HEADS[(size, outs)]


@pytest.mark.parametrize("size", PRESETS)
@pytest.mark.parametrize("outs", [(1, 1), (1, 2, 4, 4)], ids=["rough", "precise"])
def test_fused_heads_match_flax(size, outs):
    c = _group(size)[-2]
    x, heads, want = _flax_heads(size, outs)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = KH.fused_rough_heads(xt, *heads) if len(outs) == 2 else KP.fused_precise_heads(xt, heads)
    assert {h["step1.conv.weight"].shape[0] for h in heads} == (
        {c // 2} if len(outs) == 2 else {(c + m) // 2 for m in outs}
    )
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("outs", [(1, 1), (1, 2, 4, 4)], ids=["rough", "precise"])
def test_fused_heads_tf32_twin_matches_flax(outs):
    """The wide heads' single-pass TF32 twin (``fused_*_heads_plain(...,
    tf32=True)``, what the TF32 entries compute) at the base widths against
    the Flax heads at "highest" (the outputs of test_fused_heads_match_flax)
    within TF32_TOL, and farther from them than the f32 twin (it rounds)."""
    x, heads, want = _flax_heads("base", outs)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if len(outs) == 2:
            got = KH.fused_rough_heads_plain(xt, *heads, tf32=True)
            f32 = KH.fused_rough_heads_plain(xt, *heads)
        else:
            got = KP.fused_precise_heads_plain(xt, heads, tf32=True)
            f32 = KP.fused_precise_heads_plain(xt, heads)
    for g, f, w in zip(got, f32, want):
        scale = np.abs(w).max()
        err = np.abs(g.numpy().astype(np.float64) - w).max() / scale
        assert err <= TF32_TOL, err
        assert err > np.abs(f.numpy().astype(np.float64) - w).max() / scale


@pytest.mark.parametrize("size", PRESETS)
def test_fused_neck_tf32_twin_matches_flax(size, monkeypatch):
    """The wide neck level 0's single-pass TF32 twin
    (``fused_neck_l0_plain(..., tf32=True)``, what the TF32 entry computes)
    inside the port's neck against the Flax neck at "highest" within
    TF32_TOL, and farther from it than the f32 twin (it rounds)."""
    group = _group(size)
    cm = group[-2]
    feats = _features(size, 10)
    flax_neck = FlaxFpnNeck(in_channels_group=group, out_channels=cm)
    params = _perturbed(flax_neck.init(jax.random.PRNGKey(11), [jnp.asarray(f) for f in feats])["params"], 12)
    neck = FpnNeck(group, cm)
    neck.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        f32 = KN.fpn_neck_forward_fused(neck.eval(), [torch.from_numpy(f) for f in feats]).numpy()
        # The CPU wrapper's twin, at TF32.
        monkeypatch.setattr(KN, "fused_neck_l0_plain", functools.partial(KN.fused_neck_l0_plain, tf32=True))
        got = KN.fpn_neck_forward_fused(neck.eval(), [torch.from_numpy(f) for f in feats]).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(flax_neck.apply({"params": params}, [jnp.asarray(f) for f in feats]))
    scale = np.abs(want).max()
    err = np.abs(got.astype(np.float64) - want).max() / scale
    assert err <= TF32_TOL, err
    assert err > np.abs(f32.astype(np.float64) - want).max() / scale


@pytest.mark.parametrize("size", PRESETS)
@pytest.mark.parametrize("which", ["rough", "precise"])
def test_forward_from_features_fused_matches_flax(size, which):
    """The fused rough / precise composition (neck level 0 and the heads
    through their kernels' plain twins) against the Flax model's
    forward_*_from_features on random-init weights."""
    feats = _features(size, 5)
    flax_model = FlaxModel(config=FlaxConfig(size=size, neck_head_type="fpn"))
    method = getattr(flax_model, f"forward_{which}_from_features")
    params = _perturbed(
        flax_model.init(jax.random.PRNGKey(6), tuple(jnp.asarray(f) for f in feats), method=method)["params"], 7
    )
    model = AdaptiveScaling(AdaptiveScalingConfig(size=size, neck_head_type="fpn"))
    missing, unexpected = model.load_state_dict(state_dict_from_jax(params), strict=False)
    assert not unexpected and all(k.startswith("backbone.") or "_neck." in k or "_head." in k for k in missing)
    fused = (
        KH.forward_rough_from_features_fused if which == "rough" else KP.forward_precise_from_features_fused
    )
    with torch.no_grad():
        got = fused(model.eval(), [torch.from_numpy(f) for f in feats])
    with jax.default_matmul_precision("highest"):
        want = flax_model.apply({"params": params}, tuple(jnp.asarray(f) for f in feats), method=method)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_heads_pack_is_the_one_pass_pack_of_each_slice(dtype):
    """Heads of F = 258 in two slices of 200: slice s of the packed operand
    (slice-major, the layout of the cluster kernels, one CTA a slice) is the
    one-pass pack of features 200 s .. 200 s + 199 (zero past F), in bf16
    ``packing.pack_sw128``'s swizzled 64-channel chunks as the one-pass
    kernel's."""
    rng = np.random.default_rng(8)
    c, f, m = 32, 258, 4
    p = {
        "step1.conv.weight": torch.from_numpy(rng.standard_normal((f, c, 3, 3)).astype(np.float32)),
        "step1.conv.bias": torch.from_numpy(rng.standard_normal(f).astype(np.float32)),
        "step1.ln.weight": torch.ones(f), "step1.ln.bias": torch.zeros(f),
        "step2.weight": torch.from_numpy(rng.standard_normal((m, f)).astype(np.float32)),
        "step2.bias": torch.zeros(m),
    }
    packed = KH.pack_heads([p], 200, slices=2, dtype=dtype)
    for s in range(2):
        part = {k: v.clone() for k, v in p.items()}
        lo, hi = 200 * s, min(f, 200 * s + 200)
        for name in ("step1.conv.weight", "step1.conv.bias", "step1.ln.weight", "step1.ln.bias"):
            part[name] = p[name][lo:hi]
        part["step2.weight"] = p["step2.weight"][:, lo:hi]
        one = KH.pack_heads([part], 200, slices=1, dtype=dtype)["w"]
        assert torch.equal(packed["w"][s], one)
    assert packed["vec"].shape == (1, 3, 400) and packed["w2"].shape == (1, KH.MAX_OUT, 400)
    assert torch.equal(packed["vec"][0, 0, :f], p["step1.conv.bias"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_neck_pack_is_the_one_pass_pack_of_each_slice(dtype):
    """A neck of Cm = 512, Co = 128 (base): two slices of 256 for step1, one
    CTA of all 128 features for step2, each the layout of one tile of its
    features (f32 ``packing.pack_kmajor`` for conv_gemm.cuh's loop, bf16
    ``packing.pack_sw128``'s 64-channel chunks for the TMA-fed one), with no
    padding past the real widths."""
    rng = np.random.default_rng(9)
    c0, cm, co = 32, 512, 128
    p = {
        "step1_0.conv.weight": torch.from_numpy(rng.standard_normal((cm, c0)).astype(np.float32)),
        "step2_0.conv.weight": torch.from_numpy(rng.standard_normal((co, cm, 3, 3)).astype(np.float32)),
    }
    for step, n in (("step1_0", cm), ("step2_0", co)):
        for part in ("conv.bias", "ln.weight", "ln.bias"):
            p[f"{step}.{part}"] = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    packed = KN.pack_neck(p, dtype)
    bf16 = dtype == torch.bfloat16
    kc = packing.KC_TMA if bf16 else packing.KC
    taps1 = torch.zeros(1, -(-c0 // kc) * kc, cm)
    taps1[0, :c0] = p["step1_0.conv.weight"].t()
    taps2 = p["step2_0.conv.weight"].permute(2, 3, 1, 0).reshape(9, cm, co)
    for s in range(2):
        one1 = packing.pack_for(taps1[..., s * 256:(s + 1) * 256], dtype, bf16)
        assert torch.equal(packed["w1"][s], one1)
    assert torch.equal(packed["w2"], packing.pack_for(taps2, dtype, bf16))
    assert packed["vec1"].shape == (3, 512) and packed["vec2"].shape == (3, 128)
