"""The fused neck and heads at the widths of the ``base`` and ``large``
backbones (neck Cm 512 / 768, Co 128 / 192; heads F 256-258 / 384-386),
where the kernels split the features into slices of their tiles: the port's
fused functions (their plain twins on the CPU) against the Flax ``FpnNeck``,
``FpnHead`` and ``forward_rough_from_features`` /
``forward_precise_from_features`` on random-init weights from a seed, at
small spatial shapes, f32 at 1e-3 (the full-model bar). Also the packed
layouts of a sliced neck and heads: each slice is the one-pass layout of its
features. The kernels themselves run only on the card (``chip_smoke.py``
phase widths)."""
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
from adascale_torch.ops.fused_upsample import phase_tap_weights
from adascale_torch.utils.params import state_dict_from_jax

TOL = 1e-3
PRESETS = ["base", "large"]


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
    assert KN.slices(cm, cm // len(group)) == {"base": (2, 2), "large": (2, 2)}[size]
    with torch.no_grad():
        got = KN.fpn_neck_forward_fused(neck.eval(), [torch.from_numpy(f) for f in feats])
    with jax.default_matmul_precision("highest"):
        want = flax_neck.apply({"params": params}, [jnp.asarray(f) for f in feats])
    _close(got.numpy(), want)


@pytest.mark.parametrize("size", PRESETS)
@pytest.mark.parametrize("outs", [(1, 1), (1, 2, 4, 4)], ids=["rough", "precise"])
def test_fused_heads_match_flax(size, outs):
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
            want.append(flax_head.apply({"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = KH.fused_rough_heads(xt, *heads) if len(outs) == 2 else KP.fused_precise_heads(xt, heads)
    assert {h["step1.conv.weight"].shape[0] for h in heads} == (
        {c // 2} if len(outs) == 2 else {(c + m) // 2 for m in outs}
    )
    for g, w in zip(got, want):
        _close(g.numpy(), w)


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
    is the one-pass pack of features 200 s .. 200 s + 199 (zero past F); in
    bf16, where the one-pass kernel reads 64-channel swizzled chunks
    (``packing.pack_sw128``), the K-major pack of that slice's collapsed
    taps that the sliced kernel reads (``packing.pack_kmajor_bf16``)."""
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
        if dtype == torch.float32:
            one = KH.pack_heads([part], 200, slices=1, dtype=dtype)["w"]
        else:
            taps = torch.zeros(1, 4, 4, c, 200)
            taps[0, ..., : hi - lo] = phase_tap_weights(part["step1.conv.weight"])
            one = packing.pack_kmajor_bf16(taps)
        assert torch.equal(packed["w"][:, s], one)
    assert packed["vec"].shape == (1, 3, 400) and packed["w2"].shape == (1, KH.MAX_OUT, 400)
    assert torch.equal(packed["vec"][0, 0, :f], p["step1.conv.bias"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_neck_pack_is_the_one_pass_pack_of_each_slice(dtype):
    """A neck of Cm = 512, Co = 128 (base): two slices of 384 for step1 and
    two of 96 for step2, each the one-pass layout of its features."""
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
    kc = packing.KC
    taps1 = torch.zeros(1, c0, 2 * KN.MID_WIDTH)
    taps1[0, :, :cm] = p["step1_0.conv.weight"].t()
    taps2 = torch.zeros(9, cm, 2 * KN.OUT_WIDTH)
    taps2[:, :, :co] = p["step2_0.conv.weight"].permute(2, 3, 1, 0).reshape(9, cm, co)
    for s in range(2):
        one1 = packing.pack_for(taps1[..., s * KN.MID_WIDTH:(s + 1) * KN.MID_WIDTH], dtype)
        one2 = packing.pack_for(taps2[..., s * KN.OUT_WIDTH:(s + 1) * KN.OUT_WIDTH], dtype)
        assert torch.equal(packed["w1"][s], one1) and torch.equal(packed["w2"][s], one2)
    assert c0 % kc == 0 and packed["vec1"].shape == (3, 768) and packed["vec2"].shape == (3, 192)


def test_bf16_pack_is_kmajor_core_matrices():
    """``pack_kmajor_bf16``: element (k, n) of a chunk sits at row group
    n // 8, K group (k % 32) // 8, row n % 8, K k % 8, in bf16."""
    taps = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
    packed = packing.pack_kmajor_bf16(taps)
    assert packed.dtype == torch.bfloat16 and packed.shape == (2, 2, 4, 8, 8)
    for k, n in [(0, 0), (9, 3), (31, 15), (40, 8), (63, 7)]:
        assert packed[k // 32, n // 8, (k % 32) // 8, n % 8, k % 8] == taps[k, n].to(torch.bfloat16)


@pytest.mark.parametrize("size", PRESETS)
@pytest.mark.parametrize("which", ["rough", "precise"])
def test_wide_heads_workspace_is_one_chunk_at_any_batch(size, which):
    """The wide heads' workspace (heads x 4 phases x chunk x slices x tile
    f32) holds one chunk of pixels in whole tiles, within
    WIDE_WORKSPACE_BYTES, from one tile of pixels up to the largest group
    of tiles that tiled.max_group_batch lets through (64 tiles of 768, a
    192x192 level 0 each)."""
    from adascale_torch.inference.tiled import max_group_batch

    heads = 2 if which == "rough" else 4
    f = _group(size)[-2] // 2 + 2
    tile = {"rough": 192, "precise": 200}[which]
    fp = -(-f // tile) * tile
    group = max_group_batch((768, 768)) * 192 * 192
    for npix in (1, 127, 128, 6144, group):
        chunk = KH.wide_chunk_pixels(heads, fp, npix)
        assert chunk % KH.TILE_ROWS == 0 and KH.TILE_ROWS <= chunk < npix + KH.TILE_ROWS, (npix, chunk)
        assert heads * 4 * chunk * fp * 4 <= max(KH.WIDE_WORKSPACE_BYTES, heads * 4 * KH.TILE_ROWS * fp * 4)
    assert -(-group // KH.wide_chunk_pixels(heads, fp, group)) > 1
