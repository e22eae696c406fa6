"""The port's UPerNeXt neck and head, its resize primitives and the UPerNeXt
AdaptiveScaling model against the JAX package on the CPU: Flax-initialised
weights carried across with ``state_dict_from_jax``, inputs from a numpy
seed. Bars: the resize primitives 2e-5 (the same weights, other summation
order); modules and models 1e-3 (the repo's model-parity bar)."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adascale.models import AdaptiveScaling as JaxModel
from adascale.models import AdaptiveScalingConfig as JaxConfig
from adascale.models import upernext as J
from adascale.ops import resize as JR
from adascale_torch.models import upernext as T
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from adascale_torch.ops import resize as TR
from adascale_torch.utils.params import load_npz, state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO_SPEC = ((8, 1), (16, 1), (32, 1), (64, 1))
RESIZE_TOL = 2e-5
TOL = 1e-3


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "hw,out_hw",
    [((1, 1), (5, 7)), ((1, 4), (3, 9)), ((7, 9), (14, 18)), ((13, 11), (5, 4)),
     ((6, 6), (6, 6)), ((5, 8), (17, 3)), ((9, 7), (1, 1))],
)
def test_resize_bilinear_matches_jax(hw, out_hw):
    x = _rand(0, 2, *hw, 3)
    want = np.asarray(JR.resize_bilinear(jnp.asarray(x), out_hw))
    got = TR.resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=RESIZE_TOL)


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (6, 6), (7, 13), (20, 15)])
def test_adaptive_avg_pool_matches_jax(hw):
    x = _rand(1, 2, *hw, 5)
    for scale in T.PPM_SCALES:
        want = np.asarray(JR.adaptive_avg_pool(jnp.asarray(x), scale))
        got = TR.adaptive_avg_pool(torch.from_numpy(x), scale).numpy()
        assert got.shape == want.shape == (2, scale, scale, 5)
        np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=RESIZE_TOL)


def _pyramid(seed, b=2, hw=(24, 20), channels=(8, 16, 32, 64)):
    return [_rand(seed + i, b, -(-hw[0] // 2**i), -(-hw[1] // 2**i), c) for i, c in enumerate(channels)]


def _flax_pair(jmod, tmod, args, seed):
    """Flax-initialise ``jmod`` on ``args``, carry the weights into
    ``tmod`` (strict) and return both outputs."""
    jargs = [jax.tree_util.tree_map(jnp.asarray, a) for a in args]
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed), *jargs)["params"]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(params, *jargs))
    tmod.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    with torch.no_grad():
        targs = [[torch.from_numpy(v) for v in a] if isinstance(a, list) else torch.from_numpy(a) for a in args]
        got = tmod(*targs).numpy()
    return got, want


@pytest.mark.parametrize("block", ["conv1x1", "conv3x3", "ppm", "neck", "head_x1", "head_x2", "head_x3"])
def test_upernext_modules_match_flax(block):
    x = _rand(3, 2, 9, 11, 16)
    if block == "conv1x1":
        jmod, tmod, args = J.UConv1x1Block(12), T.Conv1x1Block(16, 12), [x]
    elif block == "conv3x3":
        jmod, tmod, args = J.UConv3x3Block(12), T.ConvKxKBlock(16, 12, 3), [x]
    elif block == "ppm":
        jmod, tmod, args = J.PpmBlock(8), T.PpmBlock(16, 8), [x]
    elif block == "neck":
        jmod, tmod, args = J.UperNextNeck((8, 16, 32, 64), 32), T.UperNextNeck((8, 16, 32, 64), 32), [_pyramid(4)]
    else:
        f = int(block[-1])
        jmod, tmod, args = J.UperNextHead(4, upsampling_factor=f), T.UperNextHead(16, 4, f), [x]
    got, want = _flax_pair(jmod, tmod, args, seed=5)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def micro_models():
    """The UPerNeXt micro model, Flax-initialised, in both packages; the
    layer scales drawn around 0.5 instead of 1e-6 so that the blocks count."""
    cfg = JaxConfig(custom_block_channels_and_num_layers=MICRO_SPEC, neck_head_type="upernext")
    jm = JaxModel(config=cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: rng.uniform(0.25, 0.75, v.shape).astype(np.float32)
        if "block_scale" in jax.tree_util.keystr(path) else v,
        params,
    )
    tm = AdaptiveScaling(
        AdaptiveScalingConfig(custom_block_channels_and_num_layers=MICRO_SPEC, neck_head_type="upernext")
    )
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("hw", [(64, 64), (96, 160)])
def test_upernext_model_forwards_match_flax(micro_models, hw):
    jm, params, tm = micro_models
    x = (np.random.default_rng(6).standard_normal((1, *hw, 3)) * 60 + 128).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(
            lambda p, x: list(jm.apply({"params": p}, x, method=jm.forward_rough))
            + list(jm.apply({"params": p}, x, method=jm.forward_precise))
        )(params, jnp.asarray(x))
    with torch.no_grad():
        got = list(tm.forward_rough(torch.from_numpy(x))) + list(tm.forward_precise(torch.from_numpy(x)))
    assert len(got) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


def test_upernext_height_head_bias_init():
    tm = AdaptiveScaling(
        AdaptiveScalingConfig(custom_block_channels_and_num_layers=MICRO_SPEC, neck_head_type="upernext")
    )
    assert torch.all(tm.rough_char_height_head.step2.bias == 8.0)
    assert isinstance(tm.rough_neck, T.UperNextNeck) and isinstance(tm.precise_char_prob_head, T.UperNextHead)


def test_upernext_flagship_loads_strict():
    params = load_npz(os.path.join(ROOT, "examples/flagship_upernext/flagship_upernext_params.f16.npz"))
    tm = AdaptiveScaling(AdaptiveScalingConfig(size="tiny", neck_head_type="upernext"))
    result = tm.load_state_dict(state_dict_from_jax(params), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
