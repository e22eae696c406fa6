"""The port's AdaptiveScaling model against the Flax model: all six heads
on the same weights and input, tolerance 1e-3 (the repo's model-parity bar;
measured ~3e-6 in f32)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adascale.models import AdaptiveScaling as JaxModel
from adascale.models import AdaptiveScalingConfig as JaxConfig
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from adascale_torch.utils.params import jax_from_state_dict

MICRO_SPEC = ((8, 1), (16, 1), (32, 1), (64, 1))
TOL = 1e-3


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    """Seeded weights shared by both models (numpy in between); a layer
    scale around 0.5 instead of the 1e-6 init, so that the blocks count."""
    torch.manual_seed(0)
    tm = AdaptiveScaling(AdaptiveScalingConfig(custom_block_channels_and_num_layers=MICRO_SPEC))
    sd = tm.state_dict()
    rng = np.random.default_rng(0)
    for key in sd:
        if key.endswith("block_scale"):
            sd[key] = torch.from_numpy(rng.uniform(0.25, 0.75, sd[key].shape).astype(np.float32))
    tm.load_state_dict(sd, strict=True)
    jm = JaxModel(config=JaxConfig(custom_block_channels_and_num_layers=MICRO_SPEC))
    params = jax_from_state_dict(sd)

    @jax.jit
    def jax_heads(x):
        with jax.default_matmul_precision("highest"):
            rough = jm.apply({"params": params}, x, method=jm.forward_rough)
            precise = jm.apply({"params": params}, x, method=jm.forward_precise)
        return list(rough) + list(precise)

    return jax_heads, tm.eval()


@pytest.mark.parametrize("hw", [(64, 64), (96, 160)])
def test_six_heads_match_flax(models, hw):
    jax_heads, tm = models
    x = (np.random.default_rng(1).standard_normal((1, *hw, 3)) * 60 + 128).astype(np.float32)
    want = jax_heads(jnp.asarray(x))
    with torch.no_grad():
        got = list(tm.forward_rough(torch.from_numpy(x)))
        got += list(tm.forward_precise(torch.from_numpy(x)))
    assert len(got) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


def test_from_features_matches_full_forward(models):
    _, tm = models
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 64, 96, 3)).astype(np.float32))
    with torch.no_grad():
        feats = tm.backbone(x)
        for a, b in zip(tm.forward_rough(x), tm.forward_rough_from_features(feats)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for a, b in zip(tm.forward_precise(x), tm.forward_precise_from_features(feats)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flagship_tiny_heads_match_flax_at_64px():
    """The tiny/FPN flagship's own weights, at 64 px."""
    import os

    from adascale_torch.utils.params import load_npz, state_dict_from_jax

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = load_npz(os.path.join(root, "examples/flagship_training/flagship_fpn_params.f16.npz"))
    tm = AdaptiveScaling(AdaptiveScalingConfig(size="tiny"))
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    jm = JaxModel(config=JaxConfig(size="tiny"))
    x = (np.random.default_rng(3).standard_normal((1, 64, 64, 3)) * 60 + 128).astype(np.float32)

    @jax.jit
    def jax_heads(x):
        with jax.default_matmul_precision("highest"):
            rough = jm.apply({"params": params}, x, method=jm.forward_rough)
            precise = jm.apply({"params": params}, x, method=jm.forward_precise)
        return list(rough) + list(precise)

    want = jax_heads(jnp.asarray(x))
    with torch.no_grad():
        got = list(tm.eval().forward_rough(torch.from_numpy(x)))
        got += list(tm.forward_precise(torch.from_numpy(x)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("factor", [1, 2, 3, 4])
def test_fpn_head_matches_flax(factor):
    """``FpnHead`` against the Flax head at each upsampling factor Flax takes:
    1 (3x3), 2 (nearest-x2 then 3x3 as four collapsed phases, Flax's
    default), 3 and 4 (nearest upsample then 5x5)."""
    from adascale.models.fpn import FpnHead as JaxFpnHead
    from adascale_torch.models.fpn import FpnHead
    from adascale_torch.utils.params import state_dict_from_jax

    c, m = 16, 4
    x = np.random.default_rng(4).standard_normal((2, 6, 7, c)).astype(np.float32)
    head = JaxFpnHead(out_channels=m, upsampling_factor=factor)
    params = head.init(jax.random.PRNGKey(factor), jnp.asarray(x))["params"]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(head.apply({"params": params}, jnp.asarray(x)))
    th = FpnHead(c, m, factor)
    th.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = th(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 6 * factor, 7 * factor, m)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

