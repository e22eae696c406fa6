"""The port's two rough heads: the phase-collapsed packing and the plain
version against the JAX package's Pallas kernel in interpret mode and the
Flax ``FpnHead`` computed the long way (nearest-x2 upsample, then the 3x3),
and the fused rough composition against the Flax model and the JAX fused
composition (tolerance 2e-5, f32 with a different summation order). On the card, the CUDA kernel against the
plain version."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adascale.models import AdaptiveScaling as FlaxModel
from adascale.models import AdaptiveScalingConfig as FlaxConfig
from adascale.models.fpn import FpnHead as FlaxFpnHead
from adascale.ops.pallas.fpn_heads import _head_leaves, _phase_tap_weights
from adascale.ops.pallas.fpn_heads import (
    forward_rough_from_features_fused as jax_forward_rough_from_features_fused,
)
from adascale.ops.pallas.fpn_heads import fused_rough_heads as jax_fused_rough_heads
from adascale_torch.kernels import fpn_heads as K
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from adascale_torch.models.fpn import FpnHead
from adascale_torch.utils.params import jax_from_state_dict, state_dict_from_jax

TOL = 2e-5
C = 128
MICRO_SPEC = ((8, 1), (16, 1), (32, 1), (64, 1))


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _perturbed(params, rng):
    """Every leaf moved off its init, so that LN scales and biases count."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.1, a.shape)).astype(np.float32), params
    )


def _case(hw, seed=0):
    """Two naive-path Flax heads (mask, height) with perturbed params, the
    port's heads on the same weights, a numpy input."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *hw, C)).astype(np.float32)
    flax_heads, params, heads = [], [], []
    for k, bias in enumerate((0.0, 8.0)):
        head = FlaxFpnHead(out_channels=1, upsampling_factor=2, init_output_bias=bias, fuse_upsample=False)
        p = _perturbed(head.init(jax.random.PRNGKey(seed + k), jnp.asarray(x))["params"], rng)
        port = FpnHead(C, 1)
        port.load_state_dict(state_dict_from_jax(p), strict=True)
        flax_heads.append(head)
        params.append(p)
        heads.append(K.head_params(port))
    return x, flax_heads, params, heads


def test_phase_tap_weights_match_jax():
    k = np.random.default_rng(0).standard_normal((3, 3, 12, 7)).astype(np.float32)
    got = K.phase_tap_weights(torch.from_numpy(k.transpose(3, 2, 0, 1).copy())).numpy()
    want = np.asarray(_phase_tap_weights(jnp.asarray(k))).reshape(4, 4, 12, 7)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(16, 16), (13, 19)])
def test_plain_matches_pallas_interpret_and_flax(hw):
    x, flax_heads, params, heads = _case(hw)
    with torch.no_grad():
        got = K.fused_rough_heads_plain(torch.from_numpy(x), *heads)
    want_pallas = jax_fused_rough_heads(
        jnp.asarray(x), *_head_leaves(params[0]), *_head_leaves(params[1]), tile_h=8, interpret=True
    )
    with jax.default_matmul_precision("highest"):
        want_flax = [h.apply({"params": p}, jnp.asarray(x)) for h, p in zip(flax_heads, params)]
    for g, wp, wf in zip(got, want_pallas, want_flax):
        assert tuple(g.shape) == wp.shape == wf.shape == (2, 2 * hw[0], 2 * hw[1], 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(wp), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wf), atol=TOL, rtol=TOL)


def micro_models(seed):
    """The port's micro model with every weight perturbed off its init, and
    the Flax model with its parameter tree on the same weights."""
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    model = AdaptiveScaling(AdaptiveScalingConfig(custom_block_channels_and_num_layers=MICRO_SPEC))
    sd = {
        k: v + torch.from_numpy(rng.normal(0.0, 0.1, tuple(v.shape)).astype(np.float32))
        for k, v in model.state_dict().items()
    }
    model.load_state_dict(sd, strict=True)
    cfg = FlaxConfig(size="tiny", neck_head_type="fpn", custom_block_channels_and_num_layers=MICRO_SPEC)
    return model.eval(), FlaxModel(config=cfg), jax_from_state_dict(sd)


def test_forward_rough_fused_matches_model():
    """The fused rough composition (neck level 0 + both heads) against the
    Flax model's forward_rough_from_features and the JAX package's fused
    composition (Pallas kernels in interpret mode) on micro weights."""
    model, flax_model, params = micro_models(3)
    rng = np.random.default_rng(4)
    feats = [
        rng.standard_normal((1, 16 // 2**i, 16 // 2**i, c)).astype(np.float32)
        for i, c in enumerate((8, 16, 32, 64))
    ]
    with torch.no_grad():
        got = K.forward_rough_from_features_fused(model, [torch.from_numpy(f) for f in feats])
    with jax.default_matmul_precision("highest"):
        want = jax.jit(
            lambda p, fs: flax_model.apply({"params": p}, fs, method=flax_model.forward_rough_from_features)
        )(params, tuple(jnp.asarray(f) for f in feats))
        want_pallas = jax_forward_rough_from_features_fused(
            flax_model, params, [jnp.asarray(f) for f in feats], interpret=True
        )
    assert len(got) == len(want) == len(want_pallas) == 2
    for g, w, wp in zip(got, want, want_pallas):
        assert tuple(g.shape) == w.shape == wp.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wp), atol=TOL, rtol=TOL)


def test_wrapper_on_cpu_runs_plain_without_counting():
    x, _, _, heads = _case((13, 19))
    before = K.LAUNCHES
    with torch.no_grad():
        got = K.fused_rough_heads(torch.from_numpy(x), *heads)
        want = K.fused_rough_heads_plain(torch.from_numpy(x), *heads)
    assert K.LAUNCHES == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hwc", [(16, 16, 32), (13, 19, 384)])
def test_cuda_kernel_matches_plain(hwc):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, c = hwc
    torch.manual_seed(0)
    heads = [K.head_params(FpnHead(c, 1).cuda()) for _ in range(2)]
    x = torch.randn(2, h, w, c, device="cuda")
    before = K.LAUNCHES
    with torch.no_grad():
        got = K.fused_rough_heads(x, *heads)
        torch.cuda.synchronize()
        want = K.fused_rough_heads_plain(x, *heads)
    assert K.LAUNCHES == before + 1
    for g, wt in zip(got, want):
        err = float((g - wt).abs().max()) / float(wt.abs().max())
        assert err <= 1e-5, err
