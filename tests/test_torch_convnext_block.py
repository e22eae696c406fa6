"""The port's ConvNeXt block: the plain PyTorch version against the JAX
package's ``block_xla``, the Flax ``ConvNeXtBlockLayer`` and, once, the
Pallas kernel in interpret mode (tolerance 2e-5, f32 with a different
summation order). On the card, the CUDA kernel against the plain version."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adascale.models.convnext import ConvNeXtBlockLayer
from adascale.ops.pallas import block_xla, fused_convnext_block
from adascale_torch.kernels import convnext_block as K
from adascale_torch.utils.params import state_dict_from_jax

TOL = 2e-5


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _case(c, hw, seed=0):
    """Flax params with a non-trivial layer scale, numpy input."""
    layer = ConvNeXtBlockLayer(channels=c)
    params = layer.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, c)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    params["block_scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    x = rng.standard_normal((2, *hw, c)).astype(np.float32)
    return layer, params, x


def _jax_args(p):
    return (
        p["dwconv"]["kernel"], p["dwconv"]["bias"], p["ln"]["scale"], p["ln"]["bias"],
        p["mlp_up"]["kernel"], p["mlp_up"]["bias"], p["mlp_down"]["kernel"],
        p["mlp_down"]["bias"], p["block_scale"],
    )


@pytest.mark.parametrize("c", [8, 96, 128])
@pytest.mark.parametrize("hw", [(16, 16), (13, 19), (8, 8)])
def test_plain_block_matches_block_xla_and_flax(c, hw):
    layer, params, x = _case(c, hw)
    got = K.convnext_block_plain(torch.from_numpy(x), state_dict_from_jax(params)).numpy()
    with jax.default_matmul_precision("highest"):
        want_xla = np.asarray(block_xla(jnp.asarray(x), *_jax_args(params)))
        want_flax = np.asarray(layer.apply({"params": params}, jnp.asarray(x), True))
    np.testing.assert_allclose(got, want_xla, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, want_flax, atol=TOL, rtol=TOL)


def test_plain_block_matches_pallas_interpret():
    _, params, x = _case(8, (13, 19), seed=1)
    got = K.convnext_block_plain(torch.from_numpy(x), state_dict_from_jax(params)).numpy()
    want = np.asarray(
        fused_convnext_block(jnp.asarray(x), *_jax_args(params), tile_h=8, interpret=True)
    )
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_wrapper_on_cpu_runs_plain_without_counting():
    _, params, x = _case(8, (16, 16))
    p = state_dict_from_jax(params)
    before = K.LAUNCHES
    got = K.convnext_block(torch.from_numpy(x), p)
    assert K.LAUNCHES == before
    torch.testing.assert_close(got, K.convnext_block_plain(torch.from_numpy(x), p), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hwc", [(16, 16, 8), (13, 19, 96), (30, 24, 768), (16, 12, 1024)])
def test_cuda_kernel_matches_plain(hwc):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, c = hwc
    _, params, x = _case(c, (h, w))
    p = {k: v.cuda() for k, v in state_dict_from_jax(params).items()}
    xc = torch.from_numpy(x).cuda()
    before = K.LAUNCHES
    got = K.convnext_block(xc, p)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    want = K.convnext_block_plain(xc, p)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-5, err
