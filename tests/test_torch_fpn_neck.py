"""The port's FPN neck level-0 chain: the plain version against the JAX
package's Pallas kernel in interpret mode, and the fused composition against
the Flax ``FpnNeck`` and the JAX fused composition (tolerance 2e-5, f32 with
a different summation order). On the card, the CUDA kernel against the
plain version."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adascale.models.fpn import FpnNeck as FlaxFpnNeck
from adascale.ops.pallas.fpn_neck import fpn_neck_forward_fused as jax_fpn_neck_forward_fused
from adascale.ops.pallas.fpn_neck import fused_neck_l0 as jax_fused_neck_l0
from adascale_torch.kernels import fpn_neck as K
from adascale_torch.models.fpn import FpnNeck
from adascale_torch.utils.params import state_dict_from_jax

TOL = 2e-5
CHANS = (8, 16, 32, 64)
OUT = 32


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _case(hw0, seed=0):
    """Flax neck params with every leaf perturbed (so that the LN scales and
    biases count), the port's neck on the same weights, numpy features."""
    rng = np.random.default_rng(seed)
    h0, w0 = hw0
    feats = [
        rng.standard_normal((1, max(1, h0 // 2**i), max(1, w0 // 2**i), c)).astype(np.float32)
        for i, c in enumerate(CHANS)
    ]
    flax_neck = FlaxFpnNeck(in_channels_group=CHANS, out_channels=OUT)
    params = flax_neck.init(jax.random.PRNGKey(seed), [jnp.asarray(f) for f in feats])["params"]
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.1, a.shape)).astype(np.float32), params
    )
    neck = FpnNeck(CHANS, OUT)
    neck.load_state_dict(state_dict_from_jax(params), strict=True)
    return flax_neck, params, neck.eval(), feats


@pytest.mark.parametrize("hw0", [(16, 16), (13, 19)])
def test_plain_l0_matches_pallas_interpret(hw0):
    _, params, neck, feats = _case(hw0)
    f0 = feats[0]
    u = np.random.default_rng(1).standard_normal((*f0.shape[:3], OUT)).astype(np.float32)
    with torch.no_grad():
        got = K.fused_neck_l0_plain(
            torch.from_numpy(f0), torch.from_numpy(u), K.level0_params(neck)
        ).numpy()
    s1, s2 = params["step1_0"], params["step2_0"]
    want = jax_fused_neck_l0(
        jnp.asarray(f0), jnp.asarray(u),
        s1["conv"]["kernel"], s1["conv"]["bias"], s1["ln"]["scale"], s1["ln"]["bias"],
        s2["conv"]["kernel"], s2["conv"]["bias"], s2["ln"]["scale"], s2["ln"]["bias"],
        tile_h=6, interpret=True,
    )
    assert got.shape == want.shape == (*f0.shape[:3], OUT // len(CHANS))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("hw0", [(16, 16), (13, 19)])
def test_fused_neck_matches_flax(hw0):
    flax_neck, params, neck, feats = _case(hw0)
    with torch.no_grad():
        got = K.fpn_neck_forward_fused(neck, [torch.from_numpy(f) for f in feats]).numpy()
    with jax.default_matmul_precision("highest"):
        want = jax.jit(flax_neck.apply)({"params": params}, [jnp.asarray(f) for f in feats])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_fused_neck_matches_jax_fused_composition():
    _, params, neck, feats = _case((13, 19), seed=2)
    with torch.no_grad():
        got = K.fpn_neck_forward_fused(neck, [torch.from_numpy(f) for f in feats]).numpy()
    with jax.default_matmul_precision("highest"):
        want = jax_fpn_neck_forward_fused(
            params, [jnp.asarray(f) for f in feats], dtype=jnp.float32, tile_h=6, interpret=True
        )
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_wrapper_on_cpu_runs_plain_without_counting():
    _, _, neck, feats = _case((16, 16))
    f0 = torch.from_numpy(feats[0])
    u = torch.randn(*f0.shape[:3], OUT)
    p = K.level0_params(neck)
    before = K.LAUNCHES
    with torch.no_grad():
        got = K.fused_neck_l0(f0, u, p)
        want = K.fused_neck_l0_plain(f0, u, p)
    assert K.LAUNCHES == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16, 8, 32, 8), (13, 19, 96, 384, 96)])
def test_cuda_kernel_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, c0, cm, co = shape
    torch.manual_seed(0)
    neck = FpnNeck((c0, 2 * c0, 4 * c0, 8 * c0), cm).cuda().eval()
    p = K.level0_params(neck)
    f0 = torch.randn(2, h, w, c0, device="cuda")
    u = torch.randn(2, h, w, cm, device="cuda")
    before = K.LAUNCHES
    with torch.no_grad():
        got = K.fused_neck_l0(f0, u, p)
        torch.cuda.synchronize()
        want = K.fused_neck_l0_plain(f0, u, p)
    assert K.LAUNCHES == before + 1
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-5, err
