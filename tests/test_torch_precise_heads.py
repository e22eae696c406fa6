"""The port's four precise heads: the plain version against the JAX
package's Pallas kernel in interpret mode and the Flax ``FpnHead``s computed
the long way (nearest-x2 upsample, then the 3x3), and the fused precise
composition against the Flax model and the JAX fused composition (tolerance
2e-5, f32 with a different summation order). Micro widths: neck output 32 channels, head inner widths
16/17/18/18. On the card, the CUDA kernel against the plain version."""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_fpn_heads import TOL, micro_models  # noqa: E402

from adascale.models.fpn import FpnHead as FlaxFpnHead  # noqa: E402
from adascale.ops.pallas.precise_heads import _fused_heads_phases, _interleave, _pack_heads  # noqa: E402
from adascale.ops.pallas.precise_heads import (  # noqa: E402
    forward_precise_from_features_fused as jax_forward_precise_from_features_fused,
)
from adascale_torch.kernels import precise_heads as K  # noqa: E402
from adascale_torch.kernels.fpn_heads import head_params  # noqa: E402
from adascale_torch.models.fpn import FpnHead  # noqa: E402

C = 32
OUTS = (1, 2, 4, 4)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _heads(model):
    return [head_params(getattr(model, name)) for name in K.HEAD_NAMES]


def test_plain_matches_pallas_interpret_and_flax():
    model, _, params = micro_models(5)
    x = np.random.default_rng(6).standard_normal((1, 12, 20, C)).astype(np.float32)
    with torch.no_grad():
        got = K.fused_precise_heads_plain(torch.from_numpy(x), _heads(model))
    tree = [params[name] for name in K.HEAD_NAMES]
    wk, sb, g, bb, w2, b2, bounds, outs = _pack_heads(tree)
    phases = _fused_heads_phases(jnp.asarray(x), wk, sb, g, bb, w2, b2, bounds, tile_h=8, interpret=True)
    mos = np.cumsum([0, *outs])
    want_pallas = [_interleave(phases, lo, hi) for lo, hi in zip(mos[:-1], mos[1:])]
    assert tuple(outs) == OUTS
    with jax.default_matmul_precision("highest"):
        want_flax = [
            FlaxFpnHead(out_channels=m, upsampling_factor=2, fuse_upsample=False).apply(
                {"params": p}, jnp.asarray(x)
            )
            for m, p in zip(OUTS, tree)
        ]
    for g_, wp, wf, m in zip(got, want_pallas, want_flax, OUTS):
        assert tuple(g_.shape) == wp.shape == wf.shape == (1, 24, 40, m)
        np.testing.assert_allclose(g_.numpy(), np.asarray(wp), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g_.numpy(), np.asarray(wf), atol=TOL, rtol=TOL)


def test_forward_precise_fused_matches_model():
    """The fused precise composition (neck level 0 + four heads, softplus on
    the distances) against the Flax model's forward_precise_from_features and
    the JAX package's fused composition (Pallas kernels in interpret mode)."""
    model, flax_model, params = micro_models(7)
    rng = np.random.default_rng(8)
    feats = [
        rng.standard_normal((1, 12 // 2**i or 1, 20 // 2**i or 1, c)).astype(np.float32)
        for i, c in enumerate((8, 16, 32, 64))
    ]
    with torch.no_grad():
        got = K.forward_precise_from_features_fused(model, [torch.from_numpy(f) for f in feats])
    with jax.default_matmul_precision("highest"):
        want = jax.jit(
            lambda p, fs: flax_model.apply({"params": p}, fs, method=flax_model.forward_precise_from_features)
        )(params, tuple(jnp.asarray(f) for f in feats))
        want_pallas = jax_forward_precise_from_features_fused(
            flax_model, params, [jnp.asarray(f) for f in feats], interpret=True
        )
    assert len(got) == len(want) == len(want_pallas) == 4
    for g, w, wp in zip(got, want, want_pallas):
        assert tuple(g.shape) == w.shape == wp.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wp), atol=TOL, rtol=TOL)


def test_wrapper_on_cpu_runs_plain_without_counting():
    model, _, _ = micro_models(9)
    x = torch.randn(1, 13, 19, C)
    before = K.LAUNCHES
    with torch.no_grad():
        got = K.fused_precise_heads(x, _heads(model))
        want = K.fused_precise_heads_plain(x, _heads(model))
    assert K.LAUNCHES == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hwc", [(12, 20, 32), (13, 19, 384)])
def test_cuda_kernel_matches_plain(hwc):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    h, w, c = hwc
    torch.manual_seed(0)
    heads = [head_params(FpnHead(c, m).cuda()) for m in OUTS]
    x = torch.randn(2, h, w, c, device="cuda")
    before = K.LAUNCHES
    with torch.no_grad():
        got = K.fused_precise_heads(x, heads)
        torch.cuda.synchronize()
        want = K.fused_precise_heads_plain(x, heads)
    assert K.LAUNCHES == before + 1
    for g, wt in zip(got, want):
        err = float((g - wt).abs().max()) / float(wt.abs().max())
        assert err <= 1e-5, err
