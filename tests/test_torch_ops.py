"""The port's resize/pad ops against ``adascale.ops.resize`` (tolerance
1e-5: f32, different summation order in the area products)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adascale.ops import resize as jr
from adascale_torch.ops import resize as tr

TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "in_hw,out_hw",
    [((8, 8), (16, 16)), ((4, 6), (16, 24)), ((5, 7), (13, 19)), ((13, 19), (5, 7)), ((6, 6), (6, 6))],
)
def test_resize_nearest(in_hw, out_hw):
    x = _x((2, *in_hw, 3))
    want = np.asarray(jr.resize_nearest(jnp.asarray(x), out_hw))
    got = tr.resize_nearest(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "in_hw,out_hw", [((64, 48), (32, 24)), ((1024, 768), (960, 720)), ((37, 53), (20, 29))]
)
def test_area_downsample(in_hw, out_hw):
    x = _x((1, *in_hw, 3)) * 50 + 128
    want = np.asarray(jr.area_downsample(jnp.asarray(x), out_hw))
    got = tr.area_downsample(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * 255)


@pytest.mark.parametrize("n,m", [(1024, 960), (768, 720), (53, 20), (7, 7)])
def test_area_resize_weights(n, m):
    np.testing.assert_array_equal(tr.area_resize_weights(n, m), jr.area_resize_weights(n, m))


@pytest.mark.parametrize("hw", [(64, 64), (65, 97), (13, 19)])
@pytest.mark.parametrize("factor", [32, 64])
def test_pad_to_divisible(hw, factor):
    x = _x((1, *hw, 3))
    want = np.asarray(jr.pad_to_divisible(jnp.asarray(x), downsampling_factor=factor))
    got = tr.pad_to_divisible(torch.from_numpy(x), factor).numpy()
    np.testing.assert_array_equal(got, want)
    for length in hw:
        assert tr.pad_length_to_make_divisible(length, factor) == jr.pad_length_to_make_divisible(
            length, factor
        )
