"""The port's weight loading: every leaf of the committed weight files loads
into the PyTorch modules with the right shape, and the layout conversion is
its own inverse."""
import os

import numpy as np
import pytest
import torch

from adascale.inference.engine import load_params
from adascale.models import AdaptiveScalingConfig as JaxConfig
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from adascale_torch.utils.params import jax_from_state_dict, load_npz, state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "examples/flagship_training/flagship_fpn_params.f16.npz")
MICRO = os.path.join(ROOT, "tests/fixtures/overfit_micro_params.npz")
MICRO_SPEC = ((16, 1), (32, 1), (64, 1), (128, 1))

CASES = {
    "flagship": (FLAGSHIP, AdaptiveScalingConfig(size="tiny"), 280),
    "micro": (MICRO, AdaptiveScalingConfig(custom_block_channels_and_num_layers=MICRO_SPEC), 154),
}


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield prefix + key, value


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_leaf_loads_with_its_shape(name):
    path, config, n_leaves = CASES[name]
    params = load_npz(path)
    assert len(list(_leaves(params))) == n_leaves
    model = AdaptiveScaling(config)
    sd = state_dict_from_jax(params)
    # strict: every port parameter is present and no leaf is left over.
    model.load_state_dict(sd, strict=True)
    for key, tensor in model.state_dict().items():
        assert tensor.dtype == torch.float32
        assert torch.equal(tensor, sd[key]), key


@pytest.mark.parametrize("name", sorted(CASES))
def test_load_npz_matches_jax_loader(name):
    """Same arrays as the JAX engine's own loader (f16 leaves cast to f32)."""
    path, _, _ = CASES[name]
    ours = dict(_leaves(load_npz(path)))
    theirs = dict(_leaves(load_params(path, JaxConfig())))
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key].dtype == np.float32
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_round_trip(name):
    path, _, _ = CASES[name]
    params = load_npz(path)
    back = dict(_leaves(jax_from_state_dict(state_dict_from_jax(params))))
    orig = dict(_leaves(params))
    assert back.keys() == orig.keys()
    for key in orig:
        np.testing.assert_array_equal(back[key], orig[key], err_msg=key)


def test_layout_conversions():
    """HWIO conv -> OIHW, depthwise (7,7,1,C) -> (C,1,7,7), Dense -> Linear,
    LN scale -> weight."""
    params = load_npz(MICRO)
    sd = state_dict_from_jax(params)
    stem = params["backbone"]["stem_conv"]["kernel"]
    np.testing.assert_array_equal(sd["backbone.stem_conv.weight"].numpy(), stem.transpose(3, 2, 0, 1))
    dw = params["backbone"]["stage0"]["layer0"]["dwconv"]["kernel"]
    assert dw.shape == (7, 7, 1, 16)
    assert tuple(sd["backbone.stage0.layer0.dwconv.weight"].shape) == (16, 1, 7, 7)
    up = params["backbone"]["stage0"]["layer0"]["mlp_up"]["kernel"]
    np.testing.assert_array_equal(sd["backbone.stage0.layer0.mlp_up.weight"].numpy(), up.T)
    ln = params["backbone"]["stem_ln"]["scale"]
    np.testing.assert_array_equal(sd["backbone.stem_ln.weight"].numpy(), ln)
