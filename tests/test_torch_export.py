"""The port's export on the CPU: the block kernel's registered operator, the
shape-agnostic nearest resize, and ``inference/export.py``'s programs held
against the port's eager model and the Flax model.

- ``torch.library.opcheck`` passes on the block operator in f32 and both
  bf16 modes, and the operator computes what the eager wrapper does, bit
  for bit (on the CPU both run the plain twins).
- ``ops/resize.py::resize_nearest`` equals, bit for bit, the version it
  replaced (a copy is kept below) on every shape pair the FPN, UPerNeXt and
  the heads give it at the test, micro and page_0 sizes, and at ratios that
  are not integers.
- A program exported with b, h and w symbolic (FPN through the ``pt2``
  command, UPerNeXt through ``export_program``), saved and loaded back,
  equals the eager model at its example shape and at other B / H / W, and
  stays within 1e-3 of the Flax model (the repo's model bar,
  tests/test_parity_chain.py; measured: the outputs' largest difference is
  printed, about 1e-5 of the largest value).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._dynamo.exc import UserError, UserErrorType
from torch.export import Dim

from adascale.models import AdaptiveScaling as JaxModel
from adascale.models import AdaptiveScalingConfig as JaxConfig
from adascale.models import AdaptiveScalingNeckHeadType, AdaptiveScalingSize
from adascale_torch.cli import main as cli_main
from adascale_torch.inference.export import _export_tier, export_program, load_program
from adascale_torch.kernels import convnext_block as K
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from adascale_torch.ops.resize import resize_nearest
from adascale_torch.tools.export_params import flatten_params
from adascale_torch.utils.config import dump_config
from adascale_torch.utils.params import jax_from_state_dict, state_dict_from_jax

MICRO_SPEC = ((8, 1), (16, 1), (32, 1), (64, 1))
EXAMPLE_HW = (128, 192)
# Shapes each loaded program runs at: its example's, and B = 1 (a batch the
# example did not have) and other H / W.
RUN_SHAPES = [(2, 128, 192, 3), (1, 64, 64, 3), (3, 192, 128, 3)]
# The loaded program against the eager model: the same ops in the same
# order on the CPU, so equal bit for bit; 1e-5 is the card's bar.
EAGER_TOL = 1e-5
# Against Flax (relative to each output's largest value): the repo's
# full-model bar.
FLAX_TOL = 1e-3


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


# ---------------------------------------------------------- block operator


def _block_inputs(mode, seed=0):
    gen = torch.Generator().manual_seed(seed)
    c = 16
    shapes = K._param_shapes(c)
    p = {name: torch.randn(shapes[name], generator=gen) * 0.2 for name in K.PARAM_NAMES}
    p["ln.weight"] = p["ln.weight"] + 1.0
    x = torch.randn(2, 9, 7, c, generator=gen)
    return (x.to(torch.bfloat16) if mode == K.MODE_BF16 else x), p


@pytest.mark.parametrize("mode", [K.MODE_F32, K.MODE_BF16, K.MODE_BF16_MODULE], ids=["f32", "bf16", "bf16_module"])
def test_block_operator_opcheck_and_eager(mode):
    x, p = _block_inputs(mode)
    args = (x, *(p[name] for name in K.PARAM_NAMES), mode)
    torch.library.opcheck(torch.ops.adascale_torch.convnext_block.default, args)
    with torch.no_grad():
        got = torch.ops.adascale_torch.convnext_block(*args)
        want = K.convnext_block(x, p, torch.float32 if mode == K.MODE_F32 else torch.bfloat16)
    assert got.dtype == x.dtype and torch.equal(got, want)


# ---------------------------------------------------------- export tiers


class _Specializes(torch.nn.Module):
    """Fixes its input's second dimension at 128."""

    def forward(self, x):
        return x.reshape(x.shape[0], 128, -1) * 2


class _Adds(torch.nn.Module):
    def forward(self, x):
        return x + 1


def test_export_tier_moves_on_only_for_constraint_errors():
    program, error = _export_tier(_Specializes(), torch.randn(2, 128, 64), {"x": {0: Dim("b"), 1: Dim("h")}})
    assert program is None and error.error_type == UserErrorType.CONSTRAINT_VIOLATION
    program, error = _export_tier(_Adds(), torch.randn(2, 4), {"x": {0: Dim("b")}})
    assert error is None and program is not None
    # A malformed dynamic_shapes spec is the caller's error, not a tier's.
    with pytest.raises(UserError) as raised:
        _export_tier(_Adds(), torch.randn(2, 4), {"y": {0: Dim("b")}})
    assert raised.value.error_type == UserErrorType.INVALID_INPUT


def test_load_program_turns_tf32_off(tmp_path):
    path = str(tmp_path / "adds.pt2")
    torch.export.save(torch.export.export(_Adds(), (torch.randn(2, 4),)), path)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        load_program(path)
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


# ---------------------------------------------------------- resize_nearest


def resize_nearest_before(x, out_hw):
    """``resize_nearest`` as it was: indices built with numpy from concrete
    sizes."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    rows = torch.from_numpy(np.floor(np.arange(oh) * (h / oh)).astype(np.int64))
    cols = torch.from_numpy(np.floor(np.arange(ow) * (w / ow)).astype(np.int64))
    x = x.index_select(1, rows.to(x.device))
    return x.index_select(2, cols.to(x.device))


def _model_resize_pairs():
    """Every (input H, W) -> (output H, W) the FPN neck's ladder and its
    upsample to level 0, UPerNeXt's, and the heads at factors 1-4 ask of a
    nearest resize, for these inputs: the tests' micro shapes, the tiny
    flagship's 640 x 640 export example and page_0's rough input, precise
    FPN and precise UPerNeXt stacks."""
    pairs = set()
    for h, w in [(64, 64), (128, 192), (192, 128), (640, 640), (960, 768), (1024, 832), (1024, 896)]:
        levels = [(h // s, w // s) for s in (4, 8, 16, 32)]
        for k in range(3):
            pairs.add((levels[k + 1], levels[k]))
            pairs.add((levels[k + 1], levels[0]))
        for f in (1, 2, 3, 4):
            pairs.add((levels[0], (levels[0][0] * f, levels[0][1] * f)))
    return sorted(pairs)


def test_resize_nearest_equals_the_numpy_version():
    gen = torch.Generator().manual_seed(0)
    others = [((7, 5), (10, 13)), ((10, 13), (7, 5)), ((30, 24), (61, 47)), ((13, 19), (26, 40)),
              ((9, 6), (3, 2)), ((2, 98), (98, 2)), ((5, 5), (15, 11))]
    pairs = _model_resize_pairs()
    assert len(pairs) > 60
    for (h, w), out_hw in pairs + others:
        x = torch.randn(1, h, w, 2, generator=gen)
        got, want = resize_nearest(x, out_hw), resize_nearest_before(x, out_hw)
        assert got.shape == want.shape and torch.equal(got, want), ((h, w), out_hw)


# ------------------------------------------------------------------ export


def _flax_model_and_params(neck):
    """The Flax model of the micro config and a parameter tree for it: the
    port model's initial parameters (seeded) with every block's layer scale
    drawn from numpy at 0.05-0.2, so that the blocks count."""
    config = JaxConfig(
        size=AdaptiveScalingSize.TINY,
        neck_head_type=AdaptiveScalingNeckHeadType(neck),
        custom_block_channels_and_num_layers=MICRO_SPEC,
    )
    torch.manual_seed(0)
    port = AdaptiveScaling(AdaptiveScalingConfig(neck_head_type=neck, custom_block_channels_and_num_layers=MICRO_SPEC))
    params = jax_from_state_dict(port.state_dict())
    rng = np.random.default_rng(1)
    for stage in params["backbone"].values():
        for layer in stage.values():
            if "block_scale" in layer:
                layer["block_scale"] = rng.uniform(0.05, 0.2, layer["block_scale"].shape).astype(np.float32)
    return JaxModel(config=config), params


@pytest.mark.parametrize("neck,route", [("fpn", "pt2_cli"), ("upernext", "export_program")])
def test_exported_program_matches_eager_and_flax(neck, route, tmp_path):
    flax_model, params = _flax_model_and_params(neck)
    config = AdaptiveScalingConfig(size="tiny", neck_head_type=neck, custom_block_channels_and_num_layers=MICRO_SPEC)
    out = tmp_path / "pt2"
    if route == "pt2_cli":
        np.savez(tmp_path / "params.npz", **flatten_params(params))
        dump_config(config, tmp_path / "model.json")
        cli_main(["pt2", "--checkpoint", str(tmp_path / "params.npz"), "--model-config",
                  str(tmp_path / "model.json"), "--output", str(out), "--device", "cpu"])
        manifest = json.loads((out / "manifest.json").read_text())
    else:
        manifest = export_program(params, config, str(out), example_hw=EXAMPLE_HW, device="cpu")
    assert json.loads((out / "manifest.json").read_text()) == manifest
    assert json.loads((out / "model_config.json").read_text())["neck_head_type"] == neck
    for name in ("forward_rough", "forward_precise"):
        assert manifest[name]["symbolic_axes"] == "b,h,w" and manifest[name]["polymorphic"], manifest

    eager = AdaptiveScaling(config)
    eager.load_state_dict(state_dict_from_jax(params), strict=True)
    eager.eval()
    rng = np.random.default_rng(0)
    for name in ("forward_rough", "forward_precise"):
        program = load_program(str(out / manifest[name]["path"]))
        calls = sum(n.target == torch.ops.adascale_torch.convnext_block.default for n in program.graph.nodes)
        assert calls == len(MICRO_SPEC)  # one operator call a block
        module = program.module()
        for shape in RUN_SHAPES:
            x = rng.uniform(0, 255, shape).astype(np.float32)
            with torch.no_grad():
                got = module(torch.from_numpy(x))
                want = getattr(eager, name)(torch.from_numpy(x))
            for g, w in zip(got, want):
                assert g.shape == w.shape
                eager_rel = float((g - w).abs().max()) / float(w.abs().max())
                print(f"{neck} {name} {shape}: program vs eager {eager_rel:.2e}")
                assert eager_rel <= EAGER_TOL
            if shape == RUN_SHAPES[0]:  # Flax at the example shape
                flax = flax_model.apply({"params": params}, jnp.asarray(x), method=getattr(flax_model, name))
                for g, f in zip(got, flax):
                    f = np.asarray(f)
                    flax_rel = float(np.abs(g.numpy() - f).max()) / float(np.abs(f).max())
                    print(f"{neck} {name} {shape}: program vs Flax {flax_rel:.2e}")
                    assert g.shape == f.shape and flax_rel <= FLAX_TOL
