"""Serialized deployment artifacts: ``torch.export`` programs.

Counterpart of ``adascale/inference/export.py``, which serializes the module
model's ``forward_rough`` and ``forward_precise`` to StableHLO. Here each
pass of the module model ``AdaptiveScaling`` (no fused neck or heads, as
there) is traced by ``torch.export.export`` under ``torch.no_grad()`` and
written by ``torch.export.save`` to ``<name>.pt2``, beside a
``manifest.json`` with the JAX package's keys and a ``model_config.json``.

Every backbone block is the registered operator
``torch.ops.adascale_torch.convnext_block`` in the program, so a program
exported on the card runs the hand-written kernel there, and one exported on
the CPU runs the plain version (the operator dispatches on the device of its
input when the program runs). This module imports the operator's module, so
the operator is registered before ``load_program`` loads a program.

The input's dimensions are tried in tiers, most dynamic first: ``b,h,w``
(any batch; H and W any multiple of 64, the backbone's stride 32 times the
engine's bucket granularity, as in the JAX package), then ``b``, then
static. torch specializes a dimension whose example size is 0 or 1, so the
example input has a batch of 2. Only torch's constraint and guard errors
move to the next tier; the reason is kept in the manifest. Both functions
turn TF32 off for the process (``utils/precision.py``).

The JAX export has no precision knob, so a program computes at "highest":
its blocks are the operator, which always launches the 3xTF32 entry, and
the module of a program that ``load_program`` returns runs inside
``matmul_precision("highest")``, so that its library convolutions stay in
full f32 inside a "default" or "high" scope too.
"""
from __future__ import annotations

import json
import os
from typing import Any, Mapping, Tuple

import torch
from torch import nn
from torch.export import Dim

from ..kernels import convnext_block  # noqa: F401  (registers the block operator)
from ..models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from ..utils.config import config_to_dict
from ..utils.params import state_dict_from_jax
from ..utils.precision import matmul_precision, pin_full_f32

PASSES = ("forward_rough", "forward_precise")
# The largest H or W a b,h,w program takes is 64 * MAX_BLOCKS_64.
MAX_BLOCKS_64 = 256
EXAMPLE_BATCH = 2


class _Pass(nn.Module):
    """One pass of ``model`` as a module's forward, for ``torch.export``."""

    def __init__(self, model: AdaptiveScaling, name: str):
        super().__init__()
        self.model = model
        self.name = name

    def forward(self, x: torch.Tensor):
        return getattr(self.model, self.name)(x)


def _tiers(example_hw: Tuple[int, int], try_dynamic: bool):
    """(symbolic axes, example shape, dynamic_shapes) from most to least
    dynamic."""
    eh, ew = example_hw
    tiers = []
    if try_dynamic:
        b = Dim("b", min=1, max=1024)
        if eh % 64 == 0 and ew % 64 == 0:
            h, w = Dim("h", min=1, max=MAX_BLOCKS_64), Dim("w", min=1, max=MAX_BLOCKS_64)
            tiers.append(("b,h,w", (EXAMPLE_BATCH, eh, ew, 3), {"x": {0: b, 1: 64 * h, 2: 64 * w}}))
        tiers.append(("b", (EXAMPLE_BATCH, eh, ew, 3), {"x": {0: b}}))
    tiers.append(("", (1, eh, ew, 3), None))
    return tiers


def _export_tier(module: nn.Module, x: torch.Tensor, dynamic_shapes):
    """``torch.export.export`` of ``module`` on ``x`` under ``no_grad``:
    the program, or ``None`` and the error where a dimension that the trace
    could not keep symbolic sends the export to the next tier (a constraint
    violation, a guard on data, or torch's user error of the constraint
    kind). Every other error propagates."""
    from torch._dynamo.exc import UserError, UserErrorType
    from torch.fx.experimental.symbolic_shapes import ConstraintViolationError, GuardOnDataDependentSymNode

    try:
        with torch.no_grad():
            return torch.export.export(module, (x,), dynamic_shapes=dynamic_shapes), None
    except (ConstraintViolationError, GuardOnDataDependentSymNode) as e:
        return None, e
    except UserError as e:
        if e.error_type != UserErrorType.CONSTRAINT_VIOLATION:
            raise
        return None, e


def export_program(
    params: Mapping[str, Any],
    model_config: AdaptiveScalingConfig,
    output_folder: str,
    example_hw: Tuple[int, int] = (640, 640),
    try_dynamic: bool = True,
    device: str = "cuda",
) -> dict:
    """Export ``forward_rough`` and ``forward_precise`` of the f32 module
    model with ``params`` (the JAX package's nested tree, numpy leaves) on
    ``device`` to ``<output_folder>/<pass>.pt2``. Returns the manifest,
    ``{pass: {path, polymorphic, symbolic_axes, example_hw[,
    polymorphic_fallback_reason]}}``, also written to ``manifest.json``
    beside ``model_config.json``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to export a program of the plain versions"
        )
    pin_full_f32()
    model = AdaptiveScaling(model_config)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model = model.to(device).eval()
    os.makedirs(output_folder, exist_ok=True)
    gen = torch.Generator().manual_seed(0)

    manifest = {}
    for name in PASSES:
        module = _Pass(model, name)
        program, symbolic_axes, last_error = None, "", None
        for axes, shape, dynamic_shapes in _tiers(example_hw, try_dynamic):
            x = (torch.rand(shape, generator=gen) * 255).to(device)
            program, error = _export_tier(module, x, dynamic_shapes)
            if program is not None:
                symbolic_axes = axes
                break
            last_error = error
        if program is None:
            raise RuntimeError(f"export failed for {name} even with static shapes") from last_error
        path = os.path.join(output_folder, f"{name}.pt2")
        torch.export.save(program, path)
        manifest[name] = {
            "path": os.path.basename(path),
            "polymorphic": bool(symbolic_axes),
            "symbolic_axes": symbolic_axes,
            "example_hw": list(example_hw),
        }
        if last_error is not None and symbolic_axes != "b,h,w":
            manifest[name]["polymorphic_fallback_reason"] = f"{type(last_error).__name__}: {last_error}"[:300]

    with open(os.path.join(output_folder, "manifest.json"), "w") as fout:
        json.dump(manifest, fout, indent=2)
    with open(os.path.join(output_folder, "model_config.json"), "w") as fout:
        json.dump(config_to_dict(model_config), fout, indent=2)
    return manifest


class _AtHighest(nn.Module):
    """A loaded program's module, run inside ``matmul_precision("highest")``."""

    def __init__(self, program: nn.Module):
        super().__init__()
        self.program = program

    def forward(self, *args, **kwargs):
        with matmul_precision("highest"):
            return self.program(*args, **kwargs)


def load_program(path: str) -> torch.export.ExportedProgram:
    """Load a ``.pt2`` written by ``export_program``; call it through
    ``.module()(x)`` with x (B, H, W, 3) f32 on the device it was exported
    on (the program holds its parameters there). Turns TF32 off for the
    process (``pin_full_f32``), as the engine does, and ``.module()`` runs
    the program at "highest" whatever ``matmul_precision`` scope it is
    called in, so that the program's library convolutions run at the f32 it
    was exported at."""
    pin_full_f32()
    program = torch.export.load(path)
    unpinned = program.module
    program.module = lambda *args, **kwargs: _AtHighest(unpinned(*args, **kwargs))
    return program

