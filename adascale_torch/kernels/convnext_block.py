"""The ConvNeXt residual block: a hand-written CUDA kernel and its plain twin.

``convnext_block(x, p)`` computes one deterministic ConvNeXt block on an
NHWC f32 tensor::

    out = x + scale * (W2 · GELU(W1 · LN(dwconv7x7(x) + dw_b) + b1) + b2)

It replaces the Pallas TPU kernel
``adascale/ops/pallas/convnext_block.py::fused_convnext_block``. On a CUDA
tensor it launches ``csrc/convnext_block.cu``: the depthwise 7x7 + LayerNorm
from shared-memory row tiles, then the two projections as tiled tensor-core
GEMMs at f32 accuracy (an error-compensated 3xTF32 split), the first with the
GELU in its epilogue, the second with ``* scale + x`` (split over K, with a
fixed-order reduction, for the small late stages).
On a CPU tensor it runs ``convnext_block_plain``, the eager PyTorch version
that the tests and ``chip_smoke.py`` hold the kernel against.

Training goes through ``TrainableBlock``, the counterpart of
``adascale/ops/pallas/convnext_block.py::make_trainable_block``: an
``autograd.Function`` whose forward is the kernel (the plain version on the
CPU) and which saves only its inputs; its backward re-runs the plain version
and differentiates it, so no activation inside a block is kept. The JAX
package has no backward kernel, and neither has the port. ``convnext_block``
routes a call through it whenever grad is enabled and an input requires
grad, so a launch never drops the graph.

The kernel is built on first use by ``_nvcc.build`` (``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``): no PyTorch headers,
so the build takes seconds.

``p`` holds the block's parameters in PyTorch layout, as the port's
``ConvNeXtBlock.state_dict()`` does: ``dwconv.weight`` (C, 1, 7, 7),
``dwconv.bias``, ``ln.weight``, ``ln.bias``, ``mlp_up.weight`` (4C, C),
``mlp_up.bias``, ``mlp_down.weight`` (C, 4C), ``mlp_down.bias`` and
``block_scale`` (C,). The kernel reads them in these layouts.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from . import _nvcc

# Number of kernel launches, counted once per call (the call's three or four
# CUDA launches together). Plain integer, reset by whoever counts a run.
LAUNCHES = 0

MAX_CHANNELS = 1536
EPS = 1e-6


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _nvcc.build("convnext_block", "convnext_block.cu")
    fn = lib.convnext_block_f32
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.convnext_block_f32_workspace
    ws.argtypes = [ctypes.c_int] * 5
    ws.restype = ctypes.c_longlong
    return lib


def convnext_block_plain(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eager PyTorch twin of the kernel (NHWC in, NHWC out)."""
    c = x.shape[-1]
    y = F.conv2d(
        x.permute(0, 3, 1, 2), p["dwconv.weight"], p["dwconv.bias"], padding=3, groups=c
    ).permute(0, 2, 3, 1)
    y = F.layer_norm(y, (c,), p["ln.weight"], p["ln.bias"], eps=EPS)
    y = F.gelu(F.linear(y, p["mlp_up.weight"], p["mlp_up.bias"]), approximate="none")
    y = F.linear(y, p["mlp_down.weight"], p["mlp_down.bias"])
    return x + y * p["block_scale"]


PARAM_NAMES = (
    "dwconv.weight", "dwconv.bias", "ln.weight", "ln.bias", "mlp_up.weight",
    "mlp_up.bias", "mlp_down.weight", "mlp_down.bias", "block_scale",
)


def convnext_block(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One ConvNeXt block on an NHWC f32 tensor: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor. Where grad is enabled and
    ``x`` or a parameter requires grad, the call goes through
    ``TrainableBlock``, so that the result carries its gradient."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"convnext_block: unsupported device {x.device}")
    if torch.is_grad_enabled() and (
        x.requires_grad or any(p[name].requires_grad for name in PARAM_NAMES)
    ):
        return TrainableBlock.apply(x, *(p[name] for name in PARAM_NAMES))
    if x.device.type == "cpu":
        return convnext_block_plain(x, p)
    return _launch(x, p)


class TrainableBlock(torch.autograd.Function):
    """The block with a gradient: the kernel forward (the plain version on
    the CPU), saving only the inputs; the backward recomputes
    ``convnext_block_plain`` and differentiates it, as ``make_trainable_block``
    does with ``jax.vjp(block_xla)``. Arguments: ``x`` and the nine
    parameters in ``PARAM_NAMES`` order; the gradients come back in the
    parameters' own layouts."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, *params)
        p = dict(zip(PARAM_NAMES, params))
        if x.device.type == "cpu":
            return convnext_block_plain(x, p)
        return _launch(x, p)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        with torch.profiler.record_function("convnext_block.backward"), torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = convnext_block_plain(inputs[0], dict(zip(PARAM_NAMES, inputs[1:])))
            return torch.autograd.grad(out, inputs, grad)


def _launch(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor; raises on what it does not take."""
    global LAUNCHES
    _nvcc.check_activation("convnext_block x", x, x.device)
    b, h, w, c = x.shape
    if c > MAX_CHANNELS or h > 65535 or b > 65535:
        raise ValueError(f"convnext_block: unsupported shape {tuple(x.shape)}")
    shapes = {
        "dwconv.weight": (c, 1, 7, 7),
        "dwconv.bias": (c,),
        "ln.weight": (c,),
        "ln.bias": (c,),
        "mlp_up.weight": (4 * c, c),
        "mlp_up.bias": (4 * c,),
        "mlp_down.weight": (c, 4 * c),
        "mlp_down.bias": (c,),
        "block_scale": (c,),
    }
    for name, shape in shapes.items():
        _nvcc.check_param(name, p[name], shape, x.device)
    q = {k: p[k].contiguous() for k in shapes}
    for name in ("dwconv.weight", "mlp_up.weight", "mlp_down.weight"):
        if q[name].data_ptr() % 16:
            raise ValueError(f"convnext_block: {name} is not 16-byte aligned")
    lib = build()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    workspace = torch.empty(
        lib.convnext_block_f32_workspace(b, h, w, c, sms), dtype=torch.float32, device=x.device
    )
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.convnext_block_f32(
            x.data_ptr(), q["dwconv.weight"].data_ptr(), q["dwconv.bias"].data_ptr(),
            q["ln.weight"].data_ptr(), q["ln.bias"].data_ptr(),
            q["mlp_up.weight"].data_ptr(), q["mlp_up.bias"].data_ptr(),
            q["mlp_down.weight"].data_ptr(), q["mlp_down.bias"].data_ptr(),
            q["block_scale"].data_ptr(), workspace.data_ptr(), out.data_ptr(),
            b, h, w, c, sms, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"convnext_block_f32 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
