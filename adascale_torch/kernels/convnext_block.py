"""The ConvNeXt residual block: a hand-written CUDA kernel and its plain twin.

``convnext_block(x, p)`` computes one deterministic ConvNeXt block on an
NHWC f32 tensor::

    out = x + scale * (W2 · GELU(W1 · LN(dwconv7x7(x) + dw_b) + b1) + b2)

It replaces the Pallas TPU kernel
``adascale/ops/pallas/convnext_block.py::fused_convnext_block``. On a CUDA
tensor it launches ``csrc/convnext_block.cu``: depthwise 7x7 + LayerNorm,
then the fused MLP whose 4C hidden never reaches device memory, and for small
shapes, whose hidden units are split across blocks, a reduction of the C-wide
partial sums.
On a CPU tensor it runs ``convnext_block_plain``, the eager PyTorch version
that the tests and ``chip_smoke.py`` hold the kernel against.

The kernel is built on first use by ``_nvcc.build`` (``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``): no PyTorch headers,
so the build takes seconds.

``p`` holds the block's parameters in PyTorch layout, as the port's
``ConvNeXtBlock.state_dict()`` does: ``dwconv.weight`` (C, 1, 7, 7),
``dwconv.bias``, ``ln.weight``, ``ln.bias``, ``mlp_up.weight`` (4C, C),
``mlp_up.bias``, ``mlp_down.weight`` (C, 4C), ``mlp_down.bias`` and
``block_scale`` (C,).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from . import _nvcc

# Number of kernel launches, counted once per call (the call's two or three
# CUDA launches together). Plain integer, reset by whoever counts a run.
LAUNCHES = 0

MAX_CHANNELS = 768
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


def convnext_block(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One ConvNeXt block on an NHWC f32 tensor: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    global LAUNCHES
    if x.device.type == "cpu":
        return convnext_block_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"convnext_block: want a contiguous (B, H, W, C) float32 tensor, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    b, h, w, c = x.shape
    if not 0 < c <= MAX_CHANNELS or h > 65535 or b > 65535:
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
    lib = build()
    # Kernel layouts: every weight load coalesced over output channels.
    dw_w = p["dwconv.weight"].reshape(c, 49).t().contiguous()
    w1 = p["mlp_up.weight"].t().contiguous()
    w2 = p["mlp_down.weight"].t().contiguous()
    vec = {k: p[k].contiguous() for k in shapes if p[k].dim() == 1}
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    workspace = torch.empty(
        lib.convnext_block_f32_workspace(b, h, w, c, sms), dtype=torch.float32, device=x.device
    )
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.convnext_block_f32(
            x.data_ptr(), dw_w.data_ptr(), vec["dwconv.bias"].data_ptr(),
            vec["ln.weight"].data_ptr(), vec["ln.bias"].data_ptr(),
            w1.data_ptr(), vec["mlp_up.bias"].data_ptr(),
            w2.data_ptr(), vec["mlp_down.bias"].data_ptr(),
            vec["block_scale"].data_ptr(), workspace.data_ptr(), out.data_ptr(),
            b, h, w, c, sms, stream,
        )
    if rc != 0:
        raise RuntimeError(f"convnext_block_f32 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
