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

bf16 (the JAX package's ``compute_dtype="bfloat16"``) has two modes, as the
JAX package's two backbone paths round differently: ``convnext_block(x, p,
torch.bfloat16)`` with a bf16 ``x`` is the Pallas backbone's block (bf16 in
and out; the residual between blocks is bf16), with an f32 ``x`` the Flax
module's (f32 residual in and out, bf16 rounding inside); both launch
``convnext_block_bf16`` (``csrc/block_bf16.cuh``: a channel-parallel
depthwise + LN, then the MLP on bf16 ``wgmma``, the 4C hidden kept on chip
for C <= 192; W1 and W2 packed once per parameter set by
``packing.pack_block_bf16``) and have the plain twin
``convnext_block_plain_bf16``. bf16 has no gradient path (the JAX package
trains in f32).

The kernels are built on first use by ``_nvcc.build`` (``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``; ``build``:
f32, ``build_bf16``: bf16, one library a mode, all from the same source): no
PyTorch headers, so a build takes seconds.

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

from ..ops.bf16 import gelu, round_bf16
from . import _nvcc, packing

# Number of kernel launches, counted once per call (the call's three or four
# CUDA launches together). Plain integer, reset by whoever counts a run.
LAUNCHES = 0
# Calls that launched the bf16 kernel, counted apart (LAUNCHES counts
# the f32 ones).
LAUNCHES_BF16 = 0

MAX_CHANNELS = 1536
EPS = 1e-6


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the f32 kernel library."""
    lib = _nvcc.build("convnext_block", "convnext_block.cu")
    fn = lib.convnext_block_f32
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.convnext_block_f32_workspace.argtypes = [ctypes.c_int] * 5
    lib.convnext_block_f32_workspace.restype = ctypes.c_longlong
    return lib


def build_bf16(module: bool) -> ctypes.CDLL:
    """Compile and load the bf16 kernel library of one mode (``module``: the
    module mode, else the Pallas mode): the same source built with
    ``-DCONVNEXT_BLOCK_BF16`` and ``-DCONVNEXT_BLOCK_BF16_MODULE``, a library
    of its own, so that the three compile in parallel. Raises if the
    library's packed layout is not the one ``packing.pack_block_bf16``
    makes."""
    if module in _BF16_LIBS:
        return _BF16_LIBS[module]
    lib = _nvcc.build(
        "convnext_block_bf16" + ("_module" if module else ""), "convnext_block.cu",
        ("CONVNEXT_BLOCK_BF16", f"CONVNEXT_BLOCK_BF16_MODULE={int(module)}"),
    )
    fn = lib.convnext_block_bf16
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.convnext_block_bf16_gelu_table.argtypes = [ctypes.c_void_p] * 3
    lib.convnext_block_bf16_gelu_table.restype = ctypes.c_int
    lib.convnext_block_bf16_gelu_entries.restype = ctypes.c_int
    lib.convnext_block_bf16_workspace.argtypes = [ctypes.c_int] * 5
    lib.convnext_block_bf16_workspace.restype = ctypes.c_longlong
    lib.convnext_block_bf16_fused_width.argtypes = [ctypes.c_int]
    lib.convnext_block_bf16_fused_width.restype = ctypes.c_int
    lib.convnext_block_bf16_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
    layout = (ctypes.c_int * 4)()
    lib.convnext_block_bf16_layout(layout)
    want = (packing.BLOCK_FUSED_MAX_C, packing.BLOCK_HIDDEN_CHUNK, *packing.BLOCK_TILE)
    if tuple(layout) != want:
        raise RuntimeError(
            f"convnext_block_bf16: the library's widest fused C, hidden chunk and tile {tuple(layout)} "
            f"are not the packing's {want}"
        )
    for c in range(8, MAX_CHANNELS + 1, 8):
        if lib.convnext_block_bf16_fused_width(c) != packing.block_fused_width(c):
            raise RuntimeError(f"convnext_block_bf16: the library's layout for C = {c} is not the packing's")
    return _BF16_LIBS.setdefault(module, lib)


# The loaded bf16 libraries by mode; the module mode's GELU table by card;
# a bf16 launch's multiprocessors and workspace floats by card and shape
# (asking for them took 2-4 us of a call's host time beside an H100,
# tools/kernel_ms.py --only block_bf16_host).
_BF16_LIBS: Dict[bool, ctypes.CDLL] = {}
_GELU_TABLES: Dict[int, torch.Tensor] = {}
_BF16_SHAPES: Dict[tuple, tuple] = {}
# The current stream's handle without building a Stream object (3-6 us a
# call less beside an H100, the same tool; CUDA builds of PyTorch have it),
# else None.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


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


def convnext_block_plain_bf16(
    x: torch.Tensor, p: Dict[str, torch.Tensor], module: bool
) -> torch.Tensor:
    """Eager PyTorch twin of the bf16 kernel, in f32 on bf16 values, rounded
    where the kernel rounds (``csrc/convnext_block.cu``): ``module=False``
    the Pallas mode (bf16 ``x``, bf16 out), ``module=True`` the Flax
    module's (f32 ``x``, f32 out)."""
    r = round_bf16
    c = x.shape[-1]
    xf = x.float()
    w1, w2 = r(p["mlp_up.weight"]), r(p["mlp_down.weight"])
    if module:
        y = F.conv2d(r(xf).permute(0, 3, 1, 2), r(p["dwconv.weight"]), padding=3, groups=c)
        y = r(r(y.permute(0, 2, 3, 1)) + r(p["dwconv.bias"]))
        h = r(F.layer_norm(y, (c,), p["ln.weight"], p["ln.bias"], eps=EPS))
        u = gelu(r(r(F.linear(h, w1)) + r(p["mlp_up.bias"])), torch.bfloat16).float()
        y = r(r(F.linear(u, w2)) + r(p["mlp_down.bias"]))
        return xf + y * p["block_scale"]
    y = F.conv2d(
        xf.permute(0, 3, 1, 2), p["dwconv.weight"], p["dwconv.bias"], padding=3, groups=c
    ).permute(0, 2, 3, 1)
    h = r(F.layer_norm(y, (c,), p["ln.weight"], p["ln.bias"], eps=EPS))
    u = r(F.gelu(F.linear(h, w1, p["mlp_up.bias"]), approximate="none"))
    y = F.linear(u, w2, p["mlp_down.bias"])
    return (xf + y * p["block_scale"]).to(torch.bfloat16)


PARAM_NAMES = (
    "dwconv.weight", "dwconv.bias", "ln.weight", "ln.bias", "mlp_up.weight",
    "mlp_up.bias", "mlp_down.weight", "mlp_down.bias", "block_scale",
)


def convnext_block(
    x: torch.Tensor, p: Dict[str, torch.Tensor], compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """One ConvNeXt block on an NHWC tensor: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor. ``compute_dtype`` f32 takes
    an f32 ``x``; bf16 takes a bf16 ``x`` (the Pallas mode, bf16 out) or an
    f32 one (the module mode, f32 out). In f32, where grad is enabled and
    ``x`` or a parameter requires grad, the call goes through
    ``TrainableBlock``, so that the result carries its gradient; bf16 has no
    gradient path and raises there."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"convnext_block: unsupported device {x.device}")
    if (
        x.dtype not in (torch.float32, torch.bfloat16)
        or compute_dtype not in (torch.float32, torch.bfloat16)
        or (compute_dtype == torch.float32 and x.dtype != torch.float32)
    ):
        raise ValueError(f"convnext_block: x {x.dtype} at compute dtype {compute_dtype}")
    wants_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p[name].requires_grad for name in PARAM_NAMES)
    )
    if compute_dtype == torch.bfloat16:
        if wants_grad:
            raise NotImplementedError("convnext_block: no gradient in bf16 (training runs in f32)")
        module = x.dtype == torch.float32
        if x.device.type == "cpu":
            return convnext_block_plain_bf16(x, p, module)
        return _launch_bf16(x, p, module)
    if wants_grad:
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


def _param_shapes(c: int) -> Dict[str, tuple]:
    return {
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


# The bf16 launch's parameters, in the kernel's argument order.
BF16_ARGS = ("dw_w", "dw_b", "ln_g", "ln_b", "w1", "b1", "w2", "b2", "scale")


def bf16_weights(p: Dict[str, torch.Tensor], c: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The bf16 launch's parameters by ``BF16_ARGS``, in its order: checked
    against C's shapes on ``device``, the depthwise taps tap-major, (49, C)
    f32 (a warp reads a tap of neighbouring channels as one run), W1 and W2
    packed by ``packing.pack_block_bf16``, the vectors contiguous. Checked
    and built once per parameter set, C and device (``packing.cached``), so
    that a serving call skips the checks."""
    ts = [p[name] for name in PARAM_NAMES]

    def pack():
        for name, shape in _param_shapes(c).items():
            _nvcc.check_param(name, p[name], shape, device)
        args = dict(zip(BF16_ARGS, (t.detach().contiguous() for t in ts)))
        args["dw_w"] = p["dwconv.weight"].detach().reshape(c, 49).t().contiguous()
        args.update(packing.pack_block_bf16(p["mlp_up.weight"].detach(), p["mlp_down.weight"].detach()))
        return args

    return packing.cached(ts, ("block_bf16", c, device), pack)


def gelu_table(lib: ctypes.CDLL, index: int) -> torch.Tensor:
    """The module mode's GELU table on card ``index``: XLA's bf16 GELU of each
    bf16 value where a lookup is cheaper than computing it, filled by the
    library once and checked there against the GELU itself for all 65536
    bf16 values; raises if any lookup differs."""
    table = _GELU_TABLES.get(index)
    if table is None:
        device = torch.device("cuda", index)
        table = torch.empty(lib.convnext_block_bf16_gelu_entries(), dtype=torch.int16, device=device)
        bad = torch.zeros(1, dtype=torch.int32, device=device)
        with torch.cuda.device(index):
            rc = lib.convnext_block_bf16_gelu_table(
                table.data_ptr(), bad.data_ptr(), torch.cuda.current_stream(device).cuda_stream
            )
        if rc != 0 or int(bad) != 0:
            raise RuntimeError(
                f"convnext_block_bf16: GELU table failed (CUDA error {rc}, {int(bad)} lookups differ)"
            )
        _GELU_TABLES[index] = table
    return table


def _launch_bf16(x: torch.Tensor, p: Dict[str, torch.Tensor], module: bool) -> torch.Tensor:
    """Launch the bf16 kernel (``module``: the module mode, f32 x; else the
    Pallas mode, bf16 x) on a CUDA tensor; raises on what it does not take."""
    global LAUNCHES_BF16
    _nvcc.check_activation(
        "convnext_block x", x, x.device, (torch.float32 if module else torch.bfloat16,)
    )
    b, h, w, c = x.shape
    if c % 8 or c > MAX_CHANNELS or h > 65535 or b > 65535:
        raise ValueError(
            f"convnext_block: unsupported shape {tuple(x.shape)} in bf16 (want C % 8 == 0, C <= {MAX_CHANNELS})"
        )
    lib = build_bf16(module)
    args = bf16_weights(p, c, x.device)
    index = x.device.index
    key = (index, b, h, w, c)
    if key not in _BF16_SHAPES:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _BF16_SHAPES[key] = (sms, lib.convnext_block_bf16_workspace(b, h, w, c, sms))
    sms, floats = _BF16_SHAPES[key]
    table = gelu_table(lib, index).data_ptr() if module else 0
    workspace = torch.empty(floats, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    stream = _raw_stream(index) if _raw_stream else torch.cuda.current_stream(x.device).cuda_stream
    launch = (x.data_ptr(), *(t.data_ptr() for t in args.values()), table, workspace.data_ptr(),
              out.data_ptr(), b, h, w, c, sms, stream)
    if index == torch.cuda.current_device():
        rc = lib.convnext_block_bf16(*launch)
    else:
        with torch.cuda.device(index):
            rc = lib.convnext_block_bf16(*launch)
    if rc != 0:
        raise RuntimeError(f"convnext_block_bf16 launch failed: CUDA error {rc}")
    LAUNCHES_BF16 += 1
    return out


def _launch(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Launch the f32 kernel on a CUDA tensor; raises on what it does not
    take."""
    global LAUNCHES
    _nvcc.check_activation("convnext_block x", x, x.device, (torch.float32,))
    b, h, w, c = x.shape
    if c > MAX_CHANNELS or h > 65535 or b > 65535:
        raise ValueError(f"convnext_block: unsupported shape {tuple(x.shape)}")
    shapes = _param_shapes(c)
    for name, shape in shapes.items():
        _nvcc.check_param(name, p[name], shape, x.device)
    q = {k: p[k].contiguous() for k in shapes}
    for name in ("dwconv.weight", "mlp_up.weight", "mlp_down.weight"):
        if q[name].data_ptr() % 16:
            raise ValueError(f"convnext_block: {name} is not 16-byte aligned")
    lib = build()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    workspace = torch.empty(
        lib.convnext_block_f32_workspace(b, h, w, c, sms), dtype=torch.float32, device=x.device
    )
    with torch.cuda.device(x.device):
        rc = lib.convnext_block_f32(
            x.data_ptr(), q["dwconv.weight"].data_ptr(), q["dwconv.bias"].data_ptr(),
            q["ln.weight"].data_ptr(), q["ln.bias"].data_ptr(),
            q["mlp_up.weight"].data_ptr(), q["mlp_up.bias"].data_ptr(),
            q["mlp_down.weight"].data_ptr(), q["mlp_down.bias"].data_ptr(),
            q["block_scale"].data_ptr(), workspace.data_ptr(), out.data_ptr(),
            b, h, w, c, sms, stream,
        )
    if rc != 0:
        raise RuntimeError(f"convnext_block_f32 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
