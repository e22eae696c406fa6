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

The kernel is built on first use with ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``: no PyTorch headers, so the build
takes seconds. The library lands in ``_build/<hash of the source>/``.

``p`` holds the block's parameters in PyTorch layout, as the port's
``ConvNeXtBlock.state_dict()`` does: ``dwconv.weight`` (C, 1, 7, 7),
``dwconv.bias``, ``ln.weight``, ``ln.bias``, ``mlp_up.weight`` (4C, C),
``mlp_up.bias``, ``mlp_down.weight`` (C, 4C), ``mlp_down.bias`` and
``block_scale`` (C,).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.nn.functional as F

# Number of kernel launches, counted once per call (the call's two or three
# CUDA launches together). Plain integer, reset by whoever counts a run.
LAUNCHES = 0

MAX_CHANNELS = 768
EPS = 1e-6

_SOURCE = Path(__file__).resolve().parent / "csrc" / "convnext_block.cu"
_BUILD_ROOT = Path(__file__).resolve().parent / "_build"
_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
# Filled by build(): {"seconds": float, "cached": bool, "ptxas": str, "path": str}.
BUILD_REPORT: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise FileNotFoundError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    source = _SOURCE.read_bytes()
    digest = hashlib.sha256(source + " ".join(_ARCH_FLAGS + _NVCC_FLAGS).encode()).hexdigest()
    out_dir = _BUILD_ROOT / digest[:16]
    lib_path = out_dir / "libconvnext_block.so"
    log_path = out_dir / "ptxas.log"
    start = time.perf_counter()
    cached = lib_path.exists()
    if not cached:
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libconvnext_block.{os.getpid()}.so"
        cmd = [_nvcc(), *_ARCH_FLAGS, *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.convnext_block_f32
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.convnext_block_f32_workspace
    ws.argtypes = [ctypes.c_int] * 5
    ws.restype = ctypes.c_longlong
    BUILD_REPORT.update(
        seconds=time.perf_counter() - start,
        cached=cached,
        ptxas=log_path.read_text() if log_path.exists() else "",
        path=str(lib_path),
    )
    _lib = lib
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


def _check_param(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want float32 {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


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
        _check_param(name, p[name], shape, x.device)
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
