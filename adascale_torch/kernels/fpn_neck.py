"""The FPN neck's level-0 chain: a hand-written CUDA kernel and its plain twin.

``fused_neck_l0(f0, u, p)`` computes, on NHWC f32 tensors::

    a  = GELU(LN(f0 · W1 + b1))       # step1_0: C0 -> Cm
    t  = a + u                        # u: nearest-x2 of the level-1 sum
    z0 = GELU(LN(conv3x3(t) + b2))    # step2_0: Cm -> Co, zero padding on t

It replaces the Pallas TPU kernel
``adascale/ops/pallas/fpn_neck.py::fused_neck_l0`` (``pl.pallas_call`` at
:185). On a CUDA tensor it launches ``csrc/fpn_neck_l0.cu``: two implicit-GEMM
launches on the tensor cores at f32 accuracy (3xTF32 ``wgmma``,
``csrc/conv_gemm.cuh``; step1 + LN + GELU + u into t, then the 3x3 over t +
LN + GELU), counted as one call, on weights that ``packed_neck`` packs once
per parameter set. Bound by operations: 0.737 MFLOP a pixel at the
flagship's widths, three TF32 products each, 0.206 ms at 240x192 on an H100
SXM (495 TFLOP/s dense TF32, 700 W). On a CPU tensor it runs
``fused_neck_l0_plain``.

``fpn_neck_forward_fused(neck, features)`` is the counterpart of
``adascale/ops/pallas/fpn_neck.py::fpn_neck_forward_fused``: the port's
``FpnNeck`` output with level 0 through ``fused_neck_l0`` and levels 1..n
through the neck's own library-op blocks, as the JAX package leaves them to
XLA.

``p`` holds the level-0 parameters under the port's ``FpnNeck.state_dict()``
names: ``step1_0.conv.weight`` (Cm, C0), ``step1_0.conv.bias``,
``step1_0.ln.weight``, ``step1_0.ln.bias``, ``step2_0.conv.weight``
(Co, Cm, 3, 3), ``step2_0.conv.bias``, ``step2_0.ln.weight``,
``step2_0.ln.bias``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_nearest
from . import _nvcc, packing

# Calls that launched the kernel (its two CUDA launches count once).
LAUNCHES = 0

EPS = 1e-6
# The packed layout's widths, as csrc/fpn_neck_l0.cu reads them (``build``
# checks the library's): Cm and Co are padded to these.
MID_WIDTH, OUT_WIDTH = 384, 96
PARAM_NAMES = (
    "step1_0.conv.weight", "step1_0.conv.bias", "step1_0.ln.weight", "step1_0.ln.bias",
    "step2_0.conv.weight", "step2_0.conv.bias", "step2_0.ln.weight", "step2_0.ln.bias",
)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _nvcc.build("fpn_neck_l0", "fpn_neck_l0.cu")
    fn = lib.fpn_neck_l0_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    widths = []
    for name in ("fpn_neck_l0_max_mid", "fpn_neck_l0_max_out"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
        widths.append(getattr(lib, name)())
    if tuple(widths) != (MID_WIDTH, OUT_WIDTH):
        raise RuntimeError(f"fpn_neck_l0: library widths {widths} != {(MID_WIDTH, OUT_WIDTH)}")
    return lib


def _ln_gelu(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    y = F.layer_norm(y, (y.shape[-1],), weight, bias, eps=EPS)
    return F.gelu(y, approximate="none")


def fused_neck_l0_plain(
    f0: torch.Tensor, u: torch.Tensor, p: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """Eager PyTorch twin of the kernel (NHWC in, NHWC out)."""
    a = _ln_gelu(
        F.linear(f0, p["step1_0.conv.weight"], p["step1_0.conv.bias"]),
        p["step1_0.ln.weight"], p["step1_0.ln.bias"],
    )
    t = (a + u).permute(0, 3, 1, 2)
    z = F.conv2d(t, p["step2_0.conv.weight"], p["step2_0.conv.bias"], padding=1)
    return _ln_gelu(z.permute(0, 2, 3, 1), p["step2_0.ln.weight"], p["step2_0.ln.bias"])


def pack_neck(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The level-0 parameters in the kernel's layouts (``csrc/fpn_neck_l0.cu``),
    zero past the real widths and past the input channels:

    - ``w1`` (1 tap, ceil(C0/32) chunks, 2, MID_WIDTH/8, 8, 8, 4): W1 as
      (C0, MID_WIDTH), ``packing.pack_kmajor``'s TF32 ``hi`` and ``lo`` of
      each 32-channel chunk in wgmma's K-major core-matrix order;
    - ``w2`` (9 taps, ceil(Cm/32) chunks, 2, OUT_WIDTH/8, 8, 8, 4): the 3x3,
      tap 3 ky + kx as (Cm, OUT_WIDTH), the same way;
    - ``vec1`` (3, MID_WIDTH) and ``vec2`` (3, OUT_WIDTH): conv bias, LN
      scale, LN bias of step1 and step2."""
    w1, w2 = p["step1_0.conv.weight"], p["step2_0.conv.weight"]
    (cm, c0), co = w1.shape, w2.shape[0]
    if cm > MID_WIDTH or co > OUT_WIDTH:
        raise ValueError(f"pack_neck: widths {cm}/{co}; the layout takes {MID_WIDTH}/{OUT_WIDTH}")
    kc = packing.KC
    with torch.no_grad():
        taps1 = w1.new_zeros(1, -(-c0 // kc) * kc, MID_WIDTH)
        taps1[0, :c0, :cm] = w1.t()
        taps2 = w2.new_zeros(9, -(-cm // kc) * kc, OUT_WIDTH)
        taps2[:, :cm, :co] = w2.permute(2, 3, 1, 0).reshape(9, cm, co)
        vec1 = w1.new_zeros(3, MID_WIDTH)
        vec2 = w2.new_zeros(3, OUT_WIDTH)
        for k, part in enumerate(("conv.bias", "ln.weight", "ln.bias")):
            vec1[k, :cm] = p[f"step1_0.{part}"]
            vec2[k, :co] = p[f"step2_0.{part}"]
        return {
            "w1": packing.pack_kmajor(taps1), "vec1": vec1,
            "w2": packing.pack_kmajor(taps2), "vec2": vec2,
        }


def packed_neck(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``pack_neck(p)``, packed once per parameter set (``packing.cached``:
    kept while ``step1_0.conv.weight`` lives, repacked when any parameter's
    version or storage changes)."""
    return packing.cached([p[name] for name in PARAM_NAMES], "neck", lambda: pack_neck(p))


def fused_neck_l0(f0: torch.Tensor, u: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The level-0 chain: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor. On the card it raises where a gradient is wanted
    (``_nvcc.refuse_grad``)."""
    global LAUNCHES
    if f0.device.type == "cpu":
        return fused_neck_l0_plain(f0, u, p)
    _nvcc.check_activation("fused_neck_l0 f0", f0, f0.device)
    _nvcc.check_activation("fused_neck_l0 u", u, f0.device)
    b, h, w, c0 = f0.shape
    cm, co = p["step1_0.conv.weight"].shape[0], p["step2_0.conv.weight"].shape[0]
    if tuple(u.shape) != (b, h, w, cm):
        raise ValueError(f"fused_neck_l0: u {tuple(u.shape)} != {(b, h, w, cm)}")
    shapes = [(cm, c0), (cm,), (cm,), (cm,), (co, cm, 3, 3), (co,), (co,), (co,)]
    for name, shape in zip(PARAM_NAMES, shapes):
        _nvcc.check_param(name, p[name], shape, f0.device)
    _nvcc.refuse_grad("fused_neck_l0", f0, u, *(p[name] for name in PARAM_NAMES))
    lib = build()
    packed = packed_neck(p)
    t = torch.empty_like(u)
    out = torch.empty(b, h, w, co, dtype=torch.float32, device=f0.device)
    with torch.cuda.device(f0.device):
        rc = lib.fpn_neck_l0_f32(
            f0.data_ptr(), u.data_ptr(), packed["w1"].data_ptr(), packed["vec1"].data_ptr(),
            packed["w2"].data_ptr(), packed["vec2"].data_ptr(), t.data_ptr(), out.data_ptr(),
            b, h, w, c0, cm, co, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        # 1 (invalid value): a shape the kernel does not take, such as a side
        # over 32767 or more than 2^30 pixels.
        raise RuntimeError(f"fpn_neck_l0_f32 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def level0_params(neck: nn.Module) -> Dict[str, torch.Tensor]:
    """The ``p`` of ``fused_neck_l0`` from a port ``FpnNeck``."""
    return {
        k: v for k, v in neck.named_parameters() if k.startswith(("step1_0.", "step2_0."))
    }


def fpn_neck_forward_fused(neck: nn.Module, features: Sequence[torch.Tensor]) -> torch.Tensor:
    """``FpnNeck.forward`` with the level-0 chain through ``fused_neck_l0``;
    levels 1..n run the neck's own blocks (<= 1/4 of the pixels)."""
    num = neck.num
    outs = [None] + [getattr(neck, f"step1_{i}")(features[i]) for i in range(1, num)]
    for i in range(num - 1, 1, -1):
        prev = outs[i - 1]
        outs[i - 1] = prev + resize_nearest(outs[i], (prev.shape[1], prev.shape[2]))
    f0 = features[0]
    shape0 = (f0.shape[1], f0.shape[2])
    u = resize_nearest(outs[1], shape0)
    z0 = fused_neck_l0(f0.float().contiguous(), u.contiguous(), level0_params(neck))
    zs = [z0] + [
        resize_nearest(getattr(neck, f"step2_{i}")(outs[i]), shape0) for i in range(1, num)
    ]
    return torch.cat(zs, dim=-1)
