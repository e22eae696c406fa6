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

A bf16 ``f0`` and ``u`` (the JAX package's ``compute_dtype="bfloat16"``)
launch the bf16 entry: bf16 operands, f32 sums, LN, GELU and ``+ u``, ``t``
rounded to bf16 before the 3x3 and a bf16 output, as the Pallas kernel
computes it (0.034 ms at 240x192, 0.040 ms at 256x208, at 989 TFLOP/s
dense bf16), each step on the persistent TMA-fed loop of
``csrc/conv_tma.cuh`` (step1's W1, C0 <= 192, held in shared memory). Widths past
the kernel's tiles (Cm 384, Co 96: the base and large backbones' 512 / 128
and 768 / 192) run each step split into slices of its tile, with a second
pass for the LayerNorm (``csrc/fpn_neck_l0.cu``).

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

from ..ops.bf16 import round_bf16
from ..ops.resize import resize_nearest
from . import _nvcc, packing

# Calls that launched the kernel (its two CUDA launches count once).
LAUNCHES = 0
# Calls that launched the bf16 kernel, counted apart (LAUNCHES counts
# the f32 ones).
LAUNCHES_BF16 = 0

EPS = 1e-6
# The packed layout's slice widths, as csrc/fpn_neck_l0.cu reads them
# (``build`` checks the library's): Cm and Co are padded to multiples of
# these, one slice a tile.
MID_WIDTH, OUT_WIDTH = 384, 96
# The most slices a step takes (csrc/fpn_neck_l0.cu kMaxSlices).
MAX_SLICES = 4
PARAM_NAMES = (
    "step1_0.conv.weight", "step1_0.conv.bias", "step1_0.ln.weight", "step1_0.ln.bias",
    "step2_0.conv.weight", "step2_0.conv.bias", "step2_0.ln.weight", "step2_0.ln.bias",
)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _nvcc.build("fpn_neck_l0", "fpn_neck_l0.cu")
    for fn in (lib.fpn_neck_l0_f32, lib.fpn_neck_l0_bf16):
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    widths = []
    for name in ("tile_mid", "tile_out", "max_mid", "max_out"):
        getattr(lib, f"fpn_neck_l0_{name}").argtypes = []
        getattr(lib, f"fpn_neck_l0_{name}").restype = ctypes.c_int
        widths.append(getattr(lib, f"fpn_neck_l0_{name}")())
    if tuple(widths[:2]) != (MID_WIDTH, OUT_WIDTH):
        raise RuntimeError(f"fpn_neck_l0: library tiles {widths[:2]} != {(MID_WIDTH, OUT_WIDTH)}")
    lib.fpn_neck_l0_bf16_max_c0.argtypes = []
    lib.fpn_neck_l0_bf16_max_c0.restype = ctypes.c_int
    return lib



def _ln_gelu(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    y = F.layer_norm(y, (y.shape[-1],), weight, bias, eps=EPS)
    return F.gelu(y, approximate="none")


def fused_neck_l0_plain(
    f0: torch.Tensor, u: torch.Tensor, p: Dict[str, torch.Tensor]
) -> torch.Tensor:
    """Eager PyTorch twin of the kernel (NHWC in, NHWC out). For bf16 ``f0``
    and ``u`` it computes in f32 on the bf16 values and rounds ``t`` and the
    output to bf16, where the bf16 kernel rounds."""
    w1, w2 = p["step1_0.conv.weight"], p["step2_0.conv.weight"]
    bf16 = f0.dtype == torch.bfloat16
    if bf16:
        f0, u, w1, w2 = f0.float(), u.float(), round_bf16(w1), round_bf16(w2)
    a = _ln_gelu(
        F.linear(f0, w1, p["step1_0.conv.bias"]), p["step1_0.ln.weight"], p["step1_0.ln.bias"],
    )
    t = a + u
    if bf16:
        t = round_bf16(t)
    z = F.conv2d(t.permute(0, 3, 1, 2), w2, p["step2_0.conv.bias"], padding=1)
    out = _ln_gelu(z.permute(0, 2, 3, 1), p["step2_0.ln.weight"], p["step2_0.ln.bias"])
    return out.to(torch.bfloat16) if bf16 else out


def slices(cm: int, co: int) -> tuple:
    """The kernel's slices of Cm and of Co (one at the flagship's widths)."""
    return -(-cm // MID_WIDTH), -(-co // OUT_WIDTH)


def pack_neck(p: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The level-0 parameters in the kernel's layouts (``csrc/fpn_neck_l0.cu``)
    for ``dtype`` operands, zero past the real widths and past the input
    channels, with s1, s2 = ``slices(Cm, Co)``:

    - ``w1`` (s1 slices, 1 tap, ceil(C0/32) chunks, ...; no slice axis
      where s1 = 1): W1 as (C0, s1 MID_WIDTH) cut into slices of MID_WIDTH, each chunk for f32
      ``packing.pack_kmajor``'s TF32 ``hi`` and ``lo`` (2, MID_WIDTH/8, 8,
      8, 4), for bf16 ``packing.pack_kmajor_bf16``'s tile (MID_WIDTH/8, 4,
      8, 8), in wgmma's K-major core-matrix order; in bf16 with one slice
      (the one-pass kernel) ``packing.pack_sw128``'s 64-channel chunks
      (MID_WIDTH/8, 8, 8, 8) instead;
    - ``w2`` (s2 slices, 9 taps, ceil(Cm/32) chunks, ...; likewise): the 3x3, tap
      3 ky + kx as (Cm, s2 OUT_WIDTH), the same way;
    - ``vec1`` (3, s1 MID_WIDTH) and ``vec2`` (3, s2 OUT_WIDTH): conv bias,
      LN scale, LN bias of step1 and step2."""
    w1, w2 = p["step1_0.conv.weight"], p["step2_0.conv.weight"]
    (cm, c0), co = w1.shape, w2.shape[0]
    s1, s2 = slices(cm, co)
    if max(s1, s2) > MAX_SLICES:
        raise ValueError(
            f"pack_neck: widths {cm}/{co}; the layout takes {MAX_SLICES * MID_WIDTH}/{MAX_SLICES * OUT_WIDTH}"
        )
    bf16 = dtype == torch.bfloat16
    # A step that fits one tile runs its bf16 one-pass kernel, whose chunks
    # are 64 channels deep.
    kc1 = packing.KC_TMA if bf16 and s1 == 1 else packing.KC
    kc2 = packing.KC_TMA if bf16 and s2 == 1 else packing.KC
    with torch.no_grad():
        taps1 = w1.new_zeros(1, -(-c0 // kc1) * kc1, s1 * MID_WIDTH)
        taps1[0, :c0, :cm] = w1.t()
        taps2 = w2.new_zeros(9, -(-cm // kc2) * kc2, s2 * OUT_WIDTH)
        taps2[:, :cm, :co] = w2.permute(2, 3, 1, 0).reshape(9, cm, co)
        vec1 = w1.new_zeros(3, s1 * MID_WIDTH)
        vec2 = w2.new_zeros(3, s2 * OUT_WIDTH)
        for k, part in enumerate(("conv.bias", "ln.weight", "ln.bias")):
            vec1[k, :cm] = p[f"step1_0.{part}"]
            vec2[k, :co] = p[f"step2_0.{part}"]
        # One slice (its axis dropped) is the one-pass kernels' layout.
        w1p = packing.pack_for(packing.split_slices(taps1, s1, 0), dtype, s1 == 1)
        w2p = packing.pack_for(packing.split_slices(taps2, s2, 0), dtype, s2 == 1)
        return {
            "w1": w1p.squeeze(0) if s1 == 1 else w1p, "vec1": vec1,
            "w2": w2p.squeeze(0) if s2 == 1 else w2p, "vec2": vec2,
        }


def packed_neck(p: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """``pack_neck(p, dtype)``, packed once per parameter set and dtype
    (``packing.cached``: kept while ``step1_0.conv.weight`` lives, repacked
    when any parameter's version or storage changes)."""
    return packing.cached(
        [p[name] for name in PARAM_NAMES], ("neck", dtype), lambda: pack_neck(p, dtype)
    )


def fused_neck_l0(f0: torch.Tensor, u: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The level-0 chain, f32 or bf16 (``f0`` and ``u`` of one dtype; the
    output in it): the CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor. On the card it raises where a gradient is wanted
    (``_nvcc.refuse_grad``)."""
    global LAUNCHES, LAUNCHES_BF16
    _nvcc.check_dtype("fused_neck_l0 f0", f0)
    _nvcc.check_dtype("fused_neck_l0 u", u)
    if f0.device.type == "cpu":
        return fused_neck_l0_plain(f0, u, p)
    dtypes = tuple(_nvcc.CHANNEL_MULTIPLE)
    _nvcc.check_activation("fused_neck_l0 f0", f0, f0.device, dtypes)
    _nvcc.check_activation("fused_neck_l0 u", u, f0.device, (f0.dtype,))
    b, h, w, c0 = f0.shape
    cm, co = p["step1_0.conv.weight"].shape[0], p["step2_0.conv.weight"].shape[0]
    if tuple(u.shape) != (b, h, w, cm):
        raise ValueError(f"fused_neck_l0: u {tuple(u.shape)} != {(b, h, w, cm)}")
    shapes = [(cm, c0), (cm,), (cm,), (cm,), (co, cm, 3, 3), (co,), (co,), (co,)]
    for name, shape in zip(PARAM_NAMES, shapes):
        _nvcc.check_param(name, p[name], shape, f0.device)
    _nvcc.refuse_grad("fused_neck_l0", f0, u, *(p[name] for name in PARAM_NAMES))
    lib = build()
    max_mid, max_out = lib.fpn_neck_l0_max_mid(), lib.fpn_neck_l0_max_out()
    if cm > max_mid or co > max_out or co % 4:
        raise ValueError(f"fused_neck_l0: widths {cm}/{co}; the kernel takes {max_mid}/{max_out}, Co % 4 == 0")
    if f0.dtype == torch.bfloat16 and cm <= MID_WIDTH and c0 > lib.fpn_neck_l0_bf16_max_c0():
        raise ValueError(f"fused_neck_l0: bf16 C0={c0}; the one-pass kernel takes C0 <= {lib.fpn_neck_l0_bf16_max_c0()}")
    packed = packed_neck(p, f0.dtype)
    s1, s2 = slices(cm, co)
    t = torch.empty_like(u)
    out = torch.empty(b, h, w, co, dtype=f0.dtype, device=f0.device)
    ws_cols = max(s1 * MID_WIDTH if s1 > 1 else 0, s2 * OUT_WIDTH if s2 > 1 else 0)
    ws = torch.empty(b * h * w * ws_cols, dtype=torch.float32, device=f0.device) if ws_cols else None
    entry = "fpn_neck_l0_bf16" if f0.dtype == torch.bfloat16 else "fpn_neck_l0_f32"
    with torch.cuda.device(f0.device):
        rc = getattr(lib, entry)(
            f0.data_ptr(), u.data_ptr(), packed["w1"].data_ptr(), packed["vec1"].data_ptr(),
            packed["w2"].data_ptr(), packed["vec2"].data_ptr(), t.data_ptr(), out.data_ptr(),
            0 if ws is None else ws.data_ptr(), b, h, w, c0, cm, co,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        # 1 (invalid value): a shape the kernel does not take, such as a side
        # over 32767 or more than 2^30 pixels.
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    if f0.dtype == torch.bfloat16:
        LAUNCHES_BF16 += 1
    else:
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
    dtype = neck.dtype
    z0 = fused_neck_l0(f0.to(dtype).contiguous(), u.to(dtype).contiguous(), level0_params(neck))
    zs = [z0] + [
        resize_nearest(getattr(neck, f"step2_{i}")(outs[i]), shape0) for i in range(1, num)
    ]
    return torch.cat(zs, dim=-1)
