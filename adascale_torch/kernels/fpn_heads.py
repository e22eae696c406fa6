"""The two rough FpnHeads in one pass: a hand-written CUDA kernel and its plain
twin, and the head packing that the precise heads share.

``fused_rough_heads(x, p_mask, p_height)`` computes both rough heads over the
rough neck output ``x`` (B, H, W, C), each::

    y = Linear(GELU(LN(conv3x3(nearest_x2(x)) + b)))    # -> (B, 2H, 2W, 1)

and returns (mask logits, raw height), before the height head's softplus. It
replaces the Pallas TPU kernel ``adascale/ops/pallas/fpn_heads.py::
fused_rough_heads`` (``pl.pallas_call`` at :200). Both versions compute the
upsample + 3x3 as four phase-collapsed 2x2 convolutions at the low resolution
(``ops/fused_upsample.py``: ``phase_tap_weights``, the JAX package's
``_phase_tap_weights``, and ``heads_phase_form``, the plain version), so the CPU
tests, which hold the plain version against the Flax ``FpnHead``, check the
packing the kernel uses. On a CUDA tensor it launches ``csrc/fpn_heads.cu``
(one block per head, phase and tile of 128 low-resolution pixels, the
products as 3xTF32 ``wgmma``; see ``csrc/fpn_head.cuh``) on weights that
``packed_heads`` packs once per parameter set. Bound by operations: 217.6
GFLOP at the flagship's 240x192x384, three TF32 products each, 1.32 ms on an
H100 SXM (495 TFLOP/s dense TF32, 700 W).

Each head's ``p`` holds the port's ``FpnHead.state_dict()`` names:
``step1.conv.weight`` (F, C, 3, 3), ``step1.conv.bias``, ``step1.ln.weight``,
``step1.ln.bias``, ``step2.weight`` (M, F), ``step2.bias`` (M,).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_upsample import heads_phase_form, phase_tap_weights
from . import _nvcc, packing
from .fpn_neck import fpn_neck_forward_fused
from .packing import KC

# Calls that launched the kernel.
LAUNCHES = 0

MAX_HEADS = 4
MAX_OUT = 4
PARAM_NAMES = (
    "step1.conv.weight", "step1.conv.bias", "step1.ln.weight", "step1.ln.bias",
    "step2.weight", "step2.bias",
)

Params = Dict[str, torch.Tensor]


def bind(lib: ctypes.CDLL, prefix: str) -> ctypes.CDLL:
    """Declare the C signatures of a heads library (``<prefix>_f32`` and
    ``<prefix>_max_width``)."""
    fn = getattr(lib, f"{prefix}_f32")
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.POINTER(ctypes.c_int)] * 2
        + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    width = getattr(lib, f"{prefix}_max_width")
    width.argtypes = []
    width.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return bind(_nvcc.build("fpn_heads", "fpn_heads.cu"), "fpn_heads")


def pack_heads(heads: Sequence[Params], n: int) -> Dict[str, torch.Tensor]:
    """The heads' parameters in the kernel's layouts (``csrc/fpn_head.cuh``),
    zero past each head's F and M and past C:

    - ``w`` (heads, 4 phases, 4 taps, ceil(C/32) chunks, 2, n/8, 8, 8, 4): the
      collapsed taps, ``packing.pack_kmajor``'s TF32 ``hi`` and ``lo``
      (axis 4) of each 32-channel chunk in wgmma's K-major core-matrix order;
    - ``vec`` (heads, 3, n): smoothing bias, LN scale, LN bias;
    - ``w2`` (heads, MAX_OUT, n) and ``b2`` (heads, MAX_OUT)."""
    ref = heads[0]["step1.conv.weight"]
    c, nh = ref.shape[1], len(heads)
    chunks = -(-c // KC)
    if n % 8:
        raise ValueError(f"pack_heads: width {n} is not a multiple of 8")
    with torch.no_grad():
        taps = ref.new_zeros(nh, 4, 4, chunks * KC, n)
        vec = ref.new_zeros(nh, 3, n)
        w2 = ref.new_zeros(nh, MAX_OUT, n)
        b2 = ref.new_zeros(nh, MAX_OUT)
        for k, p in enumerate(heads):
            m, f = p["step2.weight"].shape
            if f > n or m > MAX_OUT:
                raise ValueError(f"pack_heads: head {k} F={f}, M={m}; the layout takes F <= {n}, M <= {MAX_OUT}")
            taps[k, :, :, :c, :f] = phase_tap_weights(p["step1.conv.weight"])
            vec[k, 0, :f] = p["step1.conv.bias"]
            vec[k, 1, :f] = p["step1.ln.weight"]
            vec[k, 2, :f] = p["step1.ln.bias"]
            w2[k, :m, :f] = p["step2.weight"]
            b2[k, :m] = p["step2.bias"]
        w = packing.pack_kmajor(taps)
    return {"w": w, "vec": vec, "w2": w2, "b2": b2}


def packed_heads(heads: Sequence[Params], n: int) -> Dict[str, torch.Tensor]:
    """``pack_heads(heads, n)``, packed once per parameter set
    (``packing.cached``: kept while the first head's conv weight lives,
    repacked when any parameter's version or storage changes)."""
    tensors = [p[name] for p in heads for name in PARAM_NAMES]
    return packing.cached(tensors, ("heads", n), lambda: pack_heads(heads, n))


def run_heads_kernel(
    build: Callable[[], ctypes.CDLL],
    prefix: str,
    x: torch.Tensor,
    heads: Sequence[Params],
    wrapper: str,
) -> List[torch.Tensor]:
    """Check, pack (once per parameter set) and launch a heads library on a
    CUDA tensor. Returns each head's (B, 2H, 2W, M) output, a view into one
    packed map. Raises where a gradient is wanted (``_nvcc.refuse_grad``,
    naming ``wrapper``)."""
    _nvcc.check_activation(f"{prefix} x", x, x.device)
    if not 0 < len(heads) <= MAX_HEADS:
        raise ValueError(f"{prefix}: {len(heads)} heads, the kernel takes 1..{MAX_HEADS}")
    b, h, w, c = x.shape
    lib = build()
    bn = getattr(lib, f"{prefix}_max_width")()
    widths, outs = [], []
    for k, p in enumerate(heads):
        f, m = p["step1.conv.weight"].shape[0], p["step2.weight"].shape[0]
        if not (0 < f <= bn and 0 < m <= MAX_OUT):
            raise ValueError(f"{prefix} head {k}: F={f}, M={m}; the kernel takes F <= {bn}, M <= {MAX_OUT}")
        shapes = {
            "step1.conv.weight": (f, c, 3, 3),
            "step1.conv.bias": (f,),
            "step1.ln.weight": (f,),
            "step1.ln.bias": (f,),
            "step2.weight": (m, f),
            "step2.bias": (m,),
        }
        for name, shape in shapes.items():
            _nvcc.check_param(f"head {k} {name}", p[name], shape, x.device)
        widths.append(f)
        outs.append(m)
    _nvcc.refuse_grad(wrapper, x, *(p[name] for p in heads for name in PARAM_NAMES))
    packed = packed_heads(heads, bn)
    nh = len(heads)
    out = x.new_empty(b, 2 * h, 2 * w, sum(outs))
    f_arr = (ctypes.c_int * nh)(*widths)
    m_arr = (ctypes.c_int * nh)(*outs)
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"{prefix}_f32")(
            x.data_ptr(), packed["w"].data_ptr(), packed["vec"].data_ptr(), packed["w2"].data_ptr(),
            packed["b2"].data_ptr(), out.data_ptr(), f_arr, m_arr, nh, b, h, w, c,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        # 1 (invalid value): a shape the kernel does not take, such as more
        # than 65535 tiles of 128 pixels or a side over 32767.
        raise RuntimeError(f"{prefix}_f32 launch failed: CUDA error {rc}")
    return list(out.split(outs, dim=-1))


def fused_rough_heads_plain(
    x: torch.Tensor, p_mask: Params, p_height: Params
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eager PyTorch twin of the kernel: (mask logits, raw height)."""
    mask_logits, height_raw = heads_phase_form(x, [p_mask, p_height])
    return mask_logits, height_raw


def fused_rough_heads(
    x: torch.Tensor, p_mask: Params, p_height: Params
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask logits, raw height), each (B, 2H, 2W, 1): the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor. On the card it raises
    where a gradient is wanted."""
    global LAUNCHES
    if x.device.type == "cpu":
        return fused_rough_heads_plain(x, p_mask, p_height)
    mask_logits, height_raw = run_heads_kernel(
        build, "fpn_heads", x, [p_mask, p_height], "fused_rough_heads"
    )
    LAUNCHES += 1
    return mask_logits, height_raw


def head_params(head: nn.Module) -> Params:
    """A port ``FpnHead``'s parameters under its ``state_dict()`` names."""
    return dict(head.named_parameters())


def forward_rough_from_features_fused(
    model: nn.Module, features: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``AdaptiveScaling.forward_rough_from_features`` with the rough neck's
    level 0 and both heads through their kernels; softplus on the height in
    f32, as the model does."""
    neck = fpn_neck_forward_fused(model.rough_neck, features)
    mask_logits, height_raw = fused_rough_heads(
        neck,
        head_params(model.rough_char_mask_head),
        head_params(model.rough_char_height_head),
    )
    return mask_logits, F.softplus(height_raw.float())
