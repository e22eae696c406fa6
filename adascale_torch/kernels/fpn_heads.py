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

A bf16 ``x`` (the JAX package's ``compute_dtype="bfloat16"``) launches the
bf16 entry: bf16 collapsed taps and products, f32 sums, LN, GELU and
projection, f32 out (one bf16 product a product: 0.22 ms at 989 TFLOP/s),
on the persistent, TMA-fed loop of ``csrc/conv_tma.cuh``
(``fpn_head.cuh::heads_tma_kernel``, the taps packed by
``packing.pack_sw128``);
its plain twin is ``heads_phase_form(..., kernel=True)``. Inside a
``utils.precision.matmul_precision("default")`` or ``("high")`` scope an
f32 ``x`` on the card launches the single-pass entry ``fpn_heads_tf32`` (one
TF32 ``wgmma`` a product on ``x`` and the collapsed taps rounded to TF32;
0.44 ms at 495 TFLOP/s; counted in ``LAUNCHES_TF32``): where the heads fit
the tile, the bf16 entry's persistent TMA-fed loop on f32 operands (``x``
rounded to TF32 in registers, the taps rounded and packed by
``packing.pack_sw128_tf32``), as the precise heads' TF32 entry; its plain
twin is ``heads_phase_form(..., tf32=True)``. Heads wider than the kernel's
tile (192 features; the base and large backbones' 256 and 384) run in one
launch as the cluster forms of the same kernels (``csrc/fpn_head.cuh``):
the features split into ``slices`` slices (the library's
``fpn_heads_slice_width``: 128 at base, 192 at large), each pixel tile's
slices the CTAs of one thread-block cluster, which share the LayerNorm's
sums and the projection through distributed shared memory; the taps are
packed slice by slice in the one-tile layout of the entry.

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
from ..utils.precision import tf32_products
from . import _nvcc, packing
from .fpn_neck import fpn_neck_forward_fused
from .packing import KC

# Calls that launched the kernel.
LAUNCHES = 0
# Calls that launched the bf16 kernel, counted apart (LAUNCHES counts
# the f32 ones).
LAUNCHES_BF16 = 0
# Calls that launched the single-pass TF32 entry, counted apart.
LAUNCHES_TF32 = 0

MAX_HEADS = 4
MAX_OUT = 4
PARAM_NAMES = (
    "step1.conv.weight", "step1.conv.bias", "step1.ln.weight", "step1.ln.bias",
    "step2.weight", "step2.bias",
)

Params = Dict[str, torch.Tensor]


def bind(lib: ctypes.CDLL, prefix: str) -> ctypes.CDLL:
    """Declare the C signatures of a heads library (``<prefix>_f32``,
    ``<prefix>_tf32``, ``<prefix>_bf16``, ``<prefix>_tile_width``,
    ``<prefix>_max_width`` and ``<prefix>_slice_width``)."""
    for dtype in ("f32", "tf32", "bf16"):
        fn = getattr(lib, f"{prefix}_{dtype}")
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.POINTER(ctypes.c_int)] * 2
            + [ctypes.c_int] * 6
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    for name in ("tile_width", "max_width"):
        width = getattr(lib, f"{prefix}_{name}")
        width.argtypes = []
        width.restype = ctypes.c_int
    slice_width = getattr(lib, f"{prefix}_slice_width")
    slice_width.argtypes = [ctypes.c_int]
    slice_width.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return bind(_nvcc.build("fpn_heads", "fpn_heads.cu"), "fpn_heads")


def pack_heads(
    heads: Sequence[Params], n: int, slices: int = 1, dtype: torch.dtype = torch.float32,
    round_w2: bool = False, tf32_sw128: bool = False,
) -> Dict[str, torch.Tensor]:
    """The heads' parameters in the kernel's layouts (``csrc/fpn_head.cuh``)
    for ``slices`` slices of ``n`` features and ``dtype`` operands, zero
    past each head's F and M and past C (fp = slices n):

    - ``w`` (slices, heads, 4 phases, 4 taps, chunks, ...): the collapsed
      taps of each slice in the one-tile layout of the entry (a slice's
      part is what one tile of its features packs to; one slice drops the
      axis): for f32 (the 3xTF32 entry, ``heads_kernel`` and its cluster
      form) ``packing.pack_kmajor``'s TF32 ``hi`` and ``lo`` of each
      32-channel chunk (2, n/8, 8, 8, 4) in wgmma's K-major core-matrix
      order; for bf16 (``heads_tma_kernel`` and its cluster form)
      ``packing.pack_sw128``'s 64-channel chunks (n/8, 8, 8, 8) in the
      128-byte swizzle; with ``tf32_sw128`` (f32: the single-pass TF32
      entries, on the same TMA-fed kernels) ``packing.pack_sw128_tf32``'s
      32-channel chunks (n/8, 8, 8, 4), rounded to TF32;
    - ``vec`` (heads, 3, fp): smoothing bias, LN scale, LN bias;
    - ``w2`` (heads, MAX_OUT, fp), rounded to bf16 values where ``round_w2``
      (the precise heads in bf16), and ``b2`` (heads, MAX_OUT)."""
    ref = heads[0]["step1.conv.weight"]
    c, nh = ref.shape[1], len(heads)
    kc = packing.KC_TMA if dtype == torch.bfloat16 else KC
    chunks = -(-c // kc)
    fp = slices * n
    if n % 8:
        raise ValueError(f"pack_heads: width {n} is not a multiple of 8")
    with torch.no_grad():
        taps = ref.new_zeros(nh, 4, 4, chunks * kc, fp)
        vec = ref.new_zeros(nh, 3, fp)
        w2 = ref.new_zeros(nh, MAX_OUT, fp)
        b2 = ref.new_zeros(nh, MAX_OUT)
        for k, p in enumerate(heads):
            m, f = p["step2.weight"].shape
            if f > fp or m > MAX_OUT:
                raise ValueError(f"pack_heads: head {k} F={f}, M={m}; the layout takes F <= {fp}, M <= {MAX_OUT}")
            taps[k, :, :, :c, :f] = phase_tap_weights(p["step1.conv.weight"])
            vec[k, 0, :f] = p["step1.conv.bias"]
            vec[k, 1, :f] = p["step1.ln.weight"]
            vec[k, 2, :f] = p["step1.ln.bias"]
            w2[k, :m, :f] = p["step2.weight"]
            b2[k, :m] = p["step2.bias"]
        if round_w2:
            w2 = w2.to(torch.bfloat16).float()
        w = packing.pack_for(packing.split_slices(taps, slices, 0), dtype, True, tf32_sw128)
        if slices == 1:
            w = w.squeeze(0)
    return {"w": w, "vec": vec, "w2": w2, "b2": b2}


def packed_heads(
    heads: Sequence[Params], n: int, slices: int = 1, dtype: torch.dtype = torch.float32,
    round_w2: bool = False, tf32_sw128: bool = False,
) -> Dict[str, torch.Tensor]:
    """``pack_heads(...)``, packed once per parameter set and layout
    (``packing.cached``: kept while the first head's conv weight lives,
    repacked when any parameter's version or storage changes)."""
    tensors = [p[name] for p in heads for name in PARAM_NAMES]
    return packing.cached(
        tensors, ("heads", n, slices, dtype, round_w2, tf32_sw128),
        lambda: pack_heads(heads, n, slices, dtype, round_w2, tf32_sw128),
    )


def run_heads_kernel(
    build: Callable[[], ctypes.CDLL],
    prefix: str,
    x: torch.Tensor,
    heads: Sequence[Params],
    wrapper: str,
    round_y: bool = False,
    tf32: bool = False,
) -> List[torch.Tensor]:
    """Check, pack (once per parameter set) and launch a heads library on a
    CUDA tensor, f32 or bf16 (``round_y`` for the precise heads), an f32
    ``x`` through the single-pass TF32 entry where ``tf32`` (its taps in
    ``packing.pack_sw128_tf32``'s layout: the entry runs the TMA-fed loop).
    Heads wider than the tile run in ``slices`` slices of the width the
    library gives (``<prefix>_slice_width``), one cluster of CTAs a pixel
    tile, in the same launch. Returns each
    head's (B, 2H, 2W, M) f32 output, a view into one packed map. Raises
    where a gradient is wanted (``_nvcc.refuse_grad``, naming ``wrapper``)."""
    _nvcc.check_activation(f"{prefix} x", x, x.device, tuple(_nvcc.CHANNEL_MULTIPLE))
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
    width = getattr(lib, f"{prefix}_slice_width")(max(widths))
    slices = -(-max(widths) // width)
    bf16 = x.dtype == torch.bfloat16
    packed = packed_heads(heads, width, slices, x.dtype, round_w2=bf16 and round_y, tf32_sw128=tf32 and not bf16)
    nh = len(heads)
    out = torch.empty(b, 2 * h, 2 * w, sum(outs), dtype=torch.float32, device=x.device)
    f_arr = (ctypes.c_int * nh)(*widths)
    m_arr = (ctypes.c_int * nh)(*outs)
    entry = f"{prefix}_{'bf16' if bf16 else 'tf32' if tf32 else 'f32'}"
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), packed["w"].data_ptr(), packed["vec"].data_ptr(), packed["w2"].data_ptr(),
            packed["b2"].data_ptr(), out.data_ptr(), f_arr, m_arr, nh, slices, b, h, w, c,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        # 1 (invalid value): a shape the kernel does not take, such as more
        # than 65535 tiles of 128 pixels or a side over 32767 (the 3xTF32
        # entry).
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    return list(out.split(outs, dim=-1))


def fused_rough_heads_plain(
    x: torch.Tensor, p_mask: Params, p_height: Params, tf32: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eager PyTorch twin of the kernel: (mask logits, raw height), f32; for
    a bf16 ``x`` rounded where the bf16 kernel rounds; ``tf32`` (f32): the
    single-pass TF32 entry's twin."""
    bf16 = x.dtype == torch.bfloat16
    mask_logits, height_raw = heads_phase_form(x, [p_mask, p_height], kernel=bf16, tf32=tf32 and not bf16)
    return mask_logits, height_raw


def fused_rough_heads(
    x: torch.Tensor, p_mask: Params, p_height: Params
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask logits, raw height), each (B, 2H, 2W, 1) f32, from an f32 or
    bf16 ``x``: the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor. On the card it raises where a gradient is wanted."""
    global LAUNCHES, LAUNCHES_BF16, LAUNCHES_TF32
    _nvcc.check_dtype("fused_rough_heads x", x)
    if x.device.type == "cpu":
        return fused_rough_heads_plain(x, p_mask, p_height)
    tf32 = x.dtype == torch.float32 and tf32_products()
    mask_logits, height_raw = run_heads_kernel(
        build, "fpn_heads", x, [p_mask, p_height], "fused_rough_heads", tf32=tf32
    )
    if x.dtype == torch.bfloat16:
        LAUNCHES_BF16 += 1
    elif tf32:
        LAUNCHES_TF32 += 1
    else:
        LAUNCHES += 1
    return mask_logits, height_raw


def head_params(head: nn.Module) -> Params:
    """A port ``FpnHead``'s parameters under its ``state_dict()`` names."""
    return dict(head.named_parameters())


def forward_rough_from_features_fused(
    model: nn.Module, features: Sequence[torch.Tensor], *, fuse_neck: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``AdaptiveScaling.forward_rough_from_features`` with both heads
    through their kernel and, with ``fuse_neck`` and an FPN neck, the rough
    neck's level 0 through its kernel too (else the model's neck module
    feeds the heads kernel, as the JAX function's ``fuse_neck=False``);
    softplus on the height in f32, as the model does."""
    if fuse_neck and model.config.neck_head_type == "fpn":
        neck = fpn_neck_forward_fused(model.rough_neck, features)
    else:
        neck = model.rough_neck(features)
    mask_logits, height_raw = fused_rough_heads(
        neck,
        head_params(model.rough_char_mask_head),
        head_params(model.rough_char_height_head),
    )
    return mask_logits, F.softplus(height_raw.float())
