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
``csrc/conv_tma.cuh`` (step1's W1, C0 <= 192, held in shared memory).
Widths past the one-pass tiles (Cm 384, Co 96: the base and large
backbones' 512 / 128 and 768 / 192) run each step in one launch: step1 on a
thread-block cluster, one CTA a slice of Cm, the slices sharing each row's
LayerNorm statistics through distributed shared memory; step2 one CTA a
pixel tile with all of Co (N = 128 or 192; two 192-wide slices on a
cluster past 192). ``plan`` gives each step's route and slices.

Inside a ``utils.precision.matmul_precision("default")`` or ``("high")``
scope an f32 call on the card launches the single-pass entry
``fpn_neck_l0_tf32`` (one TF32 ``wgmma`` a product; 0.069 ms at 240x192 at
495 TFLOP/s; counted in ``LAUNCHES_TF32``), whose plain twin is
``fused_neck_l0_plain(..., tf32=True)``: the bf16 entry's TMA-fed kernels
on f32 operands (``f0`` and ``t`` rounded to TF32 in registers, W1 and W2
rounded and packed by ``packing.pack_sw128_tf32``, ``pack_neck(...,
tf32_sw128=True)``) where W1 fits in shared memory, else step1 as the
3xTF32 entry's kernels at one pass, reading only the packed weights' hi
part.

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
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bf16 import round_bf16
from ..ops.resize import resize_nearest
from ..utils.precision import round_tf32, tf32_products
from . import _nvcc, packing

# Calls that launched the kernel (its two CUDA launches count once).
LAUNCHES = 0
# Calls that launched the bf16 kernel, counted apart (LAUNCHES counts
# the f32 ones).
LAUNCHES_BF16 = 0
# Calls that launched the single-pass TF32 entry, counted apart.
LAUNCHES_TF32 = 0

EPS = 1e-6
# The one-pass kernels' tiles, the flagship's widths (csrc/fpn_neck_l0.cu
# kMid, kNB), and the widest Cm and Co (kMaxMid, kMaxOut); ``build`` checks
# the library's.
MID_WIDTH, OUT_WIDTH = 384, 96
MAX_MID, MAX_OUT = 1536, 384
# The widest C0 whose W1 the one-pass step1 holds in shared memory
# (csrc/fpn_neck_l0.cu kMaxC0<bf16>, kMaxC0<float>; ``build`` checks them).
BF16_MAX_C0, TF32_MAX_C0 = 192, 96
# The chunks of a wide step1's W1 slice that stay in shared memory, by kind
# and slice width (csrc/fpn_neck_l0.cu kWide1Chunks): 64 bf16 or 32 f32
# input channels a chunk.
RESIDENT_CHUNKS = {("bf16", 256): 5, ("bf16", 384): 3, ("tf32", 192): 7, ("tf32", 256): 5}
# A step's route (csrc/fpn_neck_l0.cu Route): conv_gemm.cuh's loop (its
# weights in ``packing.pack_kmajor``'s layout), conv_tma.cuh's (the
# 128-byte swizzle) with a step1's W1 resident, or streamed.
GEMM, TMA, TMA_STREAMED = 0, 1, 2
KINDS = ("f32", "tf32", "bf16")  # the library's kinds 0, 1, 2
PARAM_NAMES = (
    "step1_0.conv.weight", "step1_0.conv.bias", "step1_0.ln.weight", "step1_0.ln.bias",
    "step2_0.conv.weight", "step2_0.conv.bias", "step2_0.ln.weight", "step2_0.ln.bias",
)
# Shapes whose plan the library confirmed, by (kind, C0, Cm, Co).
_PLANS_CHECKED: set = set()


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = _nvcc.build("fpn_neck_l0", "fpn_neck_l0.cu")
    for fn in (lib.fpn_neck_l0_f32, lib.fpn_neck_l0_tf32, lib.fpn_neck_l0_bf16):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    widths = []
    for name in ("tile_mid", "tile_out", "max_mid", "max_out", "bf16_max_c0", "tf32_max_c0"):
        getattr(lib, f"fpn_neck_l0_{name}").argtypes = []
        getattr(lib, f"fpn_neck_l0_{name}").restype = ctypes.c_int
        widths.append(getattr(lib, f"fpn_neck_l0_{name}")())
    want = (MID_WIDTH, OUT_WIDTH, MAX_MID, MAX_OUT, BF16_MAX_C0, TF32_MAX_C0)
    if tuple(widths) != want:
        raise RuntimeError(f"fpn_neck_l0: library widths {widths} != {want}")
    lib.fpn_neck_l0_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.fpn_neck_l0_plan.restype = ctypes.c_int
    return lib


def _pick_width(n: int, widths: Sequence[int]) -> int:
    """The slice width for n features from ``widths`` (ascending): the least
    padding, then the wider (csrc/fpn_neck_l0.cu ``pick_width``)."""
    return min(widths, key=lambda w: (-(-n // w) * w, -w))


def plan(kind: str, c0: int, cm: int, co: int) -> tuple:
    """Each step's (route, slice width, slices) for ``kind`` ("f32": the
    3xTF32 entry, "tf32", "bf16") and widths, as ``csrc/fpn_neck_l0.cu``'s
    ``plan_neck`` chooses them (``fused_neck_l0`` checks the library's once
    a shape). step1: one slice of MID_WIDTH where Cm fits it (the TMA-fed
    kernel where W1 fits in shared memory, else conv_gemm.cuh's; bf16
    refuses C0 > BF16_MAX_C0); wider, one CTA of a cluster a slice: bf16
    slices of 256 or 384 with W1's slice resident (RESIDENT_CHUNKS), else
    of 256 streamed; TF32 of 192 or 256 resident, else conv_gemm.cuh's
    slices of 256 or 384 at one pass; 3xTF32 of 256 or 384. step2: one
    slice of OUT_WIDTH where Co fits it, else N = 128 (Co <= 128) or 192 a
    slice; conv_gemm.cuh's loop for 3xTF32, the TMA-fed for the others.
    Raises for widths no route takes."""
    if not 0 < cm <= MAX_MID or not 0 < co <= MAX_OUT or c0 <= 0:
        raise ValueError(f"fused_neck_l0: widths {cm}/{co}; the kernel takes {MAX_MID}/{MAX_OUT}")
    chunks = -(-c0 // (packing.KC_TMA if kind == "bf16" else packing.KC))
    if cm <= MID_WIDTH:
        cap = BF16_MAX_C0 if kind == "bf16" else TF32_MAX_C0
        if kind == "bf16" and c0 > cap:
            raise ValueError(f"fused_neck_l0: bf16 C0={c0}; the one-pass kernel takes C0 <= {cap}")
        step1 = (GEMM if kind == "f32" or c0 > cap else TMA, MID_WIDTH, 1)
    else:
        if kind == "f32":
            route, width = GEMM, _pick_width(cm, (256, 384))
        else:
            fits = [w for w in ((256, 384) if kind == "bf16" else (192, 256))
                    if chunks <= RESIDENT_CHUNKS[(kind, w)]]
            if fits:
                route, width = TMA, _pick_width(cm, fits)
            elif kind == "bf16":
                route, width = TMA_STREAMED, 256
            else:
                route, width = GEMM, _pick_width(cm, (256, 384))
        step1 = (route, width, -(-cm // width))
    route2 = GEMM if kind == "f32" else TMA
    width2 = OUT_WIDTH if co <= OUT_WIDTH else 128 if co <= 128 else 192
    return step1, (route2, width2, -(-co // width2))


def _check_plan(lib: ctypes.CDLL, kind: str, c0: int, cm: int, co: int, want: tuple) -> None:
    """Raise unless the library plans (kind, C0, Cm, Co) as ``plan`` does,
    once a shape."""
    key = (kind, c0, cm, co)
    if key in _PLANS_CHECKED:
        return
    out = (ctypes.c_int * 6)()
    ok = lib.fpn_neck_l0_plan(KINDS.index(kind), c0, cm, co, out)
    if not ok or tuple(out) != (*want[0], *want[1]):
        raise RuntimeError(f"fpn_neck_l0: the library plans {key} as {tuple(out) if ok else None}, not {want}")
    _PLANS_CHECKED.add(key)


def _ln_gelu(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    y = F.layer_norm(y, (y.shape[-1],), weight, bias, eps=EPS)
    return F.gelu(y, approximate="none")


def fused_neck_l0_plain(
    f0: torch.Tensor, u: torch.Tensor, p: Dict[str, torch.Tensor], tf32: bool = False
) -> torch.Tensor:
    """Eager PyTorch twin of the kernel (NHWC in, NHWC out). For bf16 ``f0``
    and ``u`` it computes in f32 on the bf16 values and rounds ``t`` and the
    output to bf16, where the bf16 kernel rounds. ``tf32`` (f32): the
    single-pass TF32 entry's twin, both operands of each product rounded to
    TF32 as the kernel rounds them (``f0`` and ``W1``, ``t`` and ``W2``),
    summed in f32 (run it in full f32, ``pin_full_f32``)."""
    w1, w2 = p["step1_0.conv.weight"], p["step2_0.conv.weight"]
    bf16 = f0.dtype == torch.bfloat16
    r = round_tf32 if tf32 and not bf16 else (lambda v: v)
    if bf16:
        f0, u, w1, w2 = f0.float(), u.float(), round_bf16(w1), round_bf16(w2)
    a = _ln_gelu(
        F.linear(r(f0), r(w1), p["step1_0.conv.bias"]), p["step1_0.ln.weight"], p["step1_0.ln.bias"],
    )
    t = a + u
    if bf16:
        t = round_bf16(t)
    z = F.conv2d(r(t).permute(0, 3, 1, 2), r(w2), p["step2_0.conv.bias"], padding=1)
    out = _ln_gelu(z.permute(0, 2, 3, 1), p["step2_0.ln.weight"], p["step2_0.ln.bias"])
    return out.to(torch.bfloat16) if bf16 else out


def pack_neck(
    p: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32, tf32_sw128: bool = False
) -> Dict[str, torch.Tensor]:
    """The level-0 parameters in the kernels' layouts (``csrc/fpn_neck_l0.cu``)
    for ``dtype`` operands (``tf32_sw128``, f32: the single-pass TF32
    entry's), for each step's route, slice width n and slices s of
    ``plan``, zero past the real widths and past the input channels:

    - ``w1`` (s, 1 tap, chunks, ...; no slice axis where s = 1): W1 as (C0,
      s n) cut into slices of n features, each chunk of K for a TMA-fed
      route ``packing.pack_sw128``'s 64-channel chunk (n/8, 8, 8, 8) in
      bf16, ``packing.pack_sw128_tf32``'s 32-channel chunk (n/8, 8, 8, 4)
      rounded to TF32 in f32; for a conv_gemm.cuh route
      ``packing.pack_kmajor``'s TF32 ``hi`` and ``lo`` (2, n/8, 8, 8, 4);
    - ``w2`` (s, 9 taps, chunks, ...; likewise): the 3x3, tap 3 ky + kx as
      (Cm, s n), the same way;
    - ``vec1`` (3, s n) and ``vec2`` (3, s n): conv bias, LN scale, LN bias
      of step1 and step2."""
    w1, w2 = p["step1_0.conv.weight"], p["step2_0.conv.weight"]
    (cm, c0), co = w1.shape, w2.shape[0]
    bf16 = dtype == torch.bfloat16
    if not bf16 and dtype != torch.float32:
        raise ValueError(f"no packed layout for {dtype}")
    kind = "bf16" if bf16 else "tf32" if tf32_sw128 else "f32"
    (route1, n1, s1), (route2, n2, s2) = plan(kind, c0, cm, co)
    kc = packing.KC_TMA if bf16 else packing.KC

    def pack(taps, route, s):
        t = packing.split_slices(taps, s, 0)
        t = packing.pack_for(t, dtype, route != GEMM, tf32_sw128)
        return t.squeeze(0) if s == 1 else t

    with torch.no_grad():
        taps1 = w1.new_zeros(1, -(-c0 // kc) * kc, s1 * n1)
        taps1[0, :c0, :cm] = w1.t()
        taps2 = w2.new_zeros(9, -(-cm // kc) * kc, s2 * n2)
        taps2[:, :cm, :co] = w2.permute(2, 3, 1, 0).reshape(9, cm, co)
        vec1 = w1.new_zeros(3, s1 * n1)
        vec2 = w2.new_zeros(3, s2 * n2)
        for k, part in enumerate(("conv.bias", "ln.weight", "ln.bias")):
            vec1[k, :cm] = p[f"step1_0.{part}"]
            vec2[k, :co] = p[f"step2_0.{part}"]
        return {"w1": pack(taps1, route1, s1), "vec1": vec1, "w2": pack(taps2, route2, s2), "vec2": vec2}


def packed_neck(
    p: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32, tf32_sw128: bool = False
) -> Dict[str, torch.Tensor]:
    """``pack_neck(p, dtype, tf32_sw128)``, packed once per parameter set
    and layout (``packing.cached``: kept while ``step1_0.conv.weight``
    lives, repacked when any parameter's version or storage changes)."""
    return packing.cached(
        [p[name] for name in PARAM_NAMES], ("neck", dtype, tf32_sw128),
        lambda: pack_neck(p, dtype, tf32_sw128),
    )


def fused_neck_l0(
    f0: torch.Tensor, u: torch.Tensor, p: Dict[str, torch.Tensor], t: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The level-0 chain, f32 or bf16 (``f0`` and ``u`` of one dtype; the
    output in it): the CUDA kernel on a CUDA tensor (f32 inside a "default"
    or "high" ``matmul_precision`` scope: its single-pass TF32 entry), the
    plain version on a CPU tensor. On the card it raises where a gradient is
    wanted (``_nvcc.refuse_grad``). ``t``: a buffer like ``u`` for the
    chain's intermediate ``t = a + u``, which the 3x3 reads (``chip_smoke.py``
    holds each step against its twin on it); else one is allocated."""
    global LAUNCHES, LAUNCHES_BF16, LAUNCHES_TF32
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
    bf16 = f0.dtype == torch.bfloat16
    tf32 = not bf16 and tf32_products()
    kind = "bf16" if bf16 else "tf32" if tf32 else "f32"
    if co % 4:
        raise ValueError(f"fused_neck_l0: Co={co}; the kernel takes Co % 4 == 0")
    steps = plan(kind, c0, cm, co)
    lib = build()
    _check_plan(lib, kind, c0, cm, co, steps)
    packed = packed_neck(p, f0.dtype, tf32_sw128=tf32)
    if t is None:
        t = torch.empty_like(u)
    elif t.shape != u.shape or t.dtype != u.dtype or t.device != u.device or not t.is_contiguous():
        raise ValueError(f"fused_neck_l0: t must be contiguous, {tuple(u.shape)} {u.dtype} on {u.device}")
    out = torch.empty(b, h, w, co, dtype=f0.dtype, device=f0.device)
    entry = "fpn_neck_l0_" + kind
    with torch.cuda.device(f0.device):
        rc = getattr(lib, entry)(
            f0.data_ptr(), u.data_ptr(), packed["w1"].data_ptr(), packed["vec1"].data_ptr(),
            packed["w2"].data_ptr(), packed["vec2"].data_ptr(), t.data_ptr(), out.data_ptr(), b, h, w, c0, cm, co,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        # 1 (invalid value): a shape the kernel does not take, such as a side
        # over 32767 or more than 2^30 pixels.
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    if bf16:
        LAUNCHES_BF16 += 1
    elif tf32:
        LAUNCHES_TF32 += 1
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
