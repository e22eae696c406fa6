"""Nearest-x2 upsample then 3x3 as four phase-collapsed 2x2 convolutions, NHWC.

Counterpart of ``adascale/ops/fused_upsample.py`` and of the FpnHead's
default form there (``_PhaseFusedSmooth``): output pixel (2i+a, 2j+b) of
``conv3x3(nearest_x2(x))`` sees only 2x2 source pixels, with the 3x3 taps that
land on the same source pixel summed. Each phase is then a 2x2 convolution at
the low resolution, followed by the head's bias, LN, GELU and Linear, and the
phases are interleaved at the end.

The phase form is the same function as upsample-then-3x3 but rounds
differently: the collapsed taps (k0+k1, k1+k2) make even and odd output
columns of a flat map differ by an ulp, and the precise pass's 5x5 peak pick
breaks its ties on exactly that, so the port computes what Flax computes.
The module-path ``FpnHead`` and the plain twins of the fused heads kernels
both call ``heads_phase_form``; the module path in bf16 calls
``module_head_bf16``.

In bf16 the two round at different points, as the JAX package's two paths
do: the module form (``module_head_bf16``, Flax ``_PhaseFusedSmooth`` at
dtype=bfloat16) casts the 3x3 to bf16 before collapsing its taps, so each
collapsed tap is a bf16 sum, and runs every product, bias add, LN, GELU and
the projection in bf16, one 2x2 convolution a phase as Flax does, so that
autodiff rounds its gradient where JAX's does; the fused kernels' form
(``kernel=True``; the Pallas heads kernels) collapses in f32 and rounds the
collapsed taps once, keeps the sums, bias, LN, GELU and projection in f32
and returns f32, the precise heads (``round_y``) rounding the GELU output
and the projection's weights to bf16 first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from ..utils.precision import round_tf32
from .bf16 import gelu, layer_norm, round_bf16

EPS = 1e-6


def phase_tap_weights(weight: torch.Tensor) -> torch.Tensor:
    """OIHW 3x3 (F, C, 3, 3) -> (4 phases, 4 taps, C, F). Phase 2a+b holds the
    2x2 kernel of output pixels (2i+a, 2j+b); its tap 2dy+dx multiplies source
    pixel (i+a-1+dy, j+b-1+dx). Along each axis parity 0 takes taps
    [k0, k1+k2] and parity 1 takes [k0+k1, k2]."""
    k = weight.permute(2, 3, 1, 0)  # (3, 3, C, F)

    def collapse(k: torch.Tensor, axis: int, parity: int) -> torch.Tensor:
        k0, k1, k2 = k.unbind(axis)
        pair = [k0, k1 + k2] if parity == 0 else [k0 + k1, k2]
        return torch.stack(pair, axis)

    phases = [collapse(collapse(k, 0, a), 1, b) for a in (0, 1) for b in (0, 1)]
    c, f = weight.shape[1], weight.shape[0]
    return torch.stack(phases).reshape(4, 4, c, f)


def heads_phase_form(
    x: torch.Tensor,
    heads: Sequence[Dict[str, torch.Tensor]],
    kernel: bool = False,
    round_y: bool = False,
    tf32: bool = False,
) -> List[torch.Tensor]:
    """FpnHeads at factor 2 over one (B, H, W, C) input, each
    ``Linear(GELU(LN(conv3x3(nearest_x2(x)) + b)))`` -> (B, 2H, 2W, M): per
    phase one product of the four shifted inputs with all heads' collapsed
    taps, then each head's bias, LN, GELU and projection, interleaved. Each
    head's parameters are under the port ``FpnHead.state_dict()`` names
    (``step1.conv.weight`` (F, C, 3, 3), ``step1.conv.bias``,
    ``step1.ln.weight``, ``step1.ln.bias``, ``step2.weight`` (M, F),
    ``step2.bias``).

    The module form computes in ``x``'s dtype, f32 or f64 (a bf16 ``x``:
    ``module_head_bf16``); ``kernel=True`` is the fused kernels' bf16 form
    for a bf16 ``x`` (f32 out), with ``round_y`` for the precise heads
    (module docstring). ``tf32`` (an f32 ``x``) is the fused kernels'
    single-pass TF32 form: the shifted inputs and the collapsed taps
    (collapsed in f32) rounded to TF32 (``utils.precision.round_tf32``)
    before each phase's product, summed in f32; run it in full f32."""
    if x.dtype == torch.bfloat16 and not kernel:
        raise ValueError("heads_phase_form: the bf16 module form is module_head_bf16")
    b, h, w, c = x.shape
    if kernel:  # f32 arithmetic (f64 for an f64 x: an exact evaluation)
        dt = torch.float64 if x.dtype == torch.float64 else torch.float32
        wk = torch.cat(
            [round_bf16(phase_tap_weights(p["step1.conv.weight"])).to(dt) for p in heads], dim=-1
        )
        x = x.to(dt)
    else:
        dt = x.dtype
        wk = torch.cat([phase_tap_weights(p["step1.conv.weight"].to(dt)) for p in heads], dim=-1)
    if tf32:
        if dt != torch.float32:
            raise ValueError(f"heads_phase_form: the TF32 form takes an f32 x, not {dt}")
        wk = round_tf32(wk)
    ln_dt = torch.float64 if dt == torch.float64 else torch.float32  # LN in f32 at least
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    widths = [p["step1.conv.weight"].shape[0] for p in heads]
    outs = [
        x.new_empty(b, 2 * h, 2 * w, p["step2.weight"].shape[0]) for p in heads
    ]
    for a in (0, 1):
        for bb in (0, 1):
            cols = torch.cat(
                [xp[:, a + dy : a + dy + h, bb + dx : bb + dx + w] for dy in (0, 1) for dx in (0, 1)],
                dim=-1,
            )
            if tf32:
                cols = round_tf32(cols)
            acc = cols.reshape(-1, 4 * c) @ wk[2 * a + bb].reshape(4 * c, -1)
            for out, p, z in zip(outs, heads, acc.split(widths, dim=-1)):
                z = z + p["step1.conv.bias"].to(dt)
                z = F.layer_norm(
                    z.to(ln_dt), (z.shape[-1],), p["step1.ln.weight"].to(ln_dt),
                    p["step1.ln.bias"].to(ln_dt), eps=EPS,
                ).to(dt)
                g = gelu(z, dt)
                w2 = p["step2.weight"]
                if round_y:
                    g, w2 = round_bf16(g), round_bf16(w2)
                y = F.linear(g.to(dt), w2.to(dt), p["step2.bias"].to(dt))
                out[:, a::2, bb::2] = y.reshape(b, h, w, -1)
    return outs


def _collapse(k: torch.Tensor, axis: int, parity: int) -> torch.Tensor:
    """Of an OIHW 3x3 kernel, the 2 taps along ``axis`` (2: rows, 3:
    columns) that output parity ``parity`` touches."""
    k0, k1, k2 = k.split(1, dim=axis)
    return torch.cat([k0, k1 + k2] if parity == 0 else [k0 + k1, k2], dim=axis)


def module_head_bf16(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One FpnHead at factor 2 on a bf16 ``x``, as Flax's
    ``_PhaseFusedSmooth`` and ``FpnHead`` build it at dtype=bfloat16: the 3x3
    cast to bf16, collapsed by rows, then by columns (bf16 sums), one 2x2
    convolution a phase over the padded input, then the bias, LN, GELU, the
    projection and its bias, each rounded to bf16 (``p`` as in
    ``heads_phase_form``)."""
    bf16 = torch.bfloat16
    b, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).permute(0, 3, 1, 2)
    k = p["step1.conv.weight"].to(bf16)
    out = x.new_empty(b, 2 * h, 2 * w, p["step2.weight"].shape[0])
    for a in (0, 1):
        ka = _collapse(k, 2, a)
        for bb in (0, 1):
            y = F.conv2d(xp, _collapse(ka, 3, bb))[:, :, a : a + h, bb : bb + w].permute(0, 2, 3, 1)
            z = layer_norm(y + p["step1.conv.bias"].to(bf16), p["step1.ln.weight"], p["step1.ln.bias"], EPS)
            g = gelu(z.to(bf16), bf16)
            out[:, a::2, bb::2] = F.linear(g, p["step2.weight"].to(bf16)) + p["step2.bias"].to(bf16)
    return out
