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
both call ``heads_phase_form``.

In bf16 the two round at different points, as the JAX package's two paths
do: the module form (Flax ``_PhaseFusedSmooth`` at dtype=bfloat16) casts
the 3x3 to bf16 before collapsing its taps, so each collapsed tap is a bf16
sum, and runs every product, bias add, LN, GELU and the projection in bf16;
the fused kernels' form (``kernel=True``; the Pallas heads kernels) collapses
in f32 and rounds the collapsed taps once, keeps the sums, bias, LN, GELU
and projection in f32 and returns f32, the precise heads (``round_y``)
rounding the GELU output and the projection's weights to bf16 first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .bf16 import gelu, round_bf16

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
) -> List[torch.Tensor]:
    """FpnHeads at factor 2 over one (B, H, W, C) input, each
    ``Linear(GELU(LN(conv3x3(nearest_x2(x)) + b)))`` -> (B, 2H, 2W, M): per
    phase one product of the four shifted inputs with all heads' collapsed
    taps, then each head's bias, LN, GELU and projection, interleaved. Each
    head's parameters are under the port ``FpnHead.state_dict()`` names
    (``step1.conv.weight`` (F, C, 3, 3), ``step1.conv.bias``,
    ``step1.ln.weight``, ``step1.ln.bias``, ``step2.weight`` (M, F),
    ``step2.bias``).

    The module form computes in ``x``'s dtype (LN and GELU in f32, rounded
    to it); ``kernel=True`` is the fused kernels' bf16 form for a bf16 ``x``
    (f32 out), with ``round_y`` for the precise heads (module docstring)."""
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
            wp = wk[2 * a + bb].reshape(4 * c, -1)
            if dt == torch.bfloat16:  # one image a product, as models/convnext.py::per_image
                acc = torch.cat([ci.reshape(-1, 4 * c) @ wp for ci in cols.split(1)])
            else:
                acc = cols.reshape(-1, 4 * c) @ wp
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
                if kernel or dt == torch.float32:
                    y = F.linear(g.to(dt), w2.to(dt), p["step2.bias"].to(dt))
                else:  # the module form: product and bias add each rounded
                    y = F.linear(g, w2.to(dt)) + p["step2.bias"].to(dt)
                out[:, a::2, bb::2] = y.reshape(b, h, w, -1)
    return outs
