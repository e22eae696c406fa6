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
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

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


def heads_phase_form(x: torch.Tensor, heads: Sequence[Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
    """FpnHeads at factor 2 over one (B, H, W, C) input, each
    ``Linear(GELU(LN(conv3x3(nearest_x2(x)) + b)))`` -> (B, 2H, 2W, M): per
    phase one product of the four shifted inputs with all heads' collapsed
    taps, then each head's bias, LN, GELU and projection, interleaved. Each
    head's parameters are under the port ``FpnHead.state_dict()`` names
    (``step1.conv.weight`` (F, C, 3, 3), ``step1.conv.bias``,
    ``step1.ln.weight``, ``step1.ln.bias``, ``step2.weight`` (M, F),
    ``step2.bias``)."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    wk = torch.cat([phase_tap_weights(p["step1.conv.weight"]) for p in heads], dim=-1)
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
            acc = cols.reshape(-1, 4 * c) @ wk[2 * a + bb].reshape(4 * c, -1)
            for out, p, z in zip(outs, heads, acc.split(widths, dim=-1)):
                z = z + p["step1.conv.bias"]
                z = F.layer_norm(z, (z.shape[-1],), p["step1.ln.weight"], p["step1.ln.bias"], eps=EPS)
                y = F.linear(F.gelu(z, approximate="none"), p["step2.weight"], p["step2.bias"])
                out[:, a::2, bb::2] = y.reshape(b, h, w, -1)
    return outs
