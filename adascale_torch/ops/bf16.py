"""bf16 rounding as the JAX package's bf16 paths round, for the port's module
path and the kernels' plain twins.

``round_bf16(t)``: ``t`` rounded to bf16 (to nearest even), back in f32.
``gelu(x, dtype)``: the exact GELU as ``jax.nn.gelu(x, approximate=False)``
computes it in ``dtype``: in f32, ``F.gelu``; in bf16, ``0.5 x erfc(-x s)``
with ``s = sqrt(1/2)`` in bf16 and each product and the erfc rounded to
bf16, which is what XLA gives for a bf16 ``x`` (Flax's ``gelu_exact`` on the
module path and the fused neck's levels 1..n).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# sqrt(1/2) in bf16.
SQRT_HALF_BF16 = 0.70703125


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even) and back to f32."""
    return t.to(torch.bfloat16).float()


def gelu(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact GELU of ``x`` in ``dtype``, rounded as XLA rounds it there."""
    if dtype != torch.bfloat16:
        return F.gelu(x.to(dtype), approximate="none")
    xf = x.float()
    e = round_bf16(torch.special.erfc(round_bf16(-xf * SQRT_HALF_BF16)))
    return (0.5 * xf * e).to(torch.bfloat16)
