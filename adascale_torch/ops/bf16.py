"""bf16 rounding as the JAX package's bf16 paths round, for the port's module
path and the kernels' plain twins.

``round_bf16(t)``: ``t`` rounded to bf16 (to nearest even), back in f32.
``gelu(x, dtype)``: the exact GELU as ``jax.nn.gelu(x, approximate=False)``
computes it in ``dtype``: in f32, ``F.gelu``; in bf16, ``0.5 x erfc(-x s)``
with ``s = sqrt(1/2)`` in bf16 and each product and the erfc rounded to
bf16, which is what XLA gives for a bf16 ``x`` (Flax's ``gelu_exact`` on the
module path and the fused neck's levels 1..n). Its gradient in bf16 is the
one JAX's autodiff builds from those operations, each rounded to bf16 as XLA
rounds it: erfc's derivative ``-2/sqrt(pi) exp(-d^2)`` with the constant in
bf16 (-1.125), ``d^2`` and the exponential rounded, then the chain's
products and the sum of the two terms.
``layer_norm(x, weight, bias, eps)``: Flax's LayerNorm of a bf16 ``x`` (f32
out): ``F.layer_norm`` in f32 forward; backward, the gradient JAX's autodiff
gives Flax's formula (statistics of ``x`` cast to f32, ``E[x^2] - E[x]^2``,
then ``(x - mean) * (rsqrt(var + eps) * scale) + bias``), where ``x`` enters
twice through a cast to f32, so its two cotangents are each rounded to bf16
and summed in bf16. ``round_grad_bf16(t)``: the identity, its
cotangent rounded to bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# sqrt(1/2) in bf16.
SQRT_HALF_BF16 = 0.70703125
# -2/sqrt(pi), erfc's derivative's constant, in bf16.
ERFC_SLOPE_BF16 = -1.125
assert ERFC_SLOPE_BF16 == torch.tensor(-2.0 / math.sqrt(math.pi)).to(torch.bfloat16).item()


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even) and back to f32."""
    return t.to(torch.bfloat16).float()


def gelu(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact GELU of ``x`` in ``dtype``, rounded as XLA rounds it there, and
    in bf16 differentiated as JAX differentiates it."""
    if dtype != torch.bfloat16:
        return F.gelu(x.to(dtype), approximate="none")
    return _GeluBF16.apply(x)


class _GeluBF16(torch.autograd.Function):
    """XLA's bf16 GELU (bf16 out) and the gradient JAX's autodiff gives it;
    ``x`` holds bf16 values (bf16, or f32 already rounded)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        ctx.save_for_backward(x)
        e = round_bf16(torch.special.erfc(round_bf16(-xf * SQRT_HALF_BF16)))
        return (0.5 * xf * e).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        r = round_bf16
        xf, n = x.float(), r(grad.float())
        d = r(-xf * SQRT_HALF_BF16)
        e = r(torch.special.erfc(d))
        h = r(torch.exp(-r(d * d)))
        # d/dx of (0.5 x) * erfc(d): 0.5 * (n e) + (-(ERFC_SLOPE * (0.5 x n) * h) * s).
        slope = r(r(r(ERFC_SLOPE_BF16 * r(0.5 * xf * n)) * h) * SQRT_HALF_BF16)
        return r(0.5 * r(n * e) - slope).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (bf16, or f32 holding bf16
    values) in f32, differentiated as JAX differentiates Flax's LayerNorm of
    a bf16 input (module docstring)."""
    return _LayerNormBF16.apply(x, weight, bias, eps)


def round_grad_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t``, whose gradient is rounded to bf16: the transpose of Flax's
    cast of a bf16 value to f32."""
    return _RoundGrad.apply(t)


class _RoundGrad(torch.autograd.Function):
    """The identity, whose cotangent is rounded to bf16 (the transpose of a
    cast from bf16 to f32)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return round_bf16(grad)


class _LayerNormBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps=eps)

    @staticmethod
    def backward(ctx, grad):
        wanted = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            x, weight, bias = (t.detach().requires_grad_(w) for t, w in zip(ctx.saved_tensors, wanted))
            direct, stats = round_grad_bf16(x.float()), round_grad_bf16(x.float())
            mean = stats.mean(-1, keepdim=True)
            var = ((stats * stats).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
            out = (direct - mean) * (torch.rsqrt(var + ctx.eps) * weight) + bias
            grads = iter(torch.autograd.grad(out, [t for t, w in zip((x, weight, bias), wanted) if w], grad))
        return tuple(next(grads) if w else None for w in wanted) + (None,)
