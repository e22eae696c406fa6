"""The JAX package's bf16 reference, run eagerly (``jax.disable_jit()``),
with its bf16 sums accumulated in f32.

Eagerly, XLA on the CPU reduces a bf16 array (``reduce_sum``: the
transpose of a broadcast, i.e. every bias gradient) by adding in bf16 one
element after another: over 240 values it was 2.3e-2 of the sum away from
the sum rounded once, and over a flagship's 2 x 256 x 256 pixels the
running sum stops moving. The operation's own result is the sum rounded
once to bf16, which is what the port computes (f32 accumulation), so inside
``f32_sums()`` every bf16 ``reduce_sum`` runs on an f32 copy of its operand
and rounds its result to bf16; every other operation still rounds its own
bf16 result.
"""
import contextlib

import jax.numpy as jnp
from jax._src.lax import lax as _lax


@contextlib.contextmanager
def f32_sums():
    """Within: bf16 ``reduce_sum`` accumulates in f32 and rounds once (eager
    calls only, ``jax.disable_jit()``)."""
    prim = _lax.reduce_sum_p
    impl = prim.impl

    def f32_impl(operand, **params):
        if operand.dtype == jnp.bfloat16:
            return impl(operand.astype(jnp.float32), **params).astype(jnp.bfloat16)
        return impl(operand, **params)

    prim.def_impl(f32_impl)
    try:
        yield
    finally:
        prim.def_impl(impl)
