"""The precision of f32 products on the card: full f32 for the process, and
a scoped ``matmul_precision``, the counterpart of
``jax.default_matmul_precision``.

cuDNN runs f32 convolutions in TF32 by default, and cuBLAS may reduce bf16
products' split-K partial sums in bf16. The reference computes at
"highest" precision and sums bf16 products in f32, as XLA does, so every
entry point that runs a model on the card (the engine, the train step,
``export_program`` and ``load_program``) calls ``pin_full_f32`` first: the
stem, downsample, neck and head convolutions and the matmuls then run in
full f32. The flags are process-wide.

The JAX engine opens ``jax.default_matmul_precision(cfg.matmul_precision)``
around its forwards; on a GPU, XLA computes an f32 product at "default" or
"high" ("tensorfloat32") as one TF32 pass. ``matmul_precision(name)`` is
that scope here: for "default" and "high" it lets cuDNN and cuBLAS run f32
products in TF32, and the f32 kernels' wrappers launch their single-pass
TF32 entries (``tf32_products()``); for "highest" it pins full f32 and the
3xTF32 entries. On exit it restores the flags and the precision that were
there. On the CPU it changes nothing: the flags are the card's, and the
wrappers run their plain f32 versions whatever the scope, so "default"
computes what "highest" computes there.

One torch API sets and reads the flags everywhere: the ``allow_tf32``
attributes of ``torch.backends.cudnn`` and ``torch.backends.cuda.matmul``.
torch 2.13 raises when they are read after its newer ``fp32_precision``
attributes were set (and ``torch.get_float32_matmul_precision()`` with
them); with the ``allow_tf32`` attributes alone every getter agrees.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

PRECISIONS = ("highest", "high", "default")

# The precision of the innermost open scope ("highest" outside any).
_current = "highest"


def check_precision(name: str) -> str:
    """``name`` if it is one of ``PRECISIONS``; else raises, naming them."""
    if name not in PRECISIONS:
        raise ValueError(f"matmul_precision {name!r}: one of {', '.join(repr(p) for p in PRECISIONS)}")
    return name


def _set_tf32(allowed: bool) -> None:
    torch.backends.cudnn.allow_tf32 = allowed
    torch.backends.cuda.matmul.allow_tf32 = allowed


def pin_full_f32() -> None:
    """Turn off TF32 in cuDNN and cuBLAS, and bf16 reductions of bf16
    products in cuBLAS."""
    _set_tf32(False)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def tf32_products() -> bool:
    """Whether the f32 kernels launch their single-pass TF32 entries: inside
    a ``matmul_precision("default")`` or ``("high")`` scope."""
    return _current != "highest"


@contextlib.contextmanager
def matmul_precision(name: str) -> Iterator[None]:
    """Run the body at ``name``: "highest" is full f32 in cuDNN and cuBLAS
    and the 3xTF32 kernel entries; "high" and "default" are one TF32 pass a
    product in both and in the kernels. Restores the flags and the
    enclosing precision on exit."""
    global _current
    check_precision(name)
    saved = (_current, torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    _set_tf32(name != "highest")
    _current = name
    try:
        yield
    finally:
        _current = saved[0]
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[1:]


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero on the 13 dropped bits, by integer ops on its bits: what
    the kernels' single-pass entries multiply, and the ``hi`` part of their
    3xTF32 split."""
    return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
