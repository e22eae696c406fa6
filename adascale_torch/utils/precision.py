"""Full f32 on the card for the library calls beside the kernels.

cuDNN runs f32 convolutions in TF32 by default, and cuBLAS may reduce bf16
products' split-K partial sums in bf16. The reference computes at
"highest" precision and sums bf16 products in f32, as XLA does, so every
entry point that runs a model on the card (the engine, the train step,
``export_program`` and ``load_program``) calls ``pin_full_f32`` first: the
stem, downsample, neck and head convolutions and the matmuls then run in
full f32. The flags are process-wide.
"""
from __future__ import annotations

import torch


def pin_full_f32() -> None:
    """Turn off TF32 in cuDNN and cuBLAS, and bf16 reductions of bf16
    products in cuBLAS."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
