"""adascale_torch: the adaptive-scaling OCR detector in PyTorch and CUDA.

A port of the JAX package ``adascale`` (which stays the reference) to
PyTorch on an NVIDIA H100. Public functions keep the JAX package's NHWC
layout. Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``, where every kernel runs its plain PyTorch version.

The package imports no JAX, OpenCV or anything of ``adascale``.
"""
from .inference.engine import (  # noqa: F401
    AdaptiveScalingInference,
    AdaptiveScalingInferenceConfig,
    PreciseInferResult,
    RoughInferResult,
)
from .inference.batch import BatchedAdaptiveScalingInference  # noqa: F401
from .models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig  # noqa: F401
