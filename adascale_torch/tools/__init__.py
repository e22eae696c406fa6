"""Manual inspection and profiling helpers, as the JAX package's
``adascale/tools/__init__.py`` re-exports them (forward profiling, dataset
sample rendering, dataset latency statistics)."""
from .inspect import profile_dataset, profile_forward, sample_dataset

__all__ = ["profile_dataset", "profile_forward", "sample_dataset"]
