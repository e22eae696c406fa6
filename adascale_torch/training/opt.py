"""Training utilities (counterpart of ``adascale/training/opt.py``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def setup_seeds(
    numpy_seed: int = 1337, torch_seed: int = 133, device: str = "cpu"
) -> Tuple[torch.Generator, np.random.Generator]:
    """A ``torch.Generator`` on ``device`` (drop-path masks) and a numpy
    generator (data), seeded with the JAX package's default seeds. No global
    random state is touched."""
    return (
        torch.Generator(device=device).manual_seed(torch_seed),
        np.random.default_rng(numpy_seed),
    )
