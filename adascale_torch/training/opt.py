"""Training utilities (counterpart of ``adascale/training/opt.py``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def setup_seeds(
    numpy_seed: int = 1337, torch_seed: int = 133, device: str = "cuda"
) -> Tuple[torch.Generator, np.random.Generator]:
    """A ``torch.Generator`` on ``device`` (drop-path masks; the card unless
    the caller passes ``device="cpu"``, raising when no card is there) and a
    numpy generator (data), seeded with the JAX package's default seeds. No
    global random state is touched."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to draw the masks on the CPU"
        )
    return (
        torch.Generator(device=device).manual_seed(torch_seed),
        np.random.default_rng(numpy_seed),
    )


def calculate_iterable_dataset_num_samples(batch_size: int, num_batches: int) -> int:
    """Pairs an epoch of ``num_batches`` batches of ``batch_size`` takes."""
    return batch_size * num_batches
