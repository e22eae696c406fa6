"""Manual profiling and dataset-inspection helpers.

Counterpart of ``adascale/tools/inspect.py``:

  * ``profile_forward``: seconds a batch of ``forward_rough`` and
    ``forward_precise``, warm (CUDA events and a synchronize on the card;
    the host clock on the CPU); with ``trace_dir``, a ``torch.profiler``
    Chrome trace of each entry (``<trace_dir>/<entry>.json``). The TPU
    tool's chained scans do not apply.
  * ``sample_dataset``: renders the synthetic samples' labels over their
    images (``utils/painter.py``) as ``{idx}_rough_mask.png``,
    ``{idx}_rough_score.png`` and ``{idx}_precise_labels.png``.
  * ``profile_dataset``: wall-clock latency of the host data pipeline and
    its collation, per batch.
"""
from __future__ import annotations

import os
import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch


def profile_forward(
    model_config=None,
    resolution: int = 640,
    batch: int = 1,
    iters: int = 10,
    trace_dir: Optional[str] = None,
    device: str = "cuda",
) -> Dict[str, float]:
    """Seconds a batch of ``forward_rough`` / ``forward_precise`` of a model
    at ``model_config`` (the tiny/FPN default), parameters drawn as the JAX
    package's init draws them, on a uniform [0, 1) input."""
    from ..models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig, init_like_flax_
    from .train_profile import resolve, seconds_per_call

    dev = resolve(device)
    model = AdaptiveScaling(model_config or AdaptiveScalingConfig())
    init_like_flax_(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    x = torch.rand(batch, resolution, resolution, 3, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    results = {}
    with torch.inference_mode():
        for name in ("forward_rough", "forward_precise"):
            method = getattr(model, name)
            results[name] = seconds_per_call(lambda: method(x), iters, dev)
            if trace_dir:
                os.makedirs(trace_dir, exist_ok=True)
                activities = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                with torch.profiler.profile(activities=activities) as prof:
                    method(x)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
    return results


def _to_image_space(core_map: np.ndarray, sample) -> np.ndarray:
    """A core-sized downsampled map -> the sample image's resolution."""
    from ..inference.flatten import resize_nearest

    dh, dw = sample.downsampled_shape
    full = np.zeros((dh, dw), dtype=np.float32)
    cb = sample.downsampled_core_box
    full[cb.up : cb.down + 1, cb.left : cb.right + 1] = core_map
    ih, iw = sample.image.shape[:2]
    return resize_nearest(full, (ih, iw))


def sample_dataset(
    steps_json: str,
    output_folder: str,
    num_batches: int = 2,
    batch_size: int = 2,
    num_page_char_regression_labels: int = 50,
    rng_seed: int = 0,
) -> None:
    """Renders rough / precise samples (mask, score map, label points) to
    PNG under ``output_folder``."""
    from ..data.dataset import AdaptiveScalingDatasetConfig, AdaptiveScalingIterableDataset
    from ..utils.painter import Painter

    os.makedirs(output_folder, exist_ok=True)
    dataset = AdaptiveScalingIterableDataset(
        AdaptiveScalingDatasetConfig(
            steps_json=steps_json,
            num_page_char_regression_labels=num_page_char_regression_labels,
            num_samples=num_batches * batch_size,
            rng_seed=rng_seed,
            num_processes=0,
        )
    )
    it = iter(dataset)
    for idx in range(num_batches * batch_size):
        rough, precise = next(it)
        Painter(rough.image).paint_mask(_to_image_space(rough.downsampled_mask, rough) > 0).to_file(
            os.path.join(output_folder, f"{idx}_rough_mask.png")
        )
        Painter(rough.image).paint_score_map(_to_image_space(rough.downsampled_score_map, rough)).to_file(
            os.path.join(output_folder, f"{idx}_rough_score.png")
        )
        painter = Painter(precise.image)
        painter.paint_mask(_to_image_space(precise.downsampled_mask, precise) > 0)
        factor = precise.image.shape[0] / precise.downsampled_shape[0]
        # CharLabel tuples: (point_y, point_x, offsets, angles, distances).
        pts = np.asarray([(lbl[1], lbl[0]) for lbl in precise.char_labels], dtype=np.float64)
        if len(pts):
            painter.paint_points(pts * factor)
        painter.to_file(os.path.join(output_folder, f"{idx}_precise_labels.png"))
    dataset.pool.cleanup()


def profile_dataset(
    steps_json: str,
    num_batches: int = 10,
    batch_size: int = 4,
    num_processes: int = 0,
    rng_seed: int = 0,
) -> Dict[str, float]:
    """Wall-clock latency statistics of the host synth-data pipeline and
    its collation."""
    from ..data.dataset import AdaptiveScalingDatasetConfig, AdaptiveScalingIterableDataset, collate_samples

    dataset = AdaptiveScalingIterableDataset(
        AdaptiveScalingDatasetConfig(
            steps_json=steps_json,
            num_page_char_regression_labels=50,
            num_samples=num_batches * batch_size,
            rng_seed=rng_seed,
            num_processes=num_processes,
        )
    )
    it = iter(dataset)
    latencies = []
    for _ in range(num_batches):
        t0 = time.perf_counter()
        pairs = [next(it) for _ in range(batch_size)]
        collate_samples(pairs)
        latencies.append(time.perf_counter() - t0)
    dataset.pool.cleanup()
    return {
        "mean_s": statistics.mean(latencies),
        "median_s": statistics.median(latencies),
        "max_s": max(latencies),
        "batches_per_s": 1.0 / statistics.mean(latencies),
    }
