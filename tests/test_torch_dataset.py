"""The port's dataset pipeline and prefetcher (``adascale_torch/data/
dataset.py``, ``prefetch.py``) against the JAX package's, on the CPU with
the native renderer. Every bar is equality, of collated batches by
``training.batch_checksum`` (each array's dtype, shape and bytes) and of the
metadata beside them:

  * ``run_pipeline``'s samples, for a small pipeline (crop resizes both
    ways, the page homography on half the pages) and the flagship's steps
    (768² pages, 512² rough and 320² precise crops), and the rebalanced
    (precise -> rough) stream;
  * the dataset in dev mode, streaming with a shuffle cache, with
    ``num_samples_reset_rng`` and with ``sample_reuse``;
  * a 2-process (spawned) pool against the inline run;
  * the prefetcher's order, stall accounting, failure and stop, the cases
    of ``tests/test_prefetch.py``.
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest

from adascale.data import dataset as JD
from adascale.utils.config import load_config as jax_load_config
from adascale_torch.data import dataset as TD
from adascale_torch.data.prefetch import BatchPrefetcher
from adascale_torch.training import batch_checksum
from adascale_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_STEPS = os.path.join(ROOT, "examples", "flagship_training", "steps.json")

SMALL = dict(
    page=dict(
        page_height=192, page_width=192, num_lines_min=3, num_lines_max=6, char_height_min=10,
        char_height_max=28, perspective_prob=0.5, render_backend="native",
    ),
    rough_crop_size=96,
    rough_core_margin=4,
    precise_crop_size=64,
    precise_core_margin=2,
    rough_samples_per_page=2,
    precise_samples_per_page=3,
    precise_target_char_height_min=12.0,
    precise_target_char_height_max=40.0,
)
REBALANCED = dict(
    SMALL, rough_crop_size=64, rough_core_margin=2, rough_samples_per_page=1, precise_samples_per_page=4,
    enable_transform_precise_to_rough=True,
)


def _pipelines(steps):
    return jax_load_config(steps, JD.SynthPipelineConfig), load_config(steps, TD.SynthPipelineConfig)


def _flagship_steps():
    with open(FLAGSHIP_STEPS) as f:
        steps = json.load(f)
    assert steps["page"]["render_backend"] == "auto"
    return steps


def _arrays(batch):
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def _assert_batches_equal(got, want):
    """Collated batch dicts of the two packages: the same arrays, shapes,
    core boxes and provenance."""
    for part in ("rough", "precise"):
        g, w = got[part], want[part]
        assert set(g) == set(w)
        assert batch_checksum(_arrays(g)) == batch_checksum(_arrays(w)), part
        assert tuple(g["downsampled_shape"]) == tuple(w["downsampled_shape"])
        assert tuple(g["downsampled_core_box"]) == tuple(w["downsampled_core_box"])
        assert g["rng_states"] == w["rng_states"]


def _sample_arrays(sample):
    """A sample's arrays by name, its char labels stacked."""
    out = {k: v for k, v in vars(sample).items() if isinstance(v, np.ndarray)}
    labels = getattr(sample, "char_labels", None)
    if labels is not None:
        out["label_points"] = np.asarray([lab[:2] for lab in labels], np.int64)
        for i, name in enumerate(("offsets", "angles", "distances")):
            out[name] = np.stack([lab[2 + i] for lab in labels])
    return out


def _assert_samples_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert batch_checksum(_sample_arrays(g)) == batch_checksum(_sample_arrays(w))
        assert tuple(g.downsampled_shape) == tuple(w.downsampled_shape)
        assert dataclasses.astuple(g.downsampled_core_box) == dataclasses.astuple(w.downsampled_core_box)
        assert g.rng_state == w.rng_state


@pytest.mark.parametrize("which", ["small", "flagship", "rebalanced"])
def test_run_pipeline_equals_jax(which):
    steps = {"small": SMALL, "flagship": _flagship_steps(), "rebalanced": REBALANCED}[which]
    jp, tp = _pipelines(steps)
    moved = 0
    for run_idx in range(2 if which == "flagship" else 4):
        (rough_t, precise_t), (rough_j, precise_j) = TD.run_pipeline(tp, 7, run_idx), JD.run_pipeline(jp, 7, run_idx)
        _assert_samples_equal(rough_t, rough_j)
        _assert_samples_equal(precise_t, precise_j)
        moved += len(rough_t) - tp.rough_samples_per_page
    assert (moved > 0) == (which == "rebalanced")


def _stream(module, cfg, n):
    """The first ``n`` pairs of a dataset, collated two at a time."""
    dataset = module.AdaptiveScalingIterableDataset(cfg)
    try:
        pairs = list(zip(range(n), dataset))
        batches = [module.collate_samples([p for _, p in pairs[i : i + 2]]) for i in range(0, n, 2)]
    finally:
        dataset.pool.cleanup()
    return batches


DATASET_CASES = {
    "dev": dict(is_dev=True, num_samples=6),
    "stream_cached": dict(num_samples=8, num_cached_runs=3),
    "reset_rng": dict(num_samples=10, num_samples_reset_rng=4, num_cached_runs=2),
    "sample_reuse": dict(num_samples=10, num_cached_runs=2, sample_reuse=3),
}


@pytest.mark.parametrize("case", list(DATASET_CASES))
def test_dataset_streams_equal_jax(case):
    kwargs = dict(steps_json=json.dumps(SMALL), num_page_char_regression_labels=12, rng_seed=21, **DATASET_CASES[case])
    n = kwargs["num_samples"]
    got = _stream(TD, TD.AdaptiveScalingDatasetConfig(**kwargs), n)
    want = _stream(JD, JD.AdaptiveScalingDatasetConfig(**kwargs), n)
    assert len(got) == len(want) == n // 2
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    if case == "reset_rng":
        # Each cycle of 4 pairs draws its rough crops from the same runs.
        def rough_images(batches):
            return sorted(batch_checksum({"i": im}) for b in batches for im in b["rough"]["image"])

        assert rough_images(got[:2]) == rough_images(got[2:4])


def test_pool_equals_inline():
    kwargs = dict(steps_json=json.dumps(SMALL), num_page_char_regression_labels=12, rng_seed=5, num_samples=8,
                  num_cached_runs=3)
    inline = _stream(TD, TD.AdaptiveScalingDatasetConfig(**kwargs), 8)
    pooled = _stream(TD, TD.AdaptiveScalingDatasetConfig(num_processes=2, **kwargs), 8)
    for g, w in zip(pooled, inline):
        _assert_batches_equal(g, w)


def test_python_render_backend_streams_the_jax_labels():
    """A dataset on the ``"python"`` backend starts (no refusal before its
    first page) and, on a 2-process pool, streams the JAX dataset's labels
    bit for bit; its images lie within ``tests/test_torch_render_python.py``'s
    bound (here equal)."""
    steps = dict(SMALL, page=dict(SMALL["page"], render_backend="python"))
    kwargs = dict(steps_json=json.dumps(steps), num_page_char_regression_labels=12, rng_seed=3, num_samples=4,
                  is_dev=True)
    got = _stream(TD, TD.AdaptiveScalingDatasetConfig(num_processes=2, **kwargs), 4)
    want = _stream(JD, JD.AdaptiveScalingDatasetConfig(**kwargs), 4)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_collate_refuses_an_empty_batch():
    with pytest.raises(ValueError, match="at least one pair"):
        TD.collate_samples([])


def test_prefetch_order_and_accounting():
    counter = {"n": 0}

    def make_batch():
        v = counter["n"]
        counter["n"] += 1
        return v

    pf = BatchPrefetcher(make_batch, depth=2)
    got = [pf.get() for _ in range(8)]
    assert got == list(range(8))
    assert pf.batches_served == 8
    pf.reset_stall_accounting()
    assert pf.stall_seconds == 0.0 and pf.batches_served == 0
    pf.stop()


def test_prefetch_overlaps_slow_producer():
    def make_batch():
        time.sleep(0.05)
        return 1

    pf = BatchPrefetcher(make_batch, depth=2)
    time.sleep(0.3)  # the queue fills while the consumer computes
    t0 = time.perf_counter()
    pf.get()
    assert time.perf_counter() - t0 < 0.04  # already queued: no stall
    pf.stop()


def test_prefetch_propagates_exceptions():
    state = {"n": 0}

    def make_batch():
        if state["n"] >= 1:
            raise ValueError("generator broke")
        state["n"] += 1
        return 0

    pf = BatchPrefetcher(make_batch, depth=1)
    assert pf.get() == 0
    with pytest.raises(RuntimeError, match="prefetch thread failed"):
        pf.get()
    pf.stop()


def test_prefetch_stop_idempotent():
    pf = BatchPrefetcher(lambda: 0, depth=1)
    pf.get()
    pf.stop()
    pf.stop()
    assert not pf._thread.is_alive()
