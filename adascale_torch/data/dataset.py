"""Dataset pipeline: synthetic pages -> rough/precise training samples.

Counterpart of ``adascale/data/dataset.py``, without OpenCV:

  * ``RoughSample`` / ``PreciseSample`` carry the crop, its downsampled
    shape and core box, the core-cropped mask / score-map labels (and the
    per-char regression labels of a precise crop) and the (rng_seed,
    run_idx) pair that regenerates them;
  * ``run_pipeline`` turns one page into rough and precise crops; a precise
    crop is resized by the ``cv2.resize`` twins of ``inference/flatten.py``
    (INTER_AREA when it shrinks, INTER_LINEAR otherwise), so its pixels equal
    the JAX package's;
  * ``GeneratorPool`` runs pages in worker processes or inline (the same
    samples either way). Its workers are *spawned*, never forked: the
    training loop's process holds a CUDA context and a prefetch thread, and
    a forked child of such a process may deadlock. A worker needs numpy and
    the native renderer, which the parent builds before the pool starts;
  * ``AdaptiveScalingIterableDataset`` streams (rough, precise) pairs: dev
    mode pre-generates exactly ``num_samples`` pairs; training mode streams
    with an optional shuffle cache of ``num_cached_runs`` runs, an rng reset
    every ``num_samples_reset_rng`` pairs (overfit mode) and
    ``sample_reuse``; each precise sample draws exactly
    ``num_page_char_regression_labels`` char labels, with replacement when
    short;
  * ``collate_samples`` builds the two batch dicts (NHWC; images and masks
    stay uint8 until they reach the card).
"""
from __future__ import annotations

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
from numpy.random import default_rng

from ..inference.flatten import resize_area, resize_linear
from ..losses import CoreBox
from ..utils.config import config_to_dict, load_config
from .geometry import Box
from .synth import (
    CharInstance,
    SynthPage,
    SynthPageConfig,
    char_regression_label,
    check_backend,
    generate_page,
    render_char_labels,
)

CharLabel = Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass(frozen=True)
class SynthPipelineConfig:
    """Page generation and cropping knobs (the steps JSON); the same fields
    and defaults as the JAX package's."""

    page: SynthPageConfig = SynthPageConfig()
    downsample_factor: int = 2
    rough_crop_size: int = 640
    rough_core_margin: int = 16
    rough_samples_per_page: int = 2
    precise_crop_size: int = 320
    precise_core_margin: int = 8
    precise_samples_per_page: int = 4
    precise_target_char_height_min: float = 22.0
    precise_target_char_height_max: float = 50.0
    # Move ~half the precise text-region crops into the rough stream. Needs
    # matching rough/precise crop sizes and core margins, so that the rough
    # batch keeps one shape.
    enable_transform_precise_to_rough: bool = False


@dataclasses.dataclass
class RoughSample:
    image: np.ndarray  # (S, S, 3) uint8
    downsampled_shape: Tuple[int, int]
    downsampled_core_box: Box
    downsampled_mask: np.ndarray  # core-sized (CH, CW) uint8
    downsampled_score_map: np.ndarray  # core-sized (CH, CW) float32
    rng_state: Mapping


@dataclasses.dataclass
class PreciseSample:
    image: np.ndarray
    downsampled_shape: Tuple[int, int]
    downsampled_core_box: Box
    downsampled_mask: np.ndarray
    downsampled_score_map: np.ndarray  # gaussian heatmap, core-sized
    char_labels: Sequence[CharLabel]
    rng_state: Mapping
    # The crop's char-height map (core-sized), kept so that the crop can be
    # moved into the rough stream, whose score map is a height map.
    downsampled_char_height_score_map: Optional[np.ndarray] = None


def _chars_in_box(chars: Sequence[CharInstance], box: Box) -> List[CharInstance]:
    out = []
    for c in chars:
        xs, ys = c.corners[:, 0], c.corners[:, 1]
        if xs.min() >= box.left and xs.max() <= box.right and ys.min() >= box.up and ys.max() <= box.down:
            out.append(
                CharInstance(corners=c.corners - np.asarray([[box.left, box.up]], np.float32), height=c.height)
            )
    return out


def _core_box(downsampled_shape: Tuple[int, int], margin: int) -> Box:
    dh, dw = downsampled_shape
    return Box(margin, dh - 1 - margin, margin, dw - 1 - margin)


def crop_rough_sample(
    page: SynthPage, pipeline: SynthPipelineConfig, rng: np.random.Generator, rng_state: Mapping
) -> RoughSample:
    s = pipeline.rough_crop_size
    f = pipeline.downsample_factor
    h, w = page.image.shape[:2]
    y0 = int(rng.integers(0, max(1, h - s + 1)))
    x0 = int(rng.integers(0, max(1, w - s + 1)))
    box = Box(y0, y0 + s - 1, x0, x0 + s - 1)
    image = box.extract(page.image).copy()
    chars = _chars_in_box(page.chars, box)

    mask, height_map, _ = render_char_labels(
        chars, (s, s), f, page.config.gaussian_sigma_ratio, backend=page.config.render_backend
    )
    dshape = (s // f, s // f)
    core = _core_box(dshape, pipeline.rough_core_margin)
    return RoughSample(
        image=image,
        downsampled_shape=dshape,
        downsampled_core_box=core,
        downsampled_mask=core.extract(mask).astype(np.uint8),
        downsampled_score_map=core.extract(height_map).astype(np.float32),
        rng_state=rng_state,
    )


def crop_precise_sample(
    page: SynthPage,
    pipeline: SynthPipelineConfig,
    rng: np.random.Generator,
    rng_state: Mapping,
    attempts: int = 8,
) -> Optional[PreciseSample]:
    """A precise crop; retries a few (line, target-height, jitter) draws
    before giving up, since small crops at large rescale factors can miss
    every char."""
    for _ in range(attempts):
        sample = _crop_precise_sample_once(page, pipeline, rng, rng_state)
        if sample is not None:
            return sample
    return None


def _crop_precise_sample_once(
    page: SynthPage, pipeline: SynthPipelineConfig, rng: np.random.Generator, rng_state: Mapping
) -> Optional[PreciseSample]:
    if not page.lines:
        return None
    s = pipeline.precise_crop_size
    f = pipeline.downsample_factor
    h, w = page.image.shape[:2]

    line = page.lines[int(rng.integers(0, len(page.lines)))]
    target = float(rng.uniform(pipeline.precise_target_char_height_min, pipeline.precise_target_char_height_max))
    scale = target / line.char_height
    src_size = int(round(s / scale))
    src_size = min(src_size, h, w)
    scale = s / src_size

    lb = line.bounding_box()
    cy = (lb.up + lb.down) / 2 + float(rng.uniform(-0.2, 0.2)) * src_size
    cx = (lb.left + lb.right) / 2 + float(rng.uniform(-0.3, 0.3)) * src_size
    y0 = int(np.clip(cy - src_size / 2, 0, h - src_size))
    x0 = int(np.clip(cx - src_size / 2, 0, w - src_size))
    src_box = Box(y0, y0 + src_size - 1, x0, x0 + src_size - 1)

    src = src_box.extract(page.image)
    image = resize_area(src, (s, s)) if scale < 1.0 else resize_linear(src, (s, s))

    chars_src = _chars_in_box(page.chars, src_box)
    chars = [CharInstance(corners=c.corners * scale, height=c.height * scale) for c in chars_src]
    # Keep chars fully inside the resized crop.
    chars = _chars_in_box(chars, Box(0, s - 1, 0, s - 1))
    if not chars:
        return None

    mask, height_map, gaussian = render_char_labels(
        chars, (s, s), f, page.config.gaussian_sigma_ratio, backend=page.config.render_backend
    )
    dshape = (s // f, s // f)
    core = _core_box(dshape, pipeline.precise_core_margin)

    labels: List[CharLabel] = []
    for c in chars:
        label = char_regression_label(c, f, dshape)
        if label is not None:
            labels.append(label)
    if not labels:
        return None

    return PreciseSample(
        image=image,
        downsampled_shape=dshape,
        downsampled_core_box=core,
        downsampled_mask=core.extract(mask).astype(np.uint8),
        downsampled_score_map=core.extract(gaussian).astype(np.float32),
        char_labels=labels,
        rng_state=rng_state,
        downsampled_char_height_score_map=core.extract(height_map).astype(np.float32),
    )


def run_pipeline(
    pipeline: SynthPipelineConfig, rng_seed: int, run_idx: int
) -> Tuple[List[RoughSample], List[PreciseSample]]:
    """One generator run: one synthetic page -> rough and precise samples,
    fully determined by (rng_seed, run_idx)."""
    rng = default_rng([rng_seed, run_idx])
    rng_state = {"rng_seed": rng_seed, "run_idx": run_idx}
    page = generate_page(pipeline.page, rng)

    rough = [crop_rough_sample(page, pipeline, rng, rng_state) for _ in range(pipeline.rough_samples_per_page)]
    precise: List[PreciseSample] = []
    for _ in range(pipeline.precise_samples_per_page):
        sample = crop_precise_sample(page, pipeline, rng, rng_state)
        if sample is not None:
            precise.append(sample)

    if pipeline.enable_transform_precise_to_rough and precise:
        # Shuffle, then move (n_p + n_r) // 2 - n_r precise crops into the
        # rough stream, with the char-HEIGHT map as their score map.
        if not (
            pipeline.rough_crop_size == pipeline.precise_crop_size
            and pipeline.rough_core_margin == pipeline.precise_core_margin
        ):
            raise ValueError("precise->rough rebalancing requires matching crop sizes and core margins")
        order = rng.permutation(len(precise))
        precise = [precise[i] for i in order]
        n_move = max(0, (len(precise) + len(rough)) // 2 - len(rough))
        for p in precise[:n_move]:
            rough.append(
                RoughSample(
                    image=p.image,
                    downsampled_shape=p.downsampled_shape,
                    downsampled_core_box=p.downsampled_core_box,
                    downsampled_mask=p.downsampled_mask,
                    downsampled_score_map=p.downsampled_char_height_score_map,
                    rng_state=p.rng_state,
                )
            )
        precise = precise[n_move:]
    return rough, precise


def _pool_worker(args):
    pipeline_dict, rng_seed, run_idx = args
    return run_pipeline(load_config(pipeline_dict, SynthPipelineConfig), rng_seed, run_idx)


class GeneratorPool:
    """Page-generator pool: ``num_processes`` spawned workers, or inline
    with 0; the samples of a (rng_seed, run_idx) pair are the same either
    way. Spawned workers import the main module again, so a script that
    builds a pool runs under ``if __name__ == "__main__":``."""

    def __init__(
        self,
        pipeline: SynthPipelineConfig,
        rng_seed: int,
        num_processes: int = 0,
        num_runs_reset_rng: Optional[int] = None,
        inventory: Optional[int] = None,
    ):
        self.pipeline = pipeline
        self.rng_seed = rng_seed
        self.num_processes = num_processes
        self.num_runs_reset_rng = num_runs_reset_rng
        self.run_idx = 0
        self._pool = None
        self._pending: List[Any] = []
        self._inventory = inventory or max(4, num_processes * 12)
        if num_processes > 0:
            from .. import native

            # Built once here: the workers load the same library.
            native.load_library()
            self._pipeline_dict = config_to_dict(pipeline)
            # An executor, not multiprocessing.Pool: a worker that dies makes
            # the next result raise (BrokenProcessPool) instead of waiting.
            self._pool = ProcessPoolExecutor(num_processes, mp_context=multiprocessing.get_context("spawn"))

    def _next_run_idx(self) -> int:
        idx = self.run_idx
        self.run_idx += 1
        if self.num_runs_reset_rng:
            idx = idx % self.num_runs_reset_rng
        return idx

    def reset(self) -> None:
        """Restart the run-index stream at 0 (dropping in-flight runs, so the
        next ``run()`` replays run_idx 0)."""
        self.run_idx = 0
        self._pending.clear()

    def run(self) -> Tuple[List[RoughSample], List[PreciseSample]]:
        if self._pool is None:
            return run_pipeline(self.pipeline, self.rng_seed, self._next_run_idx())
        # Keep the inventory of in-flight runs topped up.
        while len(self._pending) < self._inventory:
            idx = self._next_run_idx()
            self._pending.append(self._pool.submit(_pool_worker, (self._pipeline_dict, self.rng_seed, idx)))
        return self._pending.pop(0).result()

    def cleanup(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            self._pending.clear()


@dataclasses.dataclass(frozen=True)
class AdaptiveScalingDatasetConfig:
    """The dataset's knobs; ``steps_json`` hydrates a SynthPipelineConfig."""

    steps_json: Optional[str] = None
    num_samples: int = 64
    num_page_char_regression_labels: int = 200
    rng_seed: int = 1337
    num_processes: int = 0
    num_samples_reset_rng: Optional[int] = None
    num_cached_runs: Optional[int] = None
    is_dev: bool = False
    # Yield each generated pair this many times (through a seeded shuffled
    # replay buffer, so repeats land in different batches, with the precise
    # label subset drawn again each time); it divides the generation cost a
    # consumed pair by this factor. 1 = off.
    sample_reuse: int = 1


class AdaptiveScalingIterableDataset:
    """Streams (RoughSample, PreciseSample) pairs."""

    def __init__(self, config: AdaptiveScalingDatasetConfig):
        self.config = config
        self.pipeline = load_config(config.steps_json, SynthPipelineConfig)
        check_backend(self.pipeline.page.render_backend)
        # The rng reset counts yielded PAIRS (a run yields a variable number
        # of samples): __iter__ restarts the pool's run stream every
        # num_samples_reset_rng pairs, so overfit mode cycles a fixed set of
        # exactly that many pairs.
        self.pool = GeneratorPool(self.pipeline, rng_seed=config.rng_seed, num_processes=config.num_processes)
        self._pairs_total = 0
        self.rng = default_rng(config.rng_seed)

        self.dev_rough_samples: List[RoughSample] = []
        self.dev_precise_samples: List[PreciseSample] = []
        if config.is_dev:
            try:
                while (
                    len(self.dev_rough_samples) < config.num_samples
                    or len(self.dev_precise_samples) < config.num_samples
                ):
                    rough, precise = self.pool.run()
                    self.dev_rough_samples.extend(rough)
                    self.dev_precise_samples.extend(precise)
            finally:
                self.pool.cleanup()
            self.dev_rough_samples = self.dev_rough_samples[: config.num_samples]
            self.dev_precise_samples = self.dev_precise_samples[: config.num_samples]
            for sample in self.dev_precise_samples:
                sample.char_labels = self._resample_labels(sample.char_labels)

    def _resample_labels(self, labels: Sequence[CharLabel]) -> List[CharLabel]:
        p = self.config.num_page_char_regression_labels
        idx = self.rng.choice(len(labels), size=p, replace=len(labels) < p)
        return [labels[i] for i in idx]

    def __iter__(self) -> Iterator[Tuple[RoughSample, PreciseSample]]:
        if self.config.is_dev:
            yield from zip(self.dev_rough_samples, self.dev_precise_samples)
            return

        cached_rough: List[RoughSample] = []
        cached_precise: List[PreciseSample] = []
        reuse = max(1, self.config.sample_reuse)
        replay: List[Tuple[RoughSample, PreciseSample]] = []
        for _ in range(self.config.num_samples):
            reset = self.config.num_samples_reset_rng
            if reset and self._pairs_total % reset == 0:
                # A new cycle over the same run set: the stream repeats a
                # fixed set of exactly `reset` pairs, with nothing replayed
                # from the cycle before.
                self.pool.reset()
                cached_rough.clear()
                cached_precise.clear()
                replay.clear()
            # Serve from the replay buffer with probability (reuse-1)/reuse
            # (the cap drains it after a fresh streak); the short circuit
            # keeps reuse=1 from drawing anything.
            if replay and (len(replay) > 64 or float(self.rng.random()) < (reuse - 1) / reuse):
                idx = int(self.rng.integers(len(replay)))
                rough_sample, precise_sample = replay.pop(idx)
                self._pairs_total += 1
                yield (
                    rough_sample,
                    dataclasses.replace(
                        precise_sample, char_labels=self._resample_labels(precise_sample.char_labels)
                    ),
                )
                continue
            if not cached_rough or not cached_precise:
                cached_rough.clear()
                cached_precise.clear()
            refill_rounds = 0
            while not cached_rough or not cached_precise:
                refill_rounds += 1
                if refill_rounds > 100:
                    raise RuntimeError(
                        "dataset refill produced no samples after 100 rounds; "
                        "check the pipeline config (crop sizes vs char heights)"
                    )
                runs = self.config.num_cached_runs or 1
                for _ in range(runs):
                    rough, precise = self.pool.run()
                    cached_rough.extend(rough)
                    cached_precise.extend(precise)
                if self.config.num_cached_runs:
                    self.rng.shuffle(cached_rough)
                    self.rng.shuffle(cached_precise)

            rough_sample = cached_rough.pop()
            precise_sample = cached_precise.pop()
            if reuse > 1:
                # Replayed copies keep the original label list; each yield
                # draws its own subset of it.
                for _ in range(reuse - 1):
                    replay.append((rough_sample, precise_sample))
            precise_sample = dataclasses.replace(
                precise_sample, char_labels=self._resample_labels(precise_sample.char_labels)
            )
            self._pairs_total += 1
            yield rough_sample, precise_sample


def _box_to_core(box: Box) -> CoreBox:
    return CoreBox(box.up, box.down, box.left, box.right)


def collate_samples(batch: Sequence[Tuple[RoughSample, PreciseSample]]) -> Dict[str, Dict[str, Any]]:
    """The rough and precise batch dicts, NHWC. Images and 0/1 masks stay
    uint8 (the step up-casts them on the card); score maps and targets are
    f32, label points int32."""
    if not batch:
        raise ValueError("collate_samples needs at least one pair")
    rough_images, rough_masks, rough_scores = [], [], []
    rough_rng_states: List[Mapping] = []
    precise_images, precise_masks, precise_scores = [], [], []
    p_y, p_x, p_off, p_ang, p_dist = [], [], [], [], []
    precise_rng_states: List[Mapping] = []
    rough_shape = rough_core = precise_shape = precise_core = None

    for rough, precise in batch:
        rough_images.append(rough.image)
        rough_masks.append(rough.downsampled_mask)
        rough_scores.append(rough.downsampled_score_map)
        rough_shape, rough_core = rough.downsampled_shape, rough.downsampled_core_box
        rough_rng_states.append(rough.rng_state)

        precise_images.append(precise.image)
        precise_masks.append(precise.downsampled_mask)
        precise_scores.append(precise.downsampled_score_map)
        precise_shape = precise.downsampled_shape
        precise_core = precise.downsampled_core_box
        precise_rng_states.append(precise.rng_state)

        labels = precise.char_labels
        p_y.append(np.asarray([lab[0] for lab in labels], dtype=np.int32))
        p_x.append(np.asarray([lab[1] for lab in labels], dtype=np.int32))
        p_off.append(np.stack([lab[2] for lab in labels]).astype(np.float32))
        p_ang.append(np.stack([lab[3] for lab in labels]).astype(np.float32))
        # The up-left distance is left out (the collate contract).
        p_dist.append(np.stack([lab[4][1:] for lab in labels]).astype(np.float32))

    rough_batch: Dict[str, Any] = {
        "image": np.stack(rough_images),
        "downsampled_mask": np.stack(rough_masks),
        "downsampled_score_map": np.stack(rough_scores),
        "downsampled_shape": rough_shape,
        "downsampled_core_box": _box_to_core(rough_core),
        "rng_states": rough_rng_states,
    }
    precise_batch: Dict[str, Any] = {
        "image": np.stack(precise_images),
        "downsampled_mask": np.stack(precise_masks),
        "downsampled_score_map": np.stack(precise_scores),
        "downsampled_label_point_y": np.stack(p_y),
        "downsampled_label_point_x": np.stack(p_x),
        "up_left_offsets": np.stack(p_off),
        "corner_angles": np.stack(p_ang),
        "corner_distances": np.stack(p_dist),
        "downsampled_shape": precise_shape,
        "downsampled_core_box": _box_to_core(precise_core),
        "rng_states": precise_rng_states,
    }
    return {"rough": rough_batch, "precise": precise_batch}
