"""The training driver: configs, data, the two-task step, dev eval,
checkpoints.

Counterpart of ``adascale/training/loop.py``: config hydration and echo into
the run folder, dev-set pre-generation, the per-epoch-index dataset
curriculum, one optimizer step per rough + precise pair (each loss / 2),
sliding-window metrics logged every 4 batches, dev evaluation each epoch,
and best / curriculum / final checkpoints (``training/checkpoint.py``).

Batches move to the card as the pipeline makes them: uint8 images and
masks, f16 score maps (``_clean_batch``, as the JAX loop compacts them),
up-cast to f32 on the card by the step. With ``prefetch_depth`` > 0 a
background thread pulls and collates batch N+1, copies it from pinned
memory on a side stream and records an event; the step waits on that event
while the card runs step N.

``compute_dtype="bfloat16"`` (the flagships' own setting) builds the model
at bf16 as the JAX loop does (``AdaptiveScaling(config, torch.bfloat16)``,
the module path with its f32 residual stream); parameters, optimizer
moments, losses and checkpoints stay f32, so an exported checkpoint is f32
at either dtype. Every step and dev batch then runs the blocks through the
bf16 kernel's module mode.

``use_mesh=True`` trains data-parallel over ``parallel.create_mesh``: one
process a card under ``torchrun`` (``python -m torch.distributed.run
--standalone --nproc_per_node=N -m adascale_torch train --mesh ...``), or
world size 1 in this process. As the JAX loop does with processes, each
rank generates its ``local_batch_size`` rows of every batch with its own
generator pool from ``per_process_seed(seed)``, and the step and the dev
batches compute the global batch's losses (``training/train_step.py``).
Rank 0 alone writes the output folder, ``log.txt`` and the checkpoints; the
other ranks wait for the folder and each checkpoint. Every rank restores. At world size 1 the data
and the losses are those of ``use_mesh=False``.

Entry points run on the card unless ``device="cpu"``; they raise when no
card is there.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import (
    AdaptiveScalingDatasetConfig,
    AdaptiveScalingIterableDataset,
    SynthPipelineConfig,
    collate_samples,
)
from ..data.prefetch import BatchPrefetcher
from ..kernels import convnext_block as block_kernel
from ..losses import AdaptiveScalingPreciseLossConfig, AdaptiveScalingRoughLossConfig, CoreBox
from ..models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig, init_like_flax_
from ..parallel.mesh import create_mesh, local_batch_size, mesh_device, per_process_seed, replicate
from ..utils.config import config_to_dict, dump_config, load_config
from ..utils.params import load_params, state_dict_from_jax
from .checkpoint import restore_checkpoint, restore_pytree_numpy, save_checkpoint, set_opt_step
from .metrics import Metrics
from .opt import calculate_iterable_dataset_num_samples
from .optimizer import OptimizerConfig, build_optimizer
from .train_step import (
    TrainStepConfig,
    make_eval_step,
    make_grad_inspection_fn,
    make_train_step,
    resolve_device,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class EpochConfig:
    """The JAX package's ``EpochConfig``, field for field, so that one JSON
    serves both loops. ``jax_seed`` seeds the model's initialisation and the
    drop-path generator here."""

    jax_seed: int = 133
    num_epochs: int = 110
    num_page_char_regression_labels: int = 200
    train_num_batches: int = 1000
    train_batch_size: int = 6
    train_rng_seed: int = 13371
    train_num_processes: int = 10
    dev_num_batches: int = 70
    dev_batch_size: int = 22
    dev_rng_seed: int = 13
    dev_num_processes: int = 32
    avg_num_batches: int = 50
    enable_overfit_testing: bool = False
    enable_multitask_gradiant_inspection: bool = False
    # With inspection on, also log each shared (backbone) parameter's
    # per-task gradient magnitude.
    multitask_gradiant_inspection_per_parameter: bool = False
    # > 0 traces that many leading batches of epoch 0 with torch.profiler
    # into <output_folder>/profile (a Chrome trace; rank 0's on a mesh).
    profile_num_batches: int = 0
    # Recompute each pass's forward in the backward (less memory, twice the
    # block launches).
    remat: bool = False
    # Batches prepared ahead on a background thread; 0 prepares each one
    # inline.
    prefetch_depth: int = 2
    # The model's dtype, "float32" or "bfloat16"; parameters, optimizer
    # state and losses stay f32.
    compute_dtype: str = "float32"
    # Yield each generated train pair this many times (data/dataset.py
    # sample_reuse). 1 = off.
    train_sample_reuse: int = 1


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Per-epoch-index curriculum: the steps JSON and rng seed each listed
    epoch index switches to."""

    train_adaptive_scaling_dataset_steps_jsons: Sequence[str] = ()
    train_rng_seeds: Sequence[int] = ()
    epoch_indices: Sequence[int] = (0,)
    dev_adaptive_scaling_dataset_steps_json: Optional[str] = None


def _clean_batch(batch: Dict) -> Dict[str, np.ndarray]:
    """The arrays of a collated batch (shape, core box and rng states are
    dropped: they are constants or provenance), compacted for the copy as
    the JAX loop compacts them: images and 0/1 masks uint8, dense score
    maps f16. The step up-casts everything to f32 on the card."""
    drop = {"downsampled_shape", "downsampled_core_box", "rng_states"}
    out = {}
    for k, v in batch.items():
        if k in drop:
            continue
        if k in ("image", "downsampled_mask"):
            out[k] = v if v.dtype == np.uint8 else v.astype(np.uint8)
        elif k == "downsampled_score_map":
            out[k] = v.astype(np.float16)
        else:
            out[k] = v
    return out


def _core_boxes_from_pipeline(pipeline: SynthPipelineConfig) -> Tuple[CoreBox, CoreBox]:
    f = pipeline.downsample_factor
    rd, rm = pipeline.rough_crop_size // f, pipeline.rough_core_margin
    pd, pm = pipeline.precise_crop_size // f, pipeline.precise_core_margin
    return CoreBox(rm, rd - 1 - rm, rm, rd - 1 - rm), CoreBox(pm, pd - 1 - pm, pm, pd - 1 - pm)


def _pull_pairs(dataset, iterator, n: int):
    """``n`` pairs from ``iterator``, starting the dataset again when it
    runs out; returns the pairs and the iterator to go on with."""
    pairs = []
    while len(pairs) < n:
        try:
            pairs.append(next(iterator))
        except StopIteration:
            iterator = iter(dataset)
            pairs.append(next(iterator))
    return pairs, iterator


class _DeviceBatches:
    """Copies host batches to the card: pinned memory, ``non_blocking`` on a
    side stream, an event recorded after the copies. ``wait(event, ...)``
    makes the current stream wait for that event and marks the tensors as
    used there. On the CPU the arrays become tensors and nothing waits."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def copy(self, *batches: Dict[str, np.ndarray]):
        if self.stream is None:
            return tuple({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()} for b in batches), None
        out = []
        with torch.cuda.stream(self.stream):
            for b in batches:
                out.append({
                    k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(self.device, non_blocking=True)
                    for k, v in b.items()
                })
            event = torch.cuda.Event()
            event.record(self.stream)
        return tuple(out), event

    def wait(self, event, *batches: Dict[str, torch.Tensor]) -> None:
        if event is None:
            return
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for b in batches:
            for t in b.values():
                t.record_stream(current)


def _new_model(model_config: AdaptiveScalingConfig, seed: int, dtype: torch.dtype) -> AdaptiveScaling:
    """The model at ``dtype`` (f32 parameters) with its parameters drawn
    from ``seed`` as the JAX package's ``model.init`` draws them
    (``init_like_flax_``); the global torch random state is left as it
    was."""
    with torch.random.fork_rng(devices=[]):
        model = AdaptiveScaling(model_config, dtype)
    return init_like_flax_(model, torch.Generator().manual_seed(seed))


def block_launches() -> int:
    """The block kernel's launches so far, f32 and bf16 together (a step
    runs one dtype)."""
    return block_kernel.LAUNCHES + block_kernel.LAUNCHES_BF16


def train(
    dataset_config_json: Optional[str],
    output_folder: str,
    reset_output_folder: bool = False,
    epoch_config_json: Optional[str] = None,
    model_config_json: Optional[str] = None,
    optimizer_config_json: Optional[str] = None,
    rough_loss_config_json: Optional[str] = None,
    precise_loss_config_json: Optional[str] = None,
    restore_state_path: Optional[str] = None,
    restore_epoch_idx: bool = True,
    reset_epoch_idx_to_value: Optional[int] = None,
    init_params_path: Optional[str] = None,
    use_mesh: bool = False,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Train; returns the last epoch's dev metrics (``dev_rough_loss``,
    ``dev_precise_loss``, ``dev_loss``; none in overfit or inspection mode)
    and ``epochs``, one record an epoch: its wall seconds, the seconds the
    loop waited on the prefetcher, each step's ms (CUDA events on the card,
    the host clock on the CPU), the block kernel's launches a step and a dev
    batch, and the checkpoint written (or None). ``use_mesh`` trains
    data-parallel over every rank of the process group (module docstring);
    a group this call makes it also ends."""
    if init_params_path and restore_state_path:
        raise ValueError("init_params_path and restore_state_path are exclusive")
    dev = resolve_device(device)
    owns_group = use_mesh and not torch.distributed.is_initialized()
    try:
        mesh = None
        if use_mesh:
            mesh = create_mesh(device)
            dev = mesh_device(mesh)
        writer = mesh is None or torch.distributed.get_rank() == 0
        if writer:
            if reset_output_folder and os.path.isdir(output_folder):
                shutil.rmtree(output_folder)
            os.makedirs(output_folder, exist_ok=True)
        if mesh is not None:
            torch.distributed.barrier()
        return _train_logged(
            writer, output_folder, dev, mesh, dataset_config_json, epoch_config_json, model_config_json,
            optimizer_config_json, rough_loss_config_json, precise_loss_config_json, restore_state_path,
            restore_epoch_idx, reset_epoch_idx_to_value, init_params_path,
        )
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()


def _train_logged(writer, out_fd, *args) -> Dict[str, Any]:
    """``_train`` with ``log.txt`` in the run folder, written by one rank."""
    if not writer:
        return _train(out_fd, *args, writer=False)
    handler = logging.FileHandler(os.path.join(out_fd, "log.txt"))
    handler.setFormatter(logging.Formatter("%(message)s   [%(asctime)s]"))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        return _train(out_fd, *args)
    finally:
        logger.removeHandler(handler)
        handler.close()


def _train(
    out_fd, dev, mesh, dataset_config_json, epoch_config_json, model_config_json, optimizer_config_json,
    rough_loss_config_json, precise_loss_config_json, restore_state_path, restore_epoch_idx,
    reset_epoch_idx_to_value, init_params_path, writer: bool = True,
) -> Dict[str, Any]:
    dataset_config = load_config(dataset_config_json, DatasetConfig)
    epoch_config = load_config(epoch_config_json, EpochConfig)
    model_config = load_config(model_config_json, AdaptiveScalingConfig)
    optimizer_config = load_config(optimizer_config_json, OptimizerConfig)
    rough_loss_config = load_config(rough_loss_config_json, AdaptiveScalingRoughLossConfig)
    precise_loss_config = load_config(precise_loss_config_json, AdaptiveScalingPreciseLossConfig)
    for name, cfg in [
        ("dataset_config", dataset_config),
        ("epoch_config", epoch_config),
        ("model_config", model_config),
        ("optimizer_config", optimizer_config),
        ("rough_loss_config", rough_loss_config),
        ("precise_loss_config", precise_loss_config),
    ]:
        if writer:
            logger.info("%s: %s", name, config_to_dict(cfg))
            dump_config(cfg, os.path.join(out_fd, f"{name}.json"))
    step_dtype = TrainStepConfig(compute_dtype=epoch_config.compute_dtype).dtype

    # With a mesh each rank makes its own rows of every batch from its own
    # stream (the JAX loop's per-process input).
    train_bs, dev_bs = epoch_config.train_batch_size, epoch_config.dev_batch_size
    seed_of = (lambda s: s) if mesh is None else per_process_seed
    if mesh is not None:
        train_bs, dev_bs = local_batch_size(train_bs), local_batch_size(dev_bs)
    train_num_samples = calculate_iterable_dataset_num_samples(train_bs, epoch_config.train_num_batches)
    dev_num_samples = calculate_iterable_dataset_num_samples(dev_bs, epoch_config.dev_num_batches)
    labels = epoch_config.num_page_char_regression_labels
    cached_runs = max(1, epoch_config.train_num_processes) * 3

    dev_dataset = None
    if not (epoch_config.enable_overfit_testing or epoch_config.enable_multitask_gradiant_inspection):
        dev_dataset = AdaptiveScalingIterableDataset(
            AdaptiveScalingDatasetConfig(
                steps_json=dataset_config.dev_adaptive_scaling_dataset_steps_json,
                num_page_char_regression_labels=labels,
                num_samples=dev_num_samples,
                rng_seed=seed_of(epoch_config.dev_rng_seed),
                num_processes=epoch_config.dev_num_processes,
                is_dev=True,
            )
        )

    epoch_to_steps_json = dict(
        zip(
            dataset_config.epoch_indices,
            dataset_config.train_adaptive_scaling_dataset_steps_jsons
            or [dataset_config.dev_adaptive_scaling_dataset_steps_json] * len(dataset_config.epoch_indices),
        )
    )
    epoch_to_rng_seed = dict(
        zip(
            dataset_config.epoch_indices,
            dataset_config.train_rng_seeds or [epoch_config.train_rng_seed] * len(dataset_config.epoch_indices),
        )
    )

    def build_train_dataset(steps_json, rng_seed):
        if epoch_config.enable_overfit_testing:
            # The dev pipeline with the rng reset every dev_num_samples
            # pairs: the model sees the same small fixed set forever.
            return AdaptiveScalingIterableDataset(
                AdaptiveScalingDatasetConfig(
                    steps_json=dataset_config.dev_adaptive_scaling_dataset_steps_json,
                    num_page_char_regression_labels=labels,
                    num_samples=train_num_samples,
                    num_samples_reset_rng=dev_num_samples,
                    rng_seed=seed_of(epoch_config.dev_rng_seed),
                    num_processes=epoch_config.train_num_processes,
                    num_cached_runs=cached_runs,
                )
            )
        return AdaptiveScalingIterableDataset(
            AdaptiveScalingDatasetConfig(
                steps_json=steps_json,
                num_page_char_regression_labels=labels,
                num_samples=train_num_samples,
                rng_seed=seed_of(rng_seed),
                num_processes=epoch_config.train_num_processes,
                num_cached_runs=cached_runs,
                sample_reuse=epoch_config.train_sample_reuse,
            )
        )

    train_dataset = build_train_dataset(
        epoch_to_steps_json.get(0), epoch_to_rng_seed.get(0, epoch_config.train_rng_seed)
    )
    prefetcher = None
    try:
        model = _new_model(model_config, epoch_config.jax_seed, step_dtype)
        if init_params_path:
            # Params-only continuation: the weights of a .npz, a reference
            # state dict or a checkpoint of the port, with fresh optimizer
            # moments; the schedule goes to reset_epoch_idx_to_value below.
            model.load_state_dict(state_dict_from_jax(load_params(init_params_path, model_config)), strict=True)
        model.to(dev)
        optimizer, schedule = build_optimizer(
            dict(model.named_parameters()), optimizer_config, steps_per_epoch=epoch_config.train_num_batches
        )
        if init_params_path and reset_epoch_idx_to_value:
            set_opt_step(optimizer, reset_epoch_idx_to_value * epoch_config.train_num_batches)
        # Seeded alike on every rank: each draws the global batch's masks.
        generator = torch.Generator(device=dev).manual_seed(epoch_config.jax_seed)

        rough_core, precise_core = _core_boxes_from_pipeline(train_dataset.pipeline)
        step_config = TrainStepConfig(
            rough_loss=rough_loss_config,
            precise_loss=precise_loss_config,
            rough_core_box=rough_core,
            precise_core_box=precise_core,
            remat=epoch_config.remat,
            compute_dtype=epoch_config.compute_dtype,
        )
        train_step = make_train_step(model, optimizer, step_config, device=str(dev), mesh=mesh)
        eval_step = make_eval_step(model, step_config, device=str(dev), mesh=mesh)
        grad_inspect = None
        if epoch_config.enable_multitask_gradiant_inspection:
            grad_inspect = make_grad_inspection_fn(
                model, step_config, per_parameter=epoch_config.multitask_gradiant_inspection_per_parameter,
                device=str(dev), mesh=mesh,
            )
        metrics = Metrics(
            ["train_rough_loss", "train_precise_loss", "dev_rough_loss", "dev_precise_loss"],
            avg_num_batches=epoch_config.avg_num_batches,
        )

        epoch_idx = 0
        if restore_state_path:
            restored = restore_checkpoint(
                restore_state_path,
                model,
                optimizer,
                reset_step=(
                    reset_epoch_idx_to_value * epoch_config.train_num_batches if reset_epoch_idx_to_value else None
                ),
            )
            if restore_epoch_idx:
                epoch_idx = restored["epoch_idx"] + 1
        if reset_epoch_idx_to_value:
            epoch_idx = reset_epoch_idx_to_value
        if mesh is not None:
            replicate(model, mesh)
            replicate([optimizer.mu, optimizer.nu], mesh)

        copier = _DeviceBatches(dev)
        # Seconds of batch production by stage (reset each epoch): pulling
        # pairs (generator starvation), collating, starting the copy.
        phase = {"pull": 0.0, "collate": 0.0, "copy": 0.0, "batches": 0}

        def make_batch_fn(dataset):
            state = {"iter": iter(dataset)}

            def make_batch():
                t0 = time.perf_counter()
                pairs, state["iter"] = _pull_pairs(dataset, state["iter"], train_bs)
                t1 = time.perf_counter()
                batch = collate_samples(pairs)
                rough_b, precise_b = _clean_batch(batch["rough"]), _clean_batch(batch["precise"])
                t2 = time.perf_counter()
                copied = copier.copy(rough_b, precise_b)
                phase["pull"] += t1 - t0
                phase["collate"] += t2 - t1
                phase["copy"] += time.perf_counter() - t2
                phase["batches"] += 1
                return copied

            return make_batch

        def start_prefetcher():
            if epoch_config.prefetch_depth > 0:
                return BatchPrefetcher(make_batch_fn(train_dataset), depth=epoch_config.prefetch_depth)
            return None

        prefetcher = start_prefetcher()
        inline_batch = make_batch_fn(train_dataset) if prefetcher is None else None
        on_card = dev.type == "cuda"
        best = {"dev_loss": float("inf"), "rough": float("inf"), "precise": float("inf")}
        last_metrics: Dict[str, Any] = {}
        epochs: List[Dict[str, Any]] = []
        profiler = None

        while epoch_idx < epoch_config.num_epochs:
            if epoch_idx > 0 and epoch_idx in epoch_to_steps_json:
                logger.info("Curriculum reset at epoch %d", epoch_idx)
                if prefetcher is not None:
                    prefetcher.stop()
                train_dataset.pool.cleanup()
                train_dataset = build_train_dataset(epoch_to_steps_json[epoch_idx], epoch_to_rng_seed[epoch_idx])
                prefetcher = start_prefetcher()
                inline_batch = make_batch_fn(train_dataset) if prefetcher is None else None

            logger.info("Training epoch %d ...", epoch_idx)
            if prefetcher is not None:
                prefetcher.reset_stall_accounting()
            pending: List[Dict[str, torch.Tensor]] = []
            step_times: List[Any] = []
            step_launches: List[int] = []
            epoch_t0 = time.perf_counter()
            for batch_idx in range(1, epoch_config.train_num_batches + 1):
                (rough_b, precise_b), event = prefetcher.get() if prefetcher is not None else inline_batch()
                copier.wait(event, rough_b, precise_b)
                if writer and epoch_config.profile_num_batches > 0 and epoch_idx == 0 and batch_idx == 1:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if on_card:
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                    profiler.start()
                launches0 = block_launches()
                if on_card:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                else:
                    start = time.perf_counter()
                with torch.profiler.record_function("train_step"):
                    step_metrics = train_step(rough_b, precise_b, generator)
                if on_card:
                    end.record()
                    step_times.append((start, end))
                else:
                    step_times.append((time.perf_counter() - start) * 1e3)
                step_launches.append(block_launches() - launches0)
                if profiler is not None and batch_idx == min(
                    epoch_config.profile_num_batches, epoch_config.train_num_batches
                ):
                    if on_card:
                        torch.cuda.synchronize(dev)
                    profiler.stop()
                    trace_dir = os.path.join(out_fd, "profile")
                    os.makedirs(trace_dir, exist_ok=True)
                    profiler.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
                    logger.info("profiler trace -> %s", trace_dir)
                    profiler = None
                if grad_inspect is not None:
                    gi = grad_inspect(rough_b, precise_b)
                    logger.info(
                        "grad inspection: rough |g| mean=%.3e std=%.3e, precise |g| mean=%.3e std=%.3e",
                        gi["rough_abs_grads_mean"], gi["rough_abs_grads_std"],
                        gi["precise_abs_grads_mean"], gi["precise_abs_grads_std"],
                    )
                    for k in sorted(gi):
                        if k.endswith(":rough_abs_mean"):
                            name = k[: -len(":rough_abs_mean")]
                            logger.info(
                                "grad inspection %s: rough=%.3e precise=%.3e", name, gi[k], gi[f"{name}:precise_abs_mean"]
                            )
                # Read the losses at the logging cadence: a read waits for
                # the step to finish.
                pending.append(step_metrics)
                if batch_idx % 4 == 0 or batch_idx >= epoch_config.train_num_batches:
                    for m in pending:
                        rough_avg = metrics.update("train_rough_loss", float(m["rough_loss"]))
                        precise_avg = metrics.update("train_precise_loss", float(m["precise_loss"]))
                    pending.clear()
                    logger.info(
                        "E=%d, B=%d/%d, L_rough=%.5f, L_precise=%.5f, L_sum=%.5f",
                        epoch_idx, batch_idx, epoch_config.train_num_batches,
                        rough_avg, precise_avg, rough_avg + precise_avg,
                    )

            epoch_wall = time.perf_counter() - epoch_t0
            step_ms = [s.elapsed_time(e) for s, e in step_times] if on_card else step_times
            record: Dict[str, Any] = {
                "epoch": epoch_idx,
                "wall_s": epoch_wall,
                "step_ms": step_ms,
                "step_launches": step_launches,
                "train_rough_loss": metrics.mean("train_rough_loss"),
                "train_precise_loss": metrics.mean("train_precise_loss"),
                "data_stall_s": None,
            }
            if prefetcher is not None:
                # The share of the epoch the loop waited on batches: ~0 means
                # the host pipeline keeps the card fed.
                record["data_stall_s"] = prefetcher.stall_seconds
                logger.info(
                    "E=%d, epoch_wall=%.1fs, data_stall=%.1f%% (%.1fs), "
                    "prefetch pull=%.1fs collate=%.1fs copy=%.1fs over %d batches",
                    epoch_idx, epoch_wall, 100.0 * prefetcher.stall_seconds / max(epoch_wall, 1e-9),
                    prefetcher.stall_seconds, phase["pull"], phase["collate"], phase["copy"], phase["batches"],
                )
            phase.update(pull=0.0, collate=0.0, copy=0.0, batches=0)

            dev_loss = None
            record["dev_launches"] = []
            if dev_dataset is not None:
                metrics.reset(["dev_rough_loss", "dev_precise_loss"])
                dev_rough_losses: List[float] = []
                dev_precise_losses: List[float] = []
                dev_iter = iter(dev_dataset)
                for _ in range(epoch_config.dev_num_batches):
                    pairs, dev_iter = _pull_pairs(dev_dataset, dev_iter, dev_bs)
                    batch = collate_samples(pairs)
                    launches0 = block_launches()
                    em = eval_step(_clean_batch(batch["rough"]), _clean_batch(batch["precise"]))
                    dev_rough_losses.append(float(em["rough_loss"]))
                    dev_precise_losses.append(float(em["precise_loss"]))
                    record["dev_launches"].append(block_launches() - launches0)
                dev_rough = statistics.mean(dev_rough_losses)
                dev_precise = statistics.mean(dev_precise_losses)
                dev_loss = dev_rough + dev_precise
                logger.info(
                    "E=%d, dev_rough_loss=%s, dev_precise_loss=%s, dev_loss=%s",
                    epoch_idx, dev_rough, dev_precise, dev_loss,
                )
                best["rough"] = min(best["rough"], dev_rough)
                best["precise"] = min(best["precise"], dev_precise)
                last_metrics = {"dev_rough_loss": dev_rough, "dev_precise_loss": dev_precise, "dev_loss": dev_loss}

            is_best = dev_loss is not None and dev_loss < best["dev_loss"]
            record["checkpoint"] = None
            if is_best or (epoch_idx + 1) in epoch_to_steps_json or epoch_idx + 1 == epoch_config.num_epochs:
                if is_best:
                    best["dev_loss"] = dev_loss
                if writer:
                    record["checkpoint"] = save_checkpoint(out_fd, model, optimizer, epoch_idx, best=is_best)
                if mesh is not None:
                    # The other ranks wait for rank 0's file and take its name.
                    shared = [record["checkpoint"]]
                    torch.distributed.broadcast_object_list(shared, src=0)
                    record["checkpoint"] = shared[0]
                logger.info("E=%d, checkpoint -> %s", epoch_idx, record["checkpoint"])
            record["lr_next_step"] = schedule(optimizer.count)
            epochs.append(record)
            epoch_idx += 1
        return {**last_metrics, "epochs": epochs}
    finally:
        if prefetcher is not None:
            prefetcher.stop()
        train_dataset.pool.cleanup()


def export_inference_artifact(
    checkpoint_path: str, output_folder: str, model_config_json: Optional[str] = None
) -> str:
    """Checkpoint -> a deployable artifact: ``params.npz`` (the flat
    ``"a/b/c"`` f32 tree of the JAX package's layout, what
    ``utils/params.py::load_params`` and ``detect --checkpoint`` read) and
    ``model_config.json``. Returns ``output_folder``."""
    from ..tools.export_params import flatten_params
    from ..utils.params import jax_from_state_dict

    model_config = load_config(model_config_json, AdaptiveScalingConfig)
    restored = restore_pytree_numpy(checkpoint_path)
    params = {k: torch.from_numpy(v) for k, v in restored["params"].items()}
    with torch.device("meta"):
        expected = set(AdaptiveScaling(model_config).state_dict())
    if set(params) != expected:
        raise ValueError(
            f"{checkpoint_path}: the checkpoint's parameters do not fit the model config "
            f"({len(set(params) ^ expected)} names differ)"
        )
    os.makedirs(output_folder, exist_ok=True)
    flat = {k: np.asarray(v, np.float32) for k, v in flatten_params(jax_from_state_dict(params)).items()}
    np.savez(os.path.join(output_folder, "params.npz"), **flat)
    with open(os.path.join(output_folder, "model_config.json"), "w") as fout:
        json.dump(config_to_dict(model_config), fout, indent=2)
    return output_folder
