"""The two-task train step and the eval step.

Counterpart of ``adascale/training/train_step.py``. One backward of
``rough_loss / 2 + precise_loss / 2`` accumulates both tasks' gradients
before one clipped AdamW step (``optimizer.ClippedAdamW``). Batches may come
compact (uint8 images and masks); they are moved as they are and up-cast to
f32 on the device, the label-point indices staying integers. The losses and
the parameters are f32. ``compute_dtype="bfloat16"`` (the flagships' own
setting) runs the model at bf16 as the JAX package's bf16 training does:
the Flax module path (f32 residual stream, every block through the bf16
kernel's module mode with a recompute backward, ``TrainableBlockBF16``),
the heads' outputs cast to f32 before the losses; the step expects a model
built at that dtype (``AdaptiveScaling(config, torch.bfloat16)``).

With ``remat`` each pass's forward runs under ``torch.utils.checkpoint``:
its activations are recomputed in the backward instead of kept, so the block
kernel runs twice a pass. Stochastic depth draws its masks for both passes
before either forward, so a recompute sees the same masks.

With a ``mesh`` (``parallel.create_mesh``) each rank holds its rows of the
global batch, and the step computes the global batch's loss and its
gradient, as the JAX package's SPMD step does. The reference losses are not
means of per-sample terms (masked means over the whole batch, a ratio of
whole-batch sums, OHEM over the whole batch's negatives), so the mean of
per-rank losses would be another loss. Each rank gathers the heads' outputs
(``parallel.gather_rows``, differentiable) and the labels over the mesh and
computes the unchanged losses on the global tensors; the backward leaves on
each rank its rows' share of the global gradient, which
``parallel.reduce_gradients`` sums before ``optimizer.step()``, so the clip
takes the global norm of the global gradient. Every rank draws the drop-path
masks of the global batch from its generator (seeded alike on every rank)
and keeps its own rows. At world size 1 the step is the mesh-less one bit for
bit.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; they raise when no card is there.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..losses import (
    AdaptiveScalingPreciseLossConfig,
    AdaptiveScalingRoughLossConfig,
    CoreBox,
    precise_loss,
    rough_loss,
)
from ..parallel.mesh import gather_batch, gather_rows, mesh_rank, mesh_size, reduce_gradients
from ..utils.precision import pin_full_f32


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """Loss configuration; the core boxes are per-dataset constants."""

    rough_loss: AdaptiveScalingRoughLossConfig = AdaptiveScalingRoughLossConfig()
    precise_loss: AdaptiveScalingPreciseLossConfig = AdaptiveScalingPreciseLossConfig()
    rough_core_box: CoreBox = CoreBox(0, 0, 0, 0)
    precise_core_box: CoreBox = CoreBox(0, 0, 0, 0)
    # Recompute each pass's forward in the backward instead of keeping its
    # activations.
    remat: bool = False
    # "float32" or "bfloat16": the model's dtype (parameters stay f32).
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r}: one of {sorted(COMPUTE_DTYPES)}"
            )

    @property
    def dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.compute_dtype]


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_model_dtype(model, config: TrainStepConfig) -> None:
    """Raises unless ``model`` computes at ``config.compute_dtype``."""
    if model.dtype != config.dtype:
        raise ValueError(
            f"the model computes in {model.dtype}, the step config asks {config.compute_dtype!r}: "
            f"build it as AdaptiveScaling(config, {config.dtype})"
        )


def resolve_device(device: str) -> torch.device:
    """The device to train on; raises for a card that is not there. On the
    card, TF32 is turned off for cuDNN and cuBLAS (``pin_full_f32``), as the
    engine does: the reference computes in full f32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain versions on the CPU"
            )
        pin_full_f32()
    return dev


def upcast_batch(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch's arrays onto ``device`` as they are, then to f32 there,
    except the integer label-point indices."""
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value).to(device)
        integer = not (t.is_floating_point() or t.dtype == torch.bool)
        if not (integer and key.startswith("downsampled_label_point")):
            t = t.float()
        out[key] = t
    return out


def _run(fwd, image, remat: bool):
    return checkpoint(fwd, image, use_reentrant=False) if remat else fwd(image)


def _global(outputs, batch, mesh):
    """The outputs and labels of the global batch: gathered over ``mesh``
    (the outputs with a gradient), or as they are without one."""
    if mesh is None:
        return outputs, batch
    return tuple(gather_rows(t, mesh) for t in outputs), gather_batch(batch, mesh)


def rough_task_loss(
    model, batch: Mapping[str, torch.Tensor], config: TrainStepConfig, deterministic: bool, drop_masks=None,
    mesh=None,
) -> torch.Tensor:
    """``rough_loss / 2`` of the rough pass on an up-cast batch (with a
    ``mesh``, this rank's rows; the loss is the global batch's)."""

    def fwd(image):
        return model.forward_rough(image, deterministic, drop_masks=drop_masks)

    outputs = tuple(t.float() for t in _run(fwd, batch["image"], config.remat))
    (mask_feat, height_feat), batch = _global(outputs, batch, mesh)
    return rough_loss(
        mask_feat,
        height_feat,
        batch["downsampled_mask"],
        batch["downsampled_score_map"],
        config.rough_core_box,
        config.rough_loss,
    ) / 2.0


def precise_task_loss(
    model, batch: Mapping[str, torch.Tensor], config: TrainStepConfig, deterministic: bool, drop_masks=None,
    mesh=None,
) -> torch.Tensor:
    """``precise_loss / 2`` of the precise pass on an up-cast batch (with
    the char-mask head's term where the model has that head; with a
    ``mesh``, this rank's rows and the global batch's loss)."""
    mask_head = model.config.precise_enable_char_mask_head
    forward = model.forward_precise_with_mask if mask_head else model.forward_precise

    def fwd(image):
        return forward(image, deterministic, drop_masks=drop_masks)

    out, batch = _global(tuple(t.float() for t in _run(fwd, batch["image"], config.remat)), batch, mesh)
    prob, offset, angle, distance = out[-4:]
    return precise_loss(
        prob,
        offset,
        angle,
        distance,
        batch["downsampled_score_map"],
        batch["downsampled_mask"],
        config.precise_core_box,
        batch["downsampled_label_point_y"],
        batch["downsampled_label_point_x"],
        batch["up_left_offsets"],
        batch["corner_angles"],
        batch["corner_distances"],
        config.precise_loss,
        precise_char_mask_feature=out[0] if mask_head else None,
    ) / 2.0


def two_task_loss(
    model,
    rough_batch: Mapping[str, torch.Tensor],
    precise_batch: Mapping[str, torch.Tensor],
    config: TrainStepConfig,
    deterministic: bool,
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``(r + p, (r, p))`` with ``r = rough_loss / 2`` and ``p =
    precise_loss / 2`` on up-cast batches. With ``deterministic=False`` the
    drop-path masks of the rough and then the precise pass are drawn from
    ``generator`` before either forward. With a ``mesh`` the batches are this
    rank's rows, the masks are drawn for the global batch (this rank keeps
    its rows) and the losses are the global batch's."""
    rough_masks = precise_masks = None
    if not deterministic:
        if generator is None:
            raise ValueError("deterministic=False needs a generator")
        rough_masks = _drop_masks(model, rough_batch["image"].shape[0], generator, mesh)
        precise_masks = _drop_masks(model, precise_batch["image"].shape[0], generator, mesh)
    r_loss = rough_task_loss(model, rough_batch, config, deterministic, rough_masks, mesh)
    p_loss = precise_task_loss(model, precise_batch, config, deterministic, precise_masks, mesh)
    return r_loss + p_loss, (r_loss, p_loss)


def _drop_masks(model, rows: int, generator: torch.Generator, mesh):
    """The drop-path masks of ``rows`` samples; with a mesh, this rank's rows
    of the global batch's masks."""
    if mesh is None:
        return model.backbone.draw_drop_masks(rows, generator)
    r = mesh_rank(mesh)
    masks = model.backbone.draw_drop_masks(rows * mesh_size(mesh), generator)
    return [None if m is None else m[r * rows : (r + 1) * rows] for m in masks]


def make_train_step(
    model, optimizer, config: TrainStepConfig, device: str = "cuda", mesh=None
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(rough_batch, precise_batch, generator) -> metrics``: the
    two-task loss with stochastic depth drawn from ``generator``, one
    backward, then ``optimizer.step()`` (clip and AdamW, in place). The
    metrics (``rough_loss``, ``precise_loss``, ``grad_norm``, the global norm
    before clipping) stay on the device. With a ``mesh`` the batches are this
    rank's rows, and the losses, the gradient and its norm are the global
    batch's (module docstring); the parameters stay equal on every rank."""
    dev = resolve_device(device)
    check_model_dtype(model, config)
    params = list(optimizer.params.values())

    def step(rough_batch, precise_batch, generator: torch.Generator):
        optimizer.zero_grad()
        total, (r_loss, p_loss) = two_task_loss(
            model,
            upcast_batch(rough_batch, dev),
            upcast_batch(precise_batch, dev),
            config,
            False,
            generator,
            mesh,
        )
        total.backward()
        if mesh is not None:
            with torch.profiler.record_function("reduce_gradients"):
                reduce_gradients([p.grad for p in params], mesh)
        with torch.profiler.record_function("optimizer.step"):
            grad_norm = optimizer.step()
        return {"rough_loss": r_loss.detach(), "precise_loss": p_loss.detach(), "grad_norm": grad_norm}

    return step


def make_eval_step(
    model, config: TrainStepConfig, device: str = "cuda", mesh=None
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(rough_batch, precise_batch) -> {"rough_loss", "precise_loss"}``,
    deterministic, without a gradient (each loss divided by 2, as in
    training). With a ``mesh`` the batches are this rank's rows and the
    losses the global batch's, the same on every rank."""
    dev = resolve_device(device)
    check_model_dtype(model, config)

    @torch.no_grad()
    def step(rough_batch, precise_batch):
        _, (r_loss, p_loss) = two_task_loss(
            model, upcast_batch(rough_batch, dev), upcast_batch(precise_batch, dev), config, True, mesh=mesh
        )
        return {"rough_loss": r_loss, "precise_loss": p_loss}

    return step


def make_grad_inspection_fn(
    model, config: TrainStepConfig, per_parameter: bool = False, device: str = "cuda", mesh=None
) -> Callable[..., Dict[str, float]]:
    """Multitask gradient inspection (counterpart of the JAX package's
    ``make_grad_inspection_fn``): ``inspect(rough_batch, precise_batch)``
    takes each task's gradient alone (deterministic, each loss divided by 2)
    over the parameters both tasks share, the backbone, and returns the mean
    and standard deviation of their magnitudes (``rough_abs_grads_mean``,
    ``..._std``, ``precise_...``). ``per_parameter`` adds each shared
    parameter's ``"<name>:rough_abs_mean"`` and ``"<name>:precise_abs_mean"``.
    Leaves ``.grad`` untouched. With a ``mesh`` the gradients are the global
    batch's."""
    dev = resolve_device(device)
    check_model_dtype(model, config)
    shared = [(n, p) for n, p in model.named_parameters() if n.startswith("backbone.")]
    names, params = [n for n, _ in shared], [p for _, p in shared]

    def task_grads(loss: torch.Tensor):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if mesh is not None:
            reduce_gradients(grads, mesh)
        return grads

    def inspect(rough_batch, precise_batch) -> Dict[str, float]:
        rough = task_grads(rough_task_loss(model, upcast_batch(rough_batch, dev), config, True, mesh=mesh))
        precise = task_grads(precise_task_loss(model, upcast_batch(precise_batch, dev), config, True, mesh=mesh))
        out = {}
        for task, grads in (("rough", rough), ("precise", precise)):
            flat = torch.cat([g.abs().reshape(-1) for g in grads])
            out[f"{task}_abs_grads_mean"] = float(flat.mean())
            out[f"{task}_abs_grads_std"] = float(flat.std(unbiased=False))
        if per_parameter:
            for name, gr, gp in zip(names, rough, precise):
                out[f"{name}:rough_abs_mean"] = float(gr.abs().mean())
                out[f"{name}:precise_abs_mean"] = float(gp.abs().mean())
        return out

    return inspect


def seeded_batches(
    seed: int,
    batch_size: int,
    rough_size: int = 512,
    precise_size: int = 320,
    num_points: int = 200,
    rough_core_margin: int = 16,
    precise_core_margin: int = 8,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], CoreBox, CoreBox]:
    """A rough and a precise batch of random data from numpy's ``seed``, in
    the training pipeline's layout and types (uint8 images and 0/1 masks,
    f32 score maps and targets, int32 label points on the uncropped
    downsampled map, at half the crop size; masks and score maps cropped to
    the core box), and the two core boxes. The defaults are the tiny/FPN
    flagship's training shapes."""
    rng = np.random.default_rng(seed)
    b, p = batch_size, num_points

    def box(size, margin):
        d = size // 2
        return CoreBox(margin, d - 1 - margin, margin, d - 1 - margin)

    rough_box, precise_box = box(rough_size, rough_core_margin), box(precise_size, precise_core_margin)
    rh, ph = rough_box.height, precise_box.height
    pd = precise_size // 2
    rough = {
        "image": rng.integers(0, 256, (b, rough_size, rough_size, 3), dtype=np.uint8),
        "downsampled_mask": (rng.uniform(size=(b, rh, rh)) > 0.5).astype(np.uint8),
        "downsampled_score_map": rng.uniform(0, 10, (b, rh, rh)).astype(np.float32),
    }
    precise = {
        "image": rng.integers(0, 256, (b, precise_size, precise_size, 3), dtype=np.uint8),
        "downsampled_mask": (rng.uniform(size=(b, ph, ph)) > 0.5).astype(np.uint8),
        "downsampled_score_map": rng.uniform(0, 1, (b, ph, ph)).astype(np.float32),
        "downsampled_label_point_y": rng.integers(0, pd, (b, p)).astype(np.int32),
        "downsampled_label_point_x": rng.integers(0, pd, (b, p)).astype(np.int32),
        "up_left_offsets": rng.uniform(-4, 4, (b, p, 2)).astype(np.float32),
        "corner_angles": rng.dirichlet(np.ones(4), size=(b, p)).astype(np.float32),
        "corner_distances": rng.uniform(0, 10, (b, p, 3)).astype(np.float32),
    }
    return rough, precise, rough_box, precise_box


def batch_checksum(*batches: Mapping[str, np.ndarray]) -> str:
    """sha256 over each batch's arrays (key, dtype, shape, bytes, in key
    order): two runs compare only the same data."""
    h = hashlib.sha256()
    for batch in batches:
        for key in sorted(batch):
            a = np.ascontiguousarray(batch[key])
            h.update(f"{key}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()
