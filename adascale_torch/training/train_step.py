"""The two-task train step and the eval step.

Counterpart of ``adascale/training/train_step.py``. One backward of
``rough_loss / 2 + precise_loss / 2`` accumulates both tasks' gradients
before one clipped AdamW step (``optimizer.ClippedAdamW``). Batches may come
compact (uint8 images and masks); they are moved as they are and up-cast to
f32 on the device, the label-point indices staying integers. The losses are
f32, and so is the model: ``compute_dtype`` other than "float32" is refused
until the kernels have bf16 variants.

With ``remat`` each pass's forward runs under ``torch.utils.checkpoint``:
its activations are recomputed in the backward instead of kept, so the block
kernel runs twice a pass. Stochastic depth draws its masks for both passes
before either forward, so a recompute sees the same masks.

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
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r}: only 'float32' is ported"
            )


def resolve_device(device: str) -> torch.device:
    """The device to train on; raises for a card that is not there. On the
    card, TF32 is turned off for cuDNN and cuBLAS, as the engine does: the
    reference computes in full f32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain versions on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
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


def two_task_loss(
    model,
    rough_batch: Mapping[str, torch.Tensor],
    precise_batch: Mapping[str, torch.Tensor],
    config: TrainStepConfig,
    deterministic: bool,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``(r + p, (r, p))`` with ``r = rough_loss / 2`` and ``p =
    precise_loss / 2`` on up-cast batches. With ``deterministic=False`` the
    drop-path masks of the rough and then the precise pass are drawn from
    ``generator`` before either forward."""
    rough_masks = precise_masks = None
    if not deterministic:
        if generator is None:
            raise ValueError("deterministic=False needs a generator")
        rough_masks = model.backbone.draw_drop_masks(rough_batch["image"].shape[0], generator)
        precise_masks = model.backbone.draw_drop_masks(precise_batch["image"].shape[0], generator)

    def rough_fwd(image):
        return model.forward_rough(image, deterministic, drop_masks=rough_masks)

    mask_head = model.config.precise_enable_char_mask_head
    precise_forward = model.forward_precise_with_mask if mask_head else model.forward_precise

    def precise_fwd(image):
        return precise_forward(image, deterministic, drop_masks=precise_masks)

    def run(fwd, image):
        if config.remat:
            return checkpoint(fwd, image, use_reentrant=False)
        return fwd(image)

    mask_feat, height_feat = (t.float() for t in run(rough_fwd, rough_batch["image"]))
    r_loss = rough_loss(
        mask_feat,
        height_feat,
        rough_batch["downsampled_mask"],
        rough_batch["downsampled_score_map"],
        config.rough_core_box,
        config.rough_loss,
    ) / 2.0

    precise_out = tuple(t.float() for t in run(precise_fwd, precise_batch["image"]))
    precise_mask_logits = precise_out[0] if mask_head else None
    prob, offset, angle, distance = precise_out[-4:]
    p_loss = precise_loss(
        prob,
        offset,
        angle,
        distance,
        precise_batch["downsampled_score_map"],
        precise_batch["downsampled_mask"],
        config.precise_core_box,
        precise_batch["downsampled_label_point_y"],
        precise_batch["downsampled_label_point_x"],
        precise_batch["up_left_offsets"],
        precise_batch["corner_angles"],
        precise_batch["corner_distances"],
        config.precise_loss,
        precise_char_mask_feature=precise_mask_logits,
    ) / 2.0
    return r_loss + p_loss, (r_loss, p_loss)


def make_train_step(
    model, optimizer, config: TrainStepConfig, device: str = "cuda"
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(rough_batch, precise_batch, generator) -> metrics``: the
    two-task loss with stochastic depth drawn from ``generator``, one
    backward, then ``optimizer.step()`` (clip and AdamW, in place). The
    metrics (``rough_loss``, ``precise_loss``, ``grad_norm``, the global norm
    before clipping) stay on the device."""
    dev = resolve_device(device)

    def step(rough_batch, precise_batch, generator: torch.Generator):
        optimizer.zero_grad()
        total, (r_loss, p_loss) = two_task_loss(
            model,
            upcast_batch(rough_batch, dev),
            upcast_batch(precise_batch, dev),
            config,
            False,
            generator,
        )
        total.backward()
        with torch.profiler.record_function("optimizer.step"):
            grad_norm = optimizer.step()
        return {"rough_loss": r_loss.detach(), "precise_loss": p_loss.detach(), "grad_norm": grad_norm}

    return step


def make_eval_step(
    model, config: TrainStepConfig, device: str = "cuda"
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(rough_batch, precise_batch) -> {"rough_loss", "precise_loss"}``,
    deterministic, without a gradient (each loss divided by 2, as in
    training)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(rough_batch, precise_batch):
        _, (r_loss, p_loss) = two_task_loss(
            model, upcast_batch(rough_batch, dev), upcast_batch(precise_batch, dev), config, True
        )
        return {"rough_loss": r_loss, "precise_loss": p_loss}

    return step


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
