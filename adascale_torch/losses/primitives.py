"""Primitive loss functions on tensors of static shape.

Counterpart of ``adascale/losses/primitives.py``, term for term, so that
values and gradients agree with the JAX package's. Every masked loss takes
the masked mean ``sum(loss * mask) / (sum(mask) + eps)``.

The OHEM top-k of ``weighted_bce_with_logits_loss`` has a data-dependent k;
as in the JAX package it is a full descending sort and a rank mask, so no
value leaves the device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _masked_mean(loss: torch.Tensor, mask: Optional[torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    if mask is None:
        return loss.mean()
    return (loss * mask).sum() / (mask.sum() + eps)


def bce_with_logits(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy with logits (numerically stable).
    ``torch.maximum`` splits the gradient at a tie as ``jnp.maximum`` does;
    ``clamp`` would pass it whole."""
    return torch.maximum(pred, pred.new_zeros(())) - pred * gt + torch.log1p(torch.exp(-pred.abs()))


def weighted_bce_with_logits_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    negative_ratio: float = 3.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """OHEM-weighted BCE: all positives and the ``round(3 * #pos)`` hardest
    negatives."""
    positive_mask = gt
    negative_mask = 1.0 - gt
    if mask is not None:
        positive_mask = positive_mask * mask
        negative_mask = negative_mask * mask
    positive_mask = (positive_mask > 0).to(pred.dtype)
    negative_mask = (negative_mask > 0).to(pred.dtype)

    positive_count = positive_mask.sum()
    negative_count = torch.minimum(
        torch.round(positive_count * negative_ratio), negative_mask.sum()
    )

    loss = bce_with_logits(pred, gt)
    positive_loss_sum = (loss * positive_mask).sum()
    # Data-dependent k: sort descending and keep the ranks below k.
    sorted_neg = torch.sort((loss * negative_mask).reshape(-1), descending=True).values
    ranks = torch.arange(sorted_neg.shape[0], dtype=torch.float32, device=pred.device)
    negative_loss_sum = torch.where(ranks < negative_count, sorted_neg, 0.0).sum()
    return (positive_loss_sum + negative_loss_sum) / (positive_count + negative_count + eps)


def focal_with_logits_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    alpha: float = 0.25,
    gamma: float = 2.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Sigmoid focal loss (torchvision's formula)."""
    p = torch.sigmoid(pred)
    ce = bce_with_logits(pred, gt)
    p_t = p * gt + (1.0 - p) * (1.0 - gt)
    loss = ce * (1.0 - p_t) ** gamma
    alpha_t = alpha * gt + (1.0 - alpha) * (1.0 - gt)
    return _masked_mean(alpha_t * loss, mask, eps)


def dice_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``1 - 2 * intersection / union``; ``pred`` holds probabilities."""
    if mask is not None:
        pred = pred * mask
        gt = gt * mask
    intersection = (pred * gt).sum()
    union = pred.sum() + gt.sum() + eps
    return 1.0 - 2.0 * intersection / union


def l1_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    smooth: bool = False,
    smooth_beta: float = 1.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """L1, or smooth L1 with ``smooth_beta``."""
    diff = (pred - gt).abs()
    if smooth:
        loss = torch.where(diff < smooth_beta, 0.5 * diff * diff / smooth_beta, diff - 0.5 * smooth_beta)
    else:
        loss = diff
    return _masked_mean(loss, mask, eps)


def l2_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Mean squared error."""
    return _masked_mean((pred - gt) ** 2, mask, eps)


def wahr_loss(pred: torch.Tensor, gt: torch.Tensor, gamma: float = 0.01) -> torch.Tensor:
    """Weight-adaptive heatmap regression (arXiv:2012.15175); ``pred`` holds
    probabilities."""
    soft = gt**gamma
    weight = soft * (1.0 - pred) + (1.0 - soft) * pred
    return (weight * (pred - gt) ** 2).mean()


def cross_entropy_with_logits_loss(
    pred: torch.Tensor, gt: torch.Tensor, class_axis: int = 1
) -> torch.Tensor:
    """Soft-target cross entropy: the mean over the other axes of
    ``-(gt * log_softmax(pred)).sum(class_axis)``."""
    logp = F.log_softmax(pred, dim=class_axis)
    return (-(gt * logp).sum(class_axis)).mean()
