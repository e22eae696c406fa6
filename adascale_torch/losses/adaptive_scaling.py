"""The rough and precise composite losses of adaptive-scaling training.

Counterpart of ``adascale/losses/adaptive_scaling.py``. Predictions are NHWC;
the dense heatmap terms squeeze the channel axis and crop the static core
box, and the sparse geometry terms gather P label points from the uncropped
features.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .primitives import (
    cross_entropy_with_logits_loss,
    dice_loss,
    focal_with_logits_loss,
    l1_loss,
    l2_loss,
    wahr_loss,
    weighted_bce_with_logits_loss,
)


class CoreBox(NamedTuple):
    """Inclusive box: rows ``up..down`` and columns ``left..right``."""

    up: int
    down: int
    left: int
    right: int

    @property
    def height(self) -> int:
        return self.down + 1 - self.up

    @property
    def width(self) -> int:
        return self.right + 1 - self.left


@dataclasses.dataclass(frozen=True)
class AdaptiveScalingRoughLossConfig:
    bce_negative_ratio: float = 3.0
    bce_factor: float = 0.0
    focal_factor: float = 5.0
    dice_factor: float = 1.0
    l1_factor: float = 1.0
    downsampled_score_map_min: float = 1.1
    char_height_feature_min: float = 1.1


@dataclasses.dataclass(frozen=True)
class AdaptiveScalingPreciseLossConfig:
    char_mask_focal_factor: float = 0.0
    char_prob_l1_factor: float = 0.0
    char_prob_pos_l2_factor: float = 2.0
    char_prob_neg_l2_factor: float = 1.0
    char_prob_wahr_factor: float = 0.0
    char_up_left_offset_l1_factor: float = 1.0
    char_up_left_distance_regulation_l1_factor: float = 1.0
    char_corner_angle_cross_entropy_factor: float = 5.0
    char_corner_distance_l1_factor: float = 1.0
    loss_factor: float = 0.15


def _crop_core(x: torch.Tensor, core_box: CoreBox) -> torch.Tensor:
    """Static crop of (B, H, W) to the inclusive core box."""
    return x[:, core_box.up : core_box.down + 1, core_box.left : core_box.right + 1]


def get_label_point_feature(
    feature: torch.Tensor, label_point_y: torch.Tensor, label_point_x: torch.Tensor
) -> torch.Tensor:
    """(B, H, W, C) gathered at (B, P) integer points -> (B, P, C). The
    gradient of a point that repeats accumulates (advanced indexing)."""
    batch_idx = torch.arange(feature.shape[0], device=feature.device)[:, None]
    return feature[batch_idx, label_point_y.long(), label_point_x.long()]


def rough_loss(
    rough_char_mask_feature: torch.Tensor,  # (B, H, W, 1) logits
    rough_char_height_feature: torch.Tensor,  # (B, H, W, 1) softplus output
    downsampled_mask: torch.Tensor,  # (B, CH, CW)
    downsampled_score_map: torch.Tensor,  # (B, CH, CW)
    core_box: CoreBox,
    config: AdaptiveScalingRoughLossConfig = AdaptiveScalingRoughLossConfig(),
) -> torch.Tensor:
    mask_logits = _crop_core(rough_char_mask_feature.squeeze(-1), core_box)
    height = _crop_core(rough_char_height_feature.squeeze(-1), core_box)

    loss = mask_logits.new_zeros((), dtype=torch.float32)
    if config.bce_factor > 0.0:
        loss = loss + config.bce_factor * weighted_bce_with_logits_loss(
            mask_logits, downsampled_mask, negative_ratio=config.bce_negative_ratio
        )
    if config.focal_factor > 0.0:
        loss = loss + config.focal_factor * focal_with_logits_loss(mask_logits, downsampled_mask)
    if config.dice_factor > 0.0:
        loss = loss + config.dice_factor * dice_loss(torch.sigmoid(mask_logits), downsampled_mask)
    if config.l1_factor > 0.0:
        # Both the prediction and the target above their floors, inside the
        # char mask; smooth L1 in log space (a relative scale error).
        l1_mask = (
            (height > config.char_height_feature_min)
            & (downsampled_score_map > config.downsampled_score_map_min)
            & (downsampled_mask > 0)
        ).to(torch.float32)
        # torch.maximum splits the gradient at a tie as jnp.clip does.
        height_c = torch.maximum(height, height.new_tensor(config.char_height_feature_min))
        score_c = torch.clamp(downsampled_score_map, min=config.downsampled_score_map_min)
        loss = loss + config.l1_factor * l1_loss(
            torch.log(height_c), torch.log(score_c), mask=l1_mask, smooth=True
        )
    return loss


def precise_loss(
    precise_char_prob_feature: torch.Tensor,  # (B, H, W, 1) logits
    precise_char_up_left_corner_offset_feature: torch.Tensor,  # (B, H, W, 2)
    precise_char_corner_angle_feature: torch.Tensor,  # (B, H, W, 4) logits
    precise_char_corner_distance_feature: torch.Tensor,  # (B, H, W, 4) softplus output
    downsampled_char_prob_score_map: torch.Tensor,  # (B, CH, CW)
    downsampled_char_mask: torch.Tensor,  # (B, CH, CW)
    core_box: CoreBox,
    downsampled_label_point_y: torch.Tensor,  # (B, P)
    downsampled_label_point_x: torch.Tensor,  # (B, P)
    char_up_left_offsets: torch.Tensor,  # (B, P, 2)
    char_corner_angles: torch.Tensor,  # (B, P, 4)
    char_corner_distances: torch.Tensor,  # (B, P, 3)
    config: AdaptiveScalingPreciseLossConfig = AdaptiveScalingPreciseLossConfig(),
    precise_char_mask_feature: Optional[torch.Tensor] = None,  # (B, H, W, 1) logits
) -> torch.Tensor:
    prob_logits = _crop_core(precise_char_prob_feature.squeeze(-1), core_box)
    ys, xs = downsampled_label_point_y, downsampled_label_point_x
    offset_pts = get_label_point_feature(precise_char_up_left_corner_offset_feature, ys, xs)
    angle_pts = get_label_point_feature(precise_char_corner_angle_feature, ys, xs)
    distance_pts = get_label_point_feature(precise_char_corner_distance_feature, ys, xs)

    loss = prob_logits.new_zeros((), dtype=torch.float32)
    if config.char_mask_focal_factor > 0.0:
        if precise_char_mask_feature is None:
            raise ValueError("char_mask_focal_factor > 0 needs precise_char_mask_feature")
        mask_logits = _crop_core(precise_char_mask_feature.squeeze(-1), core_box)
        loss = loss + config.char_mask_focal_factor * focal_with_logits_loss(
            mask_logits, downsampled_char_mask
        )
    prob = torch.sigmoid(prob_logits)
    score, mask = downsampled_char_prob_score_map, downsampled_char_mask
    if config.char_prob_l1_factor > 0.0:
        loss = loss + config.char_prob_l1_factor * l1_loss(
            prob, score, mask=mask, smooth=True, smooth_beta=0.25
        )
    if config.char_prob_pos_l2_factor > 0.0:
        loss = loss + config.char_prob_pos_l2_factor * l2_loss(prob, score, mask=mask)
    if config.char_prob_neg_l2_factor > 0.0:
        loss = loss + config.char_prob_neg_l2_factor * l2_loss(prob, score, mask=1.0 - mask)
    if config.char_prob_wahr_factor > 0.0:
        loss = loss + config.char_prob_wahr_factor * wahr_loss(prob, score)
    if config.char_up_left_offset_l1_factor > 0.0:
        loss = loss + config.char_up_left_offset_l1_factor * l1_loss(
            offset_pts, char_up_left_offsets, smooth=True, smooth_beta=2.5
        )
    if config.char_up_left_distance_regulation_l1_factor > 0.0:
        # The predicted offset's length should agree with the predicted
        # up-left corner distance.
        loss = loss + config.char_up_left_distance_regulation_l1_factor * l1_loss(
            torch.linalg.vector_norm(offset_pts, dim=2), distance_pts[:, :, 0],
            smooth=True, smooth_beta=2.5,
        )
    if config.char_corner_angle_cross_entropy_factor > 0.0:
        loss = loss + config.char_corner_angle_cross_entropy_factor * cross_entropy_with_logits_loss(
            angle_pts, char_corner_angles, class_axis=2
        )
    if config.char_corner_distance_l1_factor > 0.0:
        loss = loss + config.char_corner_distance_l1_factor * l1_loss(
            distance_pts[:, :, 1:], char_corner_distances, smooth=True, smooth_beta=2.5
        )
    # Balances the two tasks' gradients.
    return loss * config.loss_factor
