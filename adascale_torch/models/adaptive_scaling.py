"""AdaptiveScaling detector: shared ConvNeXt backbone, two necks (FPN or
UPerNeXt) and six heads, NHWC, PyTorch.

Counterpart of ``adascale/models/adaptive_scaling.py``:

  ``forward_rough(x)``   -> (mask logits, char height), each (B, H/2, W/2, 1)
  ``forward_precise(x)`` -> (prob logits (B,h,w,1), up-left offset (B,h,w,2),
                             corner-angle logits (B,h,w,4), corner distance
                             (B,h,w,4))
  ``forward_precise_with_mask(x)`` -> the precise char-mask logits, then
                             the four above (``precise_enable_char_mask_head``)

Each forward takes ``deterministic`` (False: stochastic depth in the
backbone, with the ``drop_masks`` of ``ConvNeXt.draw_drop_masks``).

``AdaptiveScaling(config, dtype, residual_dtype)`` takes Flax's ``dtype``
(``ConvNeXt`` says what ``residual_dtype`` picks). Softplus on the height
and distance heads runs in f32. Submodule names
follow the Flax tree, so ``utils.params.state_dict_from_jax`` loads the
committed weights directly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .convnext import CONVNEXT_PRESETS, ConvNeXt
from .fpn import FpnHead, FpnNeck
from .upernext import UperNextHead, UperNextNeck

NECK_HEADS = {"fpn": (FpnNeck, FpnHead), "upernext": (UperNextNeck, UperNextHead)}


@dataclasses.dataclass(frozen=True)
class AdaptiveScalingConfig:
    """Same fields as the JAX package's config; sizes and neck types
    (``"fpn"``, ``"upernext"``) are plain strings."""

    size: str = "small"
    neck_head_type: str = "fpn"
    rough_upsampling_factor: int = 2
    rough_init_char_height_output_bias: float = 8.0
    precise_upsampling_factor: int = 2
    precise_enable_char_mask_head: bool = False
    custom_block_channels_and_num_layers: Optional[Tuple[Tuple[int, int], ...]] = None

    def backbone_spec(self) -> Tuple[Tuple[int, int], ...]:
        if self.custom_block_channels_and_num_layers is not None:
            return tuple(tuple(s) for s in self.custom_block_channels_and_num_layers)
        return CONVNEXT_PRESETS[self.size]


class AdaptiveScaling(nn.Module):
    def __init__(
        self,
        config: AdaptiveScalingConfig = AdaptiveScalingConfig(),
        dtype: torch.dtype = torch.float32,
        residual_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if config.neck_head_type not in NECK_HEADS:
            raise ValueError(f"neck_head_type {config.neck_head_type!r}: one of {sorted(NECK_HEADS)}")
        neck_cls, head_cls = NECK_HEADS[config.neck_head_type]
        self.config = config
        self.dtype = dtype
        self.backbone = ConvNeXt(config.backbone_spec(), dtype, residual_dtype)
        group = self.backbone.in_channels_group
        neck_c = group[-2]
        ru, pu = config.rough_upsampling_factor, config.precise_upsampling_factor
        self.rough_neck = neck_cls(group, neck_c, dtype)
        self.rough_char_mask_head = head_cls(neck_c, 1, ru, dtype)
        self.rough_char_height_head = head_cls(neck_c, 1, ru, dtype)
        self.precise_neck = neck_cls(group, neck_c, dtype)
        if config.precise_enable_char_mask_head:
            self.precise_char_mask_head = head_cls(neck_c, 1, pu, dtype)
        self.precise_char_prob_head = head_cls(neck_c, 1, pu, dtype)
        self.precise_char_up_left_corner_offset_head = head_cls(neck_c, 2, pu, dtype)
        self.precise_char_corner_angle_head = head_cls(neck_c, 4, pu, dtype)
        self.precise_char_corner_distance_head = head_cls(neck_c, 4, pu, dtype)
        with torch.no_grad():
            self.rough_char_height_head.step2.bias.fill_(
                config.rough_init_char_height_output_bias
            )

    def forward_rough_from_features(
        self, features: Sequence[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        neck = self.rough_neck(features)
        mask_logits = self.rough_char_mask_head(neck)
        height = F.softplus(self.rough_char_height_head(neck).float())
        return mask_logits, height

    def forward_precise_from_features(
        self, features: Sequence[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        neck = self.precise_neck(features)
        prob_logits = self.precise_char_prob_head(neck)
        offset = self.precise_char_up_left_corner_offset_head(neck)
        angle_logits = self.precise_char_corner_angle_head(neck)
        distance = F.softplus(self.precise_char_corner_distance_head(neck).float())
        return prob_logits, offset, angle_logits, distance

    def forward_rough(
        self,
        x: torch.Tensor,
        deterministic: bool = True,
        drop_masks: Optional[List[Optional[torch.Tensor]]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) -> mask logits, char height."""
        return self.forward_rough_from_features(
            self.backbone(x, deterministic, drop_masks)
        )

    def forward_precise(
        self,
        x: torch.Tensor,
        deterministic: bool = True,
        drop_masks: Optional[List[Optional[torch.Tensor]]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) -> prob logits, offset, angle logits, distance."""
        return self.forward_precise_from_features(
            self.backbone(x, deterministic, drop_masks)
        )

    def forward_precise_with_mask(
        self,
        x: torch.Tensor,
        deterministic: bool = True,
        drop_masks: Optional[List[Optional[torch.Tensor]]] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """(B, H, W, 3) -> char-mask logits, prob logits, offset, angle
        logits, distance; needs ``precise_enable_char_mask_head``."""
        if not self.config.precise_enable_char_mask_head:
            raise ValueError("forward_precise_with_mask needs precise_enable_char_mask_head=True")
        neck = self.precise_neck(self.backbone(x, deterministic, drop_masks))
        mask_logits = self.precise_char_mask_head(neck)
        prob_logits = self.precise_char_prob_head(neck)
        offset = self.precise_char_up_left_corner_offset_head(neck)
        angle_logits = self.precise_char_corner_angle_head(neck)
        distance = F.softplus(self.precise_char_corner_distance_head(neck).float())
        return mask_logits, prob_logits, offset, angle_logits, distance



@torch.no_grad()
def init_like_flax_(model: AdaptiveScaling, generator: torch.Generator) -> AdaptiveScaling:
    """Draw ``model``'s parameters from the distributions the JAX package's
    ``model.init`` draws them from (not the same numbers): every Conv and
    Dense kernel of the backbone and the UPerNeXt neck and heads from
    ``truncated_normal(0.02)`` (a standard normal cut at +-2, times 0.02),
    of the FPN neck and heads from
    ``variance_scaling(2.0, "fan_in", "normal")``; biases 0 but the rough
    height head's output bias (``rough_init_char_height_output_bias``);
    LayerNorm 1 and 0, layer scale 1e-6. In place; returns ``model``."""
    kaiming = model.config.neck_head_type == "fpn"
    height_bias = model.rough_char_height_head.step2.bias.clone()
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            if kaiming and not name.startswith("backbone."):
                fan_in = p[0].numel()
                p.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
            else:
                torch.nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(0.02)
        elif name.endswith(".bias"):
            p.zero_()
    model.rough_char_height_head.step2.bias.copy_(height_bias)
    return model
