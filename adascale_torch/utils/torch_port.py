"""Reference ``AdaptiveScaling`` state dicts -> the JAX package's parameter tree.

The port's copy of ``adascale/utils/torch_port.py``: a state dict of the
reference PyTorch model (``vkit_open_model``'s ``AdaptiveScaling``, FPN or
UPerNeXt necks, optionally the precise char-mask head) becomes the nested
Flax parameter tree with numpy leaves, which ``utils.params.
state_dict_from_jax`` turns into the port's own state dict. Layouts:

  Linear     (out, in)            -> Dense kernel (in, out)
  Conv2d     (O, I/g, kh, kw)     -> Conv kernel  (kh, kw, I/g, O)
  LayerNorm  weight / bias        -> scale / bias
  block_scale (C, 1, 1)           -> (C,)
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np


def _np(t: Any) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _linear(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _np(sd[f"{prefix}.weight"]).T, "bias": _np(sd[f"{prefix}.bias"])}


def _conv(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0),
        "bias": _np(sd[f"{prefix}.bias"]),
    }


def _ln(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def convnext_params_from_torch(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """The reference ConvNext's leaves under ``prefix`` -> the ConvNeXt tree
    (``stem_conv``, ``stem_ln``, ``stage{i}`` with ``layer{j}``, ``ln`` and
    ``downsample``)."""
    p = prefix
    out: Dict[str, Any] = {"stem_conv": _conv(sd, f"{p}stem.0"), "stem_ln": _ln(sd, f"{p}stem.2")}
    stage_idx = 0
    while f"{p}blocks.{stage_idx}.ln.1.weight" in sd:
        stage: Dict[str, Any] = {}
        layer_idx = 0
        while f"{p}blocks.{stage_idx}.layers.{layer_idx}.block_scale" in sd:
            lp = f"{p}blocks.{stage_idx}.layers.{layer_idx}"
            stage[f"layer{layer_idx}"] = {
                "dwconv": _conv(sd, f"{lp}.block.0"),
                "ln": _ln(sd, f"{lp}.block.2"),
                "mlp_up": _linear(sd, f"{lp}.block.3"),
                "mlp_down": _linear(sd, f"{lp}.block.5"),
                "block_scale": _np(sd[f"{lp}.block_scale"]).reshape(-1),
            }
            layer_idx += 1
        stage["ln"] = _ln(sd, f"{p}blocks.{stage_idx}.ln.1")
        if f"{p}blocks.{stage_idx}.pconv2x2.weight" in sd:
            stage["downsample"] = _conv(sd, f"{p}blocks.{stage_idx}.pconv2x2")
        out[f"stage{stage_idx}"] = stage
        stage_idx += 1
    return out


def fpn_neck_params_from_torch(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """The reference FpnNeck -> ``step1_{i}`` (1x1) and ``step2_{i}`` (3x3)."""
    out: Dict[str, Any] = {}
    i = 0
    while f"{prefix}step1_conv_blocks.{i}.1.weight" in sd:
        out[f"step1_{i}"] = {
            "conv": _linear(sd, f"{prefix}step1_conv_blocks.{i}.1"),
            "ln": _ln(sd, f"{prefix}step1_conv_blocks.{i}.2"),
        }
        out[f"step2_{i}"] = {
            "conv": _conv(sd, f"{prefix}step2_conv_blocks.{i}.0"),
            "ln": _ln(sd, f"{prefix}step2_conv_blocks.{i}.2"),
        }
        i += 1
    return out


def upernext_neck_params_from_torch(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """The reference UperNextNeck -> ``step1_{i}``, ``ppm`` (``ap_conv{k}``,
    ``final_conv``) on the last level, and ``step2_{i}``."""
    out: Dict[str, Any] = {}
    i = 0
    while f"{prefix}step1_conv_blocks.{i}.1.weight" in sd:
        out[f"step1_{i}"] = {
            "conv": _linear(sd, f"{prefix}step1_conv_blocks.{i}.1"),
            "ln": _ln(sd, f"{prefix}step1_conv_blocks.{i}.2"),
        }
        i += 1
    num_levels = i + 1
    ppm_prefix = f"{prefix}step1_conv_blocks.{num_levels - 1}"
    ppm: Dict[str, Any] = {}
    k = 0
    while f"{ppm_prefix}.ap_conv_blocks.{k}.1.1.weight" in sd:
        ppm[f"ap_conv{k}"] = {
            "conv": _linear(sd, f"{ppm_prefix}.ap_conv_blocks.{k}.1.1"),
            "ln": _ln(sd, f"{ppm_prefix}.ap_conv_blocks.{k}.1.2"),
        }
        k += 1
    ppm["final_conv"] = {
        "conv": _conv(sd, f"{ppm_prefix}.final_conv_block.0"),
        "ln": _ln(sd, f"{ppm_prefix}.final_conv_block.2"),
    }
    out["ppm"] = ppm
    for i in range(num_levels - 1):
        out[f"step2_{i}"] = {
            "conv": _conv(sd, f"{prefix}step2_conv_blocks.{i}.0"),
            "ln": _ln(sd, f"{prefix}step2_conv_blocks.{i}.2"),
        }
    return out


def fpn_head_params_from_torch(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """The reference FpnHead -> ``step1`` (conv + LN) and ``step2`` (Dense)."""
    return {
        "step1": {"conv": _conv(sd, f"{prefix}step1_conv.0"), "ln": _ln(sd, f"{prefix}step1_conv.2")},
        "step2": _linear(sd, f"{prefix}step2_conv.1"),
    }


def upernext_head_params_from_torch(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """The reference UperNextHead -> ``step1`` (conv + LN) and ``step2``."""
    return {
        "step1": {
            "conv": _conv(sd, f"{prefix}step1_conv3x3.0"),
            "ln": _ln(sd, f"{prefix}step1_conv3x3.2"),
        },
        "step2": _linear(sd, f"{prefix}step2_conv1x1.1"),
    }


NECK_HEADS: Dict[str, tuple[Callable, Callable]] = {
    "fpn": (fpn_neck_params_from_torch, fpn_head_params_from_torch),
    "upernext": (upernext_neck_params_from_torch, upernext_head_params_from_torch),
}


def adaptive_scaling_params_from_torch(
    sd: Mapping[str, Any],
    neck_head_type: str = "fpn",
    precise_enable_char_mask_head: bool = False,
) -> Dict[str, Any]:
    """A reference ``AdaptiveScaling`` state dict -> the nested parameter
    tree (numpy leaves). The softplus heads are ``nn.Sequential(head,
    Softplus)`` in the reference, hence their ``.0``."""
    if neck_head_type not in NECK_HEADS:
        raise ValueError(f"neck_head_type {neck_head_type!r}: one of {sorted(NECK_HEADS)}")
    neck_fn, head_fn = NECK_HEADS[neck_head_type]
    out: Dict[str, Any] = {
        "backbone": convnext_params_from_torch(sd, "backbone."),
        "rough_neck": neck_fn(sd, "rough_neck."),
        "rough_char_mask_head": head_fn(sd, "rough_char_mask_head."),
        "rough_char_height_head": head_fn(sd, "rough_char_height_head.0."),
        "precise_neck": neck_fn(sd, "precise_neck."),
        "precise_char_prob_head": head_fn(sd, "precise_char_prob_head."),
        "precise_char_up_left_corner_offset_head": head_fn(
            sd, "precise_char_up_left_corner_offset_head."
        ),
        "precise_char_corner_angle_head": head_fn(sd, "precise_char_corner_angle_head."),
        "precise_char_corner_distance_head": head_fn(sd, "precise_char_corner_distance_head.0."),
    }
    if precise_enable_char_mask_head:
        out["precise_char_mask_head"] = head_fn(sd, "precise_char_mask_head.")
    return out
