"""The adaptive-scaling training losses, in PyTorch (counterpart of
``adascale/losses``)."""
from .adaptive_scaling import (  # noqa: F401
    AdaptiveScalingPreciseLossConfig,
    AdaptiveScalingRoughLossConfig,
    CoreBox,
    get_label_point_feature,
    precise_loss,
    rough_loss,
)
from .primitives import (  # noqa: F401
    bce_with_logits,
    cross_entropy_with_logits_loss,
    dice_loss,
    focal_with_logits_loss,
    l1_loss,
    l2_loss,
    wahr_loss,
    weighted_bce_with_logits_loss,
)
