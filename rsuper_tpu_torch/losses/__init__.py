from .ball import (BallLossConfig, ball_loss, isolate_tumor,
                   lesion_masks_cf)
from .classification import classification_loss
from .dispatcher import LossConfig, calculate_loss
from .info_nce import info_nce, symmetric_info_nce
from .lesions import LesionChannelMap
from .seg import (adaptive_tversky_dice, get_known_voxels,
                  masked_bce_with_logits)
from .volume import dice_based_volume_loss, volume_loss

__all__ = [
    "masked_bce_with_logits",
    "adaptive_tversky_dice",
    "get_known_voxels",
    "dice_based_volume_loss",
    "volume_loss",
    "ball_loss",
    "isolate_tumor",
    "lesion_masks_cf",
    "BallLossConfig",
    "LesionChannelMap",
    "LossConfig",
    "calculate_loss",
    "classification_loss",
    "info_nce",
    "symmetric_info_nce",
]
