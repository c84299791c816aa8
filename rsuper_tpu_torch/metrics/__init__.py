from .dice import dice_per_class, dice_score
from .surface import (asd_hd95, average_surface_distance, hausdorff95,
                      normalized_surface_dice, surface_distances)

__all__ = [
    "dice_score",
    "dice_per_class",
    "surface_distances",
    "average_surface_distance",
    "hausdorff95",
    "asd_hd95",
    "normalized_surface_dice",
]
