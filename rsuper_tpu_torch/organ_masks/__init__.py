"""The organ-mask host tools (counterpart of ``rsuper_tpu/organ_masks/``):
label maps, nnU-Net dataset preparation, dataset repairs, and the case
discovery and sharding of the sub-organ predictor."""

from .labels import (
    SUBSEG_LABELS,
    REGION_LABELS,
    split_label_map,
    combine_label_maps,
    merged_organ,
)

__all__ = [
    "SUBSEG_LABELS",
    "REGION_LABELS",
    "split_label_map",
    "combine_label_maps",
    "merged_organ",
]
