"""The classification branch's loss, the multi-task baseline (counterpart
of ``rsuper_tpu/losses/classification.py``).

Reference: ``rsuper_train/training/losses_foundation.py:614-664``
(``classification_loss``): multi-label BCE on each lesion class's presence
in the crop, from the labels plus the chosen segment mask of a report
item; a channel that is unknown in the crop and not present is masked out.
"""

from __future__ import annotations

from typing import Optional

import torch

from .lesions import LesionChannelMap
from .seg import bce_with_logits

_SPATIAL = (1, 2, 3)


def classification_loss(cls_logits: torch.Tensor, labels: torch.Tensor,
                        unk_voxels, chosen_segment_mask,
                        lmap: LesionChannelMap,
                        class_weights: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """BCE with logits on lesion presence, float32.

    `cls_logits` (B, Nc), Nc the lesion classes; `labels`, `unk_voxels`
    and `chosen_segment_mask` (B, D, H, W, C), the last two may be None;
    `class_weights` an optional (B, Nc) weight of each term."""
    idx = list(lmap.lesion_class_indices())
    lab = labels[..., idx].float()
    if chosen_segment_mask is not None:
        lab = lab + chosen_segment_mask[..., idx].float()
    presence = (lab.sum(dim=_SPATIAL) > 0).float()  # (B, Nc)

    loss = bce_with_logits(cls_logits.float(), presence, weight=class_weights)

    if unk_voxels is not None:
        unk_presence = (unk_voxels[..., idx].float().sum(dim=_SPATIAL)
                        > 0).float()
        known = ((1.0 - unk_presence) + presence > 0).float()
        loss = loss * known
    return loss.mean()
