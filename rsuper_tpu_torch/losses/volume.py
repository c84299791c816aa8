"""The R-Super Volume Loss (counterpart of ``rsuper_tpu/losses/volume.py``).

Compares the report's total tumour volume with the network's predicted soft
volume inside the (dilated) organ sub-segment the report points at.
Channels-last ``(B, D, H, W, C)`` at the boundary; the lesion channels are
merged by a static `LesionChannelMap` and handled channel-first inside.
"""

from __future__ import annotations

import torch

from ..ops.morphology import dilate_cf
from .lesions import LesionChannelMap

_SP3 = (-3, -2, -1)  # spatial axes of the channel-first internal layout


def dice_based_volume_loss(pred_volume, target_volume, tolerance: float = 0.1,
                           E: float = 500.0) -> torch.Tensor:
    """|V̂−V| / (V̂+V+E), shifted down by its value at the tolerance boundary
    (for continuity) and clamped to [0, 1]. E keeps the loss finite at V = 0;
    max(·, min(V, 100)) keeps the dead zone from collapsing for tiny
    tumours. Inputs broadcast; elementwise, float32."""
    x = pred_volume.float()
    y = target_volume.float()
    loss = (x - y).abs() / (x + y + E)
    v = torch.maximum((1.0 - tolerance) * y, torch.clamp(y, max=100.0))
    loss_at_tol = (v - y).abs() / (v + y + E)
    return torch.clamp(loss - loss_at_tol, 0.0, 1.0)


def volume_loss(logits, chosen_segment_mask, tumor_volumes, labels,
                unk_voxels, lmap: LesionChannelMap, *,
                dilation_segment: int = 31, tolerance: float = 0.1,
                E: float = 500.0, class_weights=None,
                precomputed=None) -> torch.Tensor:
    """R-Super Volume Loss; returns a scalar.

    logits (B, D, H, W, C); chosen_segment_mask (B, D, H, W, C) binary, 1 on
    the organ sub-segment the report's tumours lie in; tumor_volumes (B, T)
    report volumes in voxels, zero-padded; labels (B, D, H, W, C) per-voxel
    labels (zero for report-only data); unk_voxels is not used by the loss
    (kept for the signature); class_weights optional (B, C); precomputed an
    optional `ball.lesion_masks_cf` result shared across heads."""
    del unk_voxels
    out = lmap.merge(logits).movedim(-1, 1)  # max of logits = logit of max
    if precomputed is not None:
        seg, _, lab = precomputed
    else:
        seg = dilate_cf(lmap.merge(chosen_segment_mask).movedim(-1, 1).float(),
                        dilation_segment)
        lab = lmap.merge(labels).movedim(-1, 1)

    out = torch.sigmoid(out.float())
    # channels already annotated per voxel are excluded from report supervision
    per_voxel_positive = (lab.float().sum(dim=_SP3, keepdim=True) > 0).float()
    out = out * (1.0 - per_voxel_positive)

    pred_vol = (out * seg).sum(dim=_SP3)  # (B, L)
    report_vol = tumor_volumes.float().sum(dim=-1, keepdim=True)
    gate = (seg.sum(dim=_SP3) > 0).float()
    report_vol = report_vol * gate

    loss = dice_based_volume_loss(pred_vol, report_vol, tolerance=tolerance,
                                  E=E)
    if class_weights is not None:
        loss = loss * lmap.merge(class_weights.float())
    return loss.mean()
