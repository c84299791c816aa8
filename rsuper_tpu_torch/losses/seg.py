"""Segmentation losses: masked BCE-with-logits and adaptive-Tversky Dice
(counterpart of ``rsuper_tpu/losses/seg.py``).

All tensors are channels-last ``(B, D, H, W, C)``; the spatial reductions run
over axes (1, 2, 3). The elementwise work runs in the input's type (bf16 in
training); every reduction accumulates in float32.
"""

from __future__ import annotations

import torch

from ..ops.morphology import dilate_cf

_SPATIAL = (1, 2, 3)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    weight=None) -> torch.Tensor:
    """Elementwise numerically-stable binary cross-entropy on logits
    (``F.binary_cross_entropy_with_logits(reduction='none')`` with the
    optional elementwise ``weight``), in the logits' type."""
    x = logits
    z = targets.to(x.dtype)
    loss = torch.clamp(x, min=0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    if weight is not None:
        loss = loss * weight.to(x.dtype)
    return loss


def bce_probs(probs: torch.Tensor, targets: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """Elementwise BCE on probabilities, float32."""
    p = torch.clamp(probs.float(), eps, 1.0 - eps)
    z = targets.float()
    return -(z * torch.log(p) + (1.0 - z) * torch.log1p(-p))


def get_known_voxels(unk_voxels: torch.Tensor,
                     dilation: int = 5) -> torch.Tensor:
    """known = 1 − dilate(unk, 5): the voxels the standard losses may
    supervise (unk marks organs whose tumours are only described in the
    report). (B, D, H, W, C) float32."""
    unk = unk_voxels.float()
    if dilation > 0:
        unk = dilate_cf(unk.movedim(-1, 1), dilation).movedim(1, -1)
    return 1.0 - unk


def masked_bce_with_logits(logits, targets, known_voxels,
                           class_weights=None) -> torch.Tensor:
    """Mean BCE over all voxels, zeroed on unknown voxels. The mean divides
    by the FULL voxel count, not the known count. `class_weights`: optional
    (B, C), broadcast over space."""
    w = None
    if class_weights is not None:
        w = class_weights[:, None, None, None, :]
    loss = bce_with_logits(logits, targets, weight=w)
    return torch.mean(loss * known_voxels.to(loss.dtype), dtype=torch.float32)


def adaptive_tversky_dice(preds, targets, known_voxels, *,
                          sigmoid: bool = True, class_weights=None,
                          reduce: bool = True,
                          smooth: float = 1e-5) -> torch.Tensor:
    """Tversky Dice with alpha = FP/(FP+FN) per class over the whole batch,
    clamped to [0.2, 0.8]. preds/targets/known: (B, D, H, W, C). Returns a
    scalar (`reduce`) or (B, C)."""
    p = torch.sigmoid(preds) if sigmoid else preds
    t = targets.to(p.dtype)
    k = known_voxels.to(p.dtype)
    p = p * k
    t = t * k

    tp = p * t
    fp = p * (1.0 - t)
    fn = (1.0 - p) * t

    f32 = torch.float32
    fp_c = torch.sum(fp, dim=(0,) + _SPATIAL, dtype=f32)
    fn_c = torch.sum(fn, dim=(0,) + _SPATIAL, dtype=f32)
    alpha = torch.clamp(fp_c / (fp_c + fn_c + smooth), 0.2, 0.8)  # (C,)
    beta = 1.0 - alpha

    num = torch.sum(tp, dim=_SPATIAL, dtype=f32)  # (B, C)
    den = (num + alpha[None] * torch.sum(fp, dim=_SPATIAL, dtype=f32)
           + beta[None] * torch.sum(fn, dim=_SPATIAL, dtype=f32))
    loss = 1.0 - num / (den + smooth)
    if class_weights is not None:
        loss = loss * class_weights.float()
    return loss.mean() if reduce else loss
