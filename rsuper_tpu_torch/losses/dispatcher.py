"""The loss dispatcher (counterpart of ``rsuper_tpu/losses/dispatcher.py``):
aggregates the segmentation and report losses of every head into one
``overall`` scalar.

* deep supervision: ``model_output['segmentation']`` may be a list of heads;
  head j is weighted by ``aux_weight[j]``;
* loss-type string: a loss containing ``'ball'`` (or ``'dynamic'``/``'dll'``)
  routes a head to the Ball Loss, except the non-final heads when it also
  contains ``'last'``; anything else (``'dice'``) is the Volume Loss only;
* segmentation loss per head = masked BCE + adaptive-Tversky Dice, both
  masked by known voxels = 1 − dilate(unk, 5).

Ported: the segmentation and Volume Loss routes. A configuration that routes
any head to the Ball Loss, and the ``model_genesis``, ``clip_only`` and
``classification_branch`` modes, raise ``NotImplementedError``; nothing is
downgraded to the Volume Loss silently.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from .ball import BallLossConfig, lesion_masks_cf
from .lesions import LesionChannelMap
from .seg import (adaptive_tversky_dice, get_known_voxels,
                  masked_bce_with_logits)
from .volume import volume_loss


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss hyper-parameters (the reference's CLI defaults)."""

    loss: str = "ball_dice_last"
    aux_weight: tuple = (0.5, 0.5)
    seg_loss: float = 1.0
    report_volume_loss_basic: float = 1.0
    volume_loss_tolerance: float = 0.2
    ball_bce_weight: float = 1.0
    ball_dice_weight: float = 1.0
    standard_ce_ball: bool = False
    ball_volume_margin: float = 0.2
    classification_branch: bool = False
    known_dilation: int = 5
    # static bound on the ball kernels' diameter (voxels)
    ball_max_diameter: int = 64

    def ball_config(self) -> BallLossConfig:
        return BallLossConfig(
            diameter_margin=self.ball_volume_margin,
            volume_margin=self.ball_volume_margin,
            standard_ce=self.standard_ce_ball,
            apply_dice_loss=("dice" in self.loss),
            max_diameter=self.ball_max_diameter,
        )


def _head_uses_ball(cfg: LossConfig, head_idx: int) -> bool:
    is_ball = ("ball" in cfg.loss) or ("dynamic" in cfg.loss) or ("dll" in cfg.loss)
    if not is_ball:
        return False
    if head_idx != 0 and "last" in cfg.loss:
        return False
    return True


def calculate_loss(model_output: Dict[str, Any], label, unk_voxels,
                   chosen_segment_mask, tumor_volumes, tumor_diameters,
                   lmap: LesionChannelMap, cfg: LossConfig = LossConfig(),
                   class_weights=None, model_genesis: bool = False,
                   clip_only: bool = False) -> Dict[str, torch.Tensor]:
    """Every active loss of one training step, as a dict of float32 scalars
    with an ``'overall'`` key (their differentiable sum).

    Volumetric tensors are channels-last (B, D, H, W, C); `tumor_volumes`
    (B, T); `tumor_diameters` (B, T, 3), read by the Ball Loss only;
    `class_weights` optional (B, C)."""
    del tumor_diameters
    for name, on in (("model_genesis", model_genesis), ("clip_only", clip_only),
                     ("classification_branch", cfg.classification_branch)):
        if on:
            raise NotImplementedError(f"calculate_loss({name}=True) is not "
                                      "ported yet")
    result = model_output["segmentation"]
    heads: Sequence = result if isinstance(result, (tuple, list)) else [result]
    heads = [h for h in heads if h is not None]
    use_report = cfg.report_volume_loss_basic > 0
    if use_report:
        ball_heads = [j for j in range(len(heads)) if _head_uses_ball(cfg, j)]
        if ball_heads:
            raise NotImplementedError(
                f"loss={cfg.loss!r} routes head(s) {ball_heads} to the Ball "
                "Loss, which is not ported yet; loss='dice' runs the Volume "
                "Loss route")

    if unk_voxels is not None:
        known = get_known_voxels(unk_voxels, dilation=cfg.known_dilation)
    else:
        known = torch.ones_like(label, dtype=torch.float32)

    zero = torch.zeros((), dtype=torch.float32, device=heads[0].device)
    losses: Dict[str, torch.Tensor] = {}
    loss_seg_total = zero

    # the lesion-space masks (with the dilation by 31) are batch data:
    # computed once, shared by every head
    pre = None
    if use_report:
        bc = cfg.ball_config()
        pre = lesion_masks_cf(label, unk_voxels, chosen_segment_mask, lmap,
                              bc.subseg_dilation, bc.unk_dilation)

    for j, logits in enumerate(heads):
        w = cfg.aux_weight[j] if len(heads) > 1 else 1.0
        if use_report:
            val = volume_loss(logits, chosen_segment_mask, tumor_volumes,
                              label, unk_voxels, lmap,
                              tolerance=cfg.volume_loss_tolerance,
                              class_weights=class_weights, precomputed=pre)
            losses["dice_volume_loss"] = (
                losses.get("dice_volume_loss", zero)
                + w * cfg.report_volume_loss_basic * val)
        seg = masked_bce_with_logits(
            logits, label, known, class_weights=class_weights
        ) + adaptive_tversky_dice(
            logits, label, known, sigmoid=True, class_weights=class_weights
        )
        loss_seg_total = loss_seg_total + w * cfg.seg_loss * seg

    losses["segmentation"] = loss_seg_total
    overall = zero
    for v in losses.values():
        overall = overall + v
    losses["overall"] = overall
    return losses
