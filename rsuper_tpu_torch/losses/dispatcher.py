"""The loss dispatcher (counterpart of ``rsuper_tpu/losses/dispatcher.py``):
aggregates the segmentation and report losses of every head, the
classification branch's and the CLIP loss into one ``overall`` scalar.

* deep supervision: ``model_output['segmentation']`` may be a list of heads;
  head j is weighted by ``aux_weight[j]``;
* loss-type string: a loss containing ``'ball'`` (or ``'dynamic'``/``'dll'``)
  routes a head to the Ball Loss, except the non-final heads when it also
  contains ``'last'``; anything else (``'dice'``) is the Volume Loss only;
* segmentation loss per head = masked BCE + adaptive-Tversky Dice, both
  masked by known voxels = 1 − dilate(unk, 5);
* ``clip_only``: symmetric InfoNCE between ``model_output['clip']`` and
  the report embeddings, nothing else;
* ``cfg.classification_branch``: the classification branch's BCE on lesion
  presence is added when the output has ``'classification'``;
* ``model_genesis``: the float32 MSE between the one segmentation head and
  the label (``losses/genesis.py``), nothing else. The JAX package fails on
  a model with auxiliary heads there (a list has no ``astype``); the port
  raises ``ValueError`` and sums no heads of its own.

With a data-parallel `group` (``parallel.mesh.DataParallel``) each term is
this rank's share of the global batch's: its mean over the ranks is the
term of the global batch, value and gradient. Every term is a mean over
the batch's items, so a rank takes the mean over its own, except where a
term couples the items: the adaptive-Tversky alpha sums FP and FN over the
ranks, and the CLIP loss takes every rank's embeddings as negatives
(``info_nce.symmetric_info_nce_share``). The Ball Loss needs nothing of the
group: its host-side control flow decides per item (``losses/ball.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from .ball import BallLossConfig, ball_loss, lesion_masks_cf
from .classification import classification_loss
from .genesis import model_genesis_loss
from .info_nce import symmetric_info_nce, symmetric_info_nce_share
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
                   clip_only: bool = False,
                   report_embeddings=None,
                   group=None) -> Dict[str, torch.Tensor]:
    """Every active loss of one training step, as a dict of float32 scalars
    with an ``'overall'`` key (their differentiable sum).

    Volumetric tensors are channels-last (B, D, H, W, C); `tumor_volumes`
    (B, T); `tumor_diameters` (B, T, 3), read by the Ball Loss only;
    `class_weights` optional (B, C); `report_embeddings` (B, F), read by
    ``clip_only`` only; `group` the data-parallel group whose global batch
    the terms are shares of (module docstring)."""
    if model_genesis:
        restored = model_output["segmentation"]
        if isinstance(restored, (tuple, list)):
            raise ValueError(
                "calculate_loss(model_genesis=True) needs a single-head model "
                "(aux_loss=False): the restoration loss reads one output, "
                f"the model gave {len(restored)} heads")
        return model_genesis_loss(restored, label)
    if clip_only:
        if group is not None:
            loss = symmetric_info_nce_share(model_output["clip"],
                                            report_embeddings, group)
        else:
            loss = symmetric_info_nce(model_output["clip"],
                                      report_embeddings)
        return {"contrastive_loss": loss, "overall": loss}
    result = model_output["segmentation"]
    heads: Sequence = result if isinstance(result, (tuple, list)) else [result]
    heads = [h for h in heads if h is not None]
    use_report = cfg.report_volume_loss_basic > 0

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
            terms: Dict[str, torch.Tensor] = {}
            uses_ball = _head_uses_ball(cfg, j)
            if uses_ball:
                bl = ball_loss(logits, label, unk_voxels, chosen_segment_mask,
                               tumor_volumes, tumor_diameters, lmap, bc,
                               class_weights=class_weights, precomputed=pre)
                terms["ball_loss_bce"] = (bl["ball_loss_bce"]
                                          * cfg.ball_bce_weight)
                terms["ball_loss_dice"] = (bl["ball_loss_dice"]
                                           * cfg.ball_dice_weight)
            if not uses_ball or "both" in cfg.loss:
                terms["dice_volume_loss"] = volume_loss(
                    logits, chosen_segment_mask, tumor_volumes, label,
                    unk_voxels, lmap, tolerance=cfg.volume_loss_tolerance,
                    class_weights=class_weights, precomputed=pre)
            for key, val in terms.items():
                losses[key] = (losses.get(key, zero)
                               + w * cfg.report_volume_loss_basic * val)
        seg = masked_bce_with_logits(
            logits, label, known, class_weights=class_weights
        ) + adaptive_tversky_dice(
            logits, label, known, sigmoid=True, class_weights=class_weights,
            group=group)
        loss_seg_total = loss_seg_total + w * cfg.seg_loss * seg

    losses["segmentation"] = loss_seg_total
    if cfg.classification_branch and "classification" in model_output:
        losses["classification"] = classification_loss(
            model_output["classification"], label, unk_voxels,
            chosen_segment_mask, lmap)
    overall = zero
    for v in losses.values():
        overall = overall + v
    losses["overall"] = overall
    return losses
