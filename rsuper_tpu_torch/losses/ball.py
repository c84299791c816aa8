"""The part of ``rsuper_tpu/losses/ball.py`` that the Volume Loss route needs:
the Ball Loss's static configuration and the lesion-space masks shared by the
report losses. The Ball Loss itself (tumour isolation, top-N selection, GWRP)
is not ported yet: ``ball_loss`` raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.morphology import dilate_cf
from .lesions import LesionChannelMap


class BallLossConfig(NamedTuple):
    """Static hyper-parameters of the Ball Loss (the reference's defaults)."""

    diameter_margin: float = 0.2
    volume_margin: float = 0.2
    gaussian: bool = True
    gaussian_std: float = 1.5
    gwrp: bool = True
    gwrp_concentration: float = 0.5
    dilation_for_background: int = 7
    subseg_dilation: int = 31
    unk_dilation: int = 1
    standard_ce: bool = False
    use_small_pseudo_mask: bool = True
    apply_dice_loss: bool = False
    max_diameter: int = 96  # static bound on reported diameters (voxels)
    grow_iters: int = 12  # bound for the border-growth loop
    topn_iters: int = 26  # bisection depth for top-N selection
    gwrp_levels: int = 256  # rank resolution for GWRP weights


@torch.no_grad()
def lesion_masks_cf(labels, unk_voxels, chosen_segment_mask,
                    lmap: LesionChannelMap, subseg_dilation: int = 31,
                    unk_dilation: int = 1):
    """The lesion-space, channel-first masks shared by the ball and volume
    losses: (segment mask dilated, unk dilated, labels), each (B, L, D, H, W)
    float32. They are batch data, computed once per step for every head; no
    gradient flows through them."""
    def to_cf(t):
        return lmap.merge(t).movedim(-1, 1).float()

    seg = dilate_cf(to_cf(chosen_segment_mask), subseg_dilation)
    unk = dilate_cf(to_cf(unk_voxels), unk_dilation)
    return seg, unk, to_cf(labels)


def ball_loss(*args, **kwargs):
    """Not ported yet: the Ball Loss and its top-N selection kernels belong
    to the Ball Loss slice of the port."""
    raise NotImplementedError(
        "the Ball Loss (rsuper_tpu/losses/ball.py:ball_loss) is not ported "
        "yet; use LossConfig(loss='dice') for the Volume Loss route")
