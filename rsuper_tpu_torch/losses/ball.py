"""The R-Super Ball Loss (counterpart of ``rsuper_tpu/losses/ball.py``).

Per batch item and per reported tumour, largest first:
  1. convolve the sigmoid output (restricted to the reported organ
     sub-segment) with a Gaussian-filled ball of the reported diameter; the
     argmax is the best-fitting ball centre;
  2. put a binary ball of diameter·(1 + margin) there, grown while the crop's
     border clips it until it can hold the reported volume;
  3. keep the top-N voxels by confidence inside that ball (N = the reported
     volume, with a small and a big variant at ∓/± the volume margin) as a
     binary pseudo-mask, then erase the found tumour and go on to the next;
  4. supervise with BCE towards the union pseudo-mask — foreground voxels
     weighted by hard-cut-off GWRP, background averaged separately — with a
     border ring (the big mask dilated by 7, minus the small mask) left out;
     plus an optional adaptive-Tversky Dice term. Items with no reported
     tumour get BCE towards zero over the penalisable region.

Slot t of every item runs in one batched step (batched FFTs, one top-N
kernel launch a slot). Where the JAX package uses ``lax.while_loop`` and
``lax.cond`` on traced values, the control flow here is Python's on values
read from the device: which branches a batch needs and how many slots are
live (read once a call), and whether the dilation fall-back must go on (read
once a round). ``host_reads()`` counts those transfers. The pseudo-masks are
supervision targets: they are built under ``torch.no_grad()``, and gradients
flow only through the BCE and Dice terms on the logits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops.balls import (ball_count_clipped, ball_count_wrapped,
                         fft_ball_conv, insert_ball)
from ..ops.gwrp import gwrp_weights_binned_batched
from ..ops.morphology import dilate_cf
from ..ops.selection import topn_masks_multi_batched
from .lesions import LesionChannelMap
from .seg import bce_with_logits

_SP3 = (-3, -2, -1)


def _to_host(t: torch.Tensor):
    """One transfer of a small tensor to the host, counted."""
    _to_host.reads += 1
    return t.tolist()


_to_host.reads = 0


def host_reads() -> int:
    """Device-to-host transfers the Ball Loss has made for its control flow
    since the process started."""
    return _to_host.reads


def _tversky_cf(preds, targets, known, class_weights=None,
                smooth: float = 1e-5) -> torch.Tensor:
    """Adaptive-Tversky Dice on channel-first (..., C, D, H, W) masks (the
    math of ``seg.adaptive_tversky_dice`` with alpha per item and channel);
    the mean over C, one value per leading index."""
    p = torch.sigmoid(preds.float()) * known
    t = targets.float() * known
    tp, fp, fn = p * t, p * (1.0 - t), (1.0 - p) * t
    fp_c, fn_c = fp.sum(dim=_SP3), fn.sum(dim=_SP3)
    alpha = torch.clamp(fp_c / (fp_c + fn_c + smooth), 0.2, 0.8)
    num = tp.sum(dim=_SP3)
    den = num + alpha * fp_c + (1.0 - alpha) * fn_c
    loss = 1.0 - num / (den + smooth)  # (..., C)
    if class_weights is not None:
        loss = loss * class_weights
    return loss.mean(dim=-1)


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


@torch.no_grad()
def _ball_centres(x, diameter, cfg: BallLossConfig):
    """The best-fitting ball's centre per item, (cz, cy, cx) of int64 (B,):
    the first maximum of x (B, D, H, W) convolved with the Gaussian-filled
    ball of each item's `diameter`."""
    shape = x.shape[1:]
    conv = fft_ball_conv(x, diameter, gaussian=cfg.gaussian,
                         gaussian_std=cfg.gaussian_std,
                         max_diameter=cfg.max_diameter)
    flat_idx = torch.argmax(conv.reshape(x.shape[0], -1), dim=-1)
    return (flat_idx // (shape[1] * shape[2]),
            (flat_idx // shape[2]) % shape[1], flat_idx % shape[2])


@torch.no_grad()
def isolate_tumor_batched(x, diameter, volume, cfg: BallLossConfig):
    """Locate one tumour per item and build its (normal, small, big)
    pseudo-masks. `x` (B, D, H, W) non-negative (sigmoid output × organ
    segment); `diameter`, `volume` (B,). The fall-back loop runs until every
    item has converged, with converged items frozen. Returns three
    (B, D, H, W) float32 masks in {0, 1}."""
    B = x.shape[0]
    shape = tuple(x.shape[1:])
    V = int(math.prod(shape))
    f32 = dict(dtype=torch.float32, device=x.device)
    # clamp to the bound of the FFT padding (wrap-around safety); a tumour
    # larger than the crop is handled by the growth of the insertion ball
    diameter = torch.clamp(torch.as_tensor(diameter, **f32).reshape(B),
                           max=float(cfg.max_diameter))
    volume = torch.round(torch.as_tensor(volume, **f32).reshape(B))

    # the reference raises the selected volume to (ball voxel count - 1)
    # whenever the search ball holds more voxels than the reported volume
    ballcount = ball_count_wrapped(shape, diameter)
    volume = torch.where(ballcount > volume, ballcount - 1.0, volume)

    cz, cy, cx = _ball_centres(x, diameter, cfg)

    # -- 2. insertion ball, grown while the border clips it: the ladder
    # d_{k+1} = max(round(1.1·d_k), d_k + 1) is a fixed sequence per item, so
    # every rung is counted at once in closed form and the first that holds
    # the volume is taken
    cands = [diameter]
    for _ in range(cfg.grow_iters):
        d_prev = cands[-1]
        cands.append(torch.maximum(torch.round(d_prev * 1.1), d_prev + 1.0))
    cands = torch.stack(cands, dim=-1)  # (B, grow_iters + 1)
    counts = ball_count_clipped(shape, (cz[:, None], cy[:, None], cx[:, None]),
                                cands * (1.0 + cfg.diameter_margin))
    satisfied = (counts >= volume[:, None]) | (cands >= float(max(shape)))
    first = torch.argmax(satisfied.float(), dim=-1)
    idx = torch.where(satisfied.any(dim=-1), first,
                      torch.full_like(first, cfg.grow_iters))
    d_ins = cands.gather(1, idx[:, None])[:, 0]
    ball = insert_ball(shape, (cz, cy, cx),
                       d_ins * (1.0 + cfg.diameter_margin))

    # -- 3. top-N selection inside the ball
    masked_x = x * ball
    top = torch.full_like(volume, float(V - 1))
    t = torch.minimum(top, volume)
    margin_small = min(0.5, cfg.volume_margin)
    t_small = torch.maximum(torch.round(t * (1.0 - margin_small)),
                            torch.clamp(volume, max=100.0))
    t_big = torch.minimum(top, torch.round(volume * (1.0 + cfg.volume_margin)))
    ns = torch.stack([t, t_small, t_big], dim=-1)  # (B, 3)
    masks = topn_masks_multi_batched(masked_x, ns, iters=cfg.topn_iters)
    masks = masks * ball[:, None]  # (B, 3, D, H, W)

    # -- 4. dilation fall-back for small tumours when too few positive
    # voxels existed (the ball was mostly outside the organ segment)
    small_tumor = volume < float(50 ** 3)
    for _ in range(6):
        grow = small_tumor & (masks[:, 0].sum(dim=_SP3) < 0.7 * volume)
        if not _to_host(grow.any()):
            break
        grown = dilate_cf(masks, 7) * ball[:, None]
        masks = torch.where(grow[:, None, None, None, None], grown, masks)
    return masks[:, 0], masks[:, 1], masks[:, 2]


def isolate_tumor(x, diameter, volume, cfg: BallLossConfig):
    """Single-item `isolate_tumor_batched`: `x` (D, H, W), scalar `diameter`
    and `volume`. Returns three (D, H, W) float32 masks in {0, 1}."""
    f32 = dict(dtype=torch.float32, device=x.device)
    m, ms, mb = isolate_tumor_batched(
        x[None], torch.as_tensor(diameter, **f32).reshape(1),
        torch.as_tensor(volume, **f32).reshape(1), cfg)
    return m[0], ms[0], mb[0]


def _tumor_branch_batched(x_logits, tumor_seg, penalize, volumes, diameters,
                          cfg: BallLossConfig, c_weight, item_valid):
    """Ball Loss of every batch item at once (items without tumours run with
    their work masked out; the caller discards their results).

    x_logits (B, D, H, W): logits of each item's active lesion channel;
    tumor_seg (B, D, H, W): dilated organ sub-segment; penalize (B, D, H, W):
    penalisable region of the active channel; volumes (B, T); diameters
    (B, T, 3); c_weight, item_valid (B,). Returns (loss_bce, loss_dice),
    each (B,)."""
    with torch.no_grad():
        x_iter = torch.sigmoid(x_logits.float()) * tumor_seg

        # tumour slots by volume, descending per item; ties keep their order
        order = torch.argsort(-volumes, dim=-1, stable=True)
        volumes = volumes.gather(-1, order)
        diameters = diameters.gather(-2, order[..., None].expand(-1, -1, 3))
        max_dias = diameters.amax(dim=-1)  # (B, T)

        # the reference's clamps: diameter <= 1 -> 3, volume <= 1 -> 9
        max_dias = torch.where(max_dias <= 1.0, 3.0, max_dias)
        vols = torch.where(volumes <= 1.0, 9.0, volumes)
        valid = (volumes > 0) & item_valid[:, None]  # (B, T)
        # slots are sorted by volume, so an item's valid slots are a prefix
        # and slot t is live iff any item has more than t tumours: dead slots
        # are never run
        n_live = _to_host(valid.any(dim=0).sum())

        pseudo = torch.zeros_like(x_iter)
        big = torch.zeros_like(x_iter)
        for s in range(n_live):
            m, ms, mb = isolate_tumor_batched(x_iter, max_dias[:, s],
                                              vols[:, s], cfg)
            okf = valid[:, s, None, None, None].float()
            sel = (ms if cfg.use_small_pseudo_mask else m) * okf
            x_iter = x_iter * (1.0 - m * okf)
            pseudo = torch.maximum(pseudo, sel)
            big = torch.maximum(big, mb * okf)
        if cfg.dilation_for_background > 0:
            big = dilate_cf(big, cfg.dilation_for_background)
        border = torch.clamp(big - pseudo, 0.0, 1.0)
        penalize = penalize * (1.0 - border)

    bce = bce_with_logits(x_logits, pseudo) * penalize  # (B, D, H, W)

    if cfg.standard_ce:
        loss_bce = bce.mean(dim=_SP3) * c_weight
    else:
        if cfg.gwrp:
            with torch.no_grad():
                n_fg = pseudo.sum(dim=_SP3)  # (B,)
                boosted = torch.sigmoid(x_logits.float()) * pseudo + pseudo
                w = gwrp_weights_binned_batched(
                    boosted, torch.clamp(n_fg, min=1.0),
                    cfg.gwrp_concentration, levels=cfg.gwrp_levels)
                w = w * n_fg[:, None, None, None] * pseudo
            loss_fg = (bce * w).mean(dim=_SP3)
        else:
            loss_fg = (bce * pseudo).mean(dim=_SP3)
        loss_bg = (bce * (1.0 - big)).mean(dim=_SP3)
        loss_bce = (loss_fg + loss_bg) * c_weight

    dice = _tversky_cf(x_logits[:, None], pseudo[:, None], penalize[:, None])
    return loss_bce, dice * c_weight


def _no_tumor_branch_batched(out_logits, to_penalize, cw_lesion):
    """BCE towards zero over the penalisable region for all lesion channels.
    out_logits, to_penalize (B, L, D, H, W); cw_lesion (B, L). Returns
    ((B,), (B,))."""
    zeros = torch.zeros_like(out_logits)
    bce = bce_with_logits(out_logits, zeros) * to_penalize
    loss = (bce * cw_lesion[:, :, None, None, None]).mean(dim=(1, 2, 3, 4))
    dice = _tversky_cf(out_logits, zeros, to_penalize, class_weights=cw_lesion)
    return loss, dice


def ball_loss(logits, labels, unk_voxels, chosen_segment_mask, tumor_volumes,
              tumor_diameters, lmap: LesionChannelMap,
              cfg: BallLossConfig = BallLossConfig(),
              class_weights: Optional[torch.Tensor] = None, precomputed=None):
    """R-Super Ball Loss over a batch.

    Channels-last: logits, labels, unk_voxels, chosen_segment_mask
    (B, D, H, W, C); tumor_volumes (B, T) voxels; tumor_diameters (B, T, 3)
    mm (= voxels at 1 mm³ spacing), zero-padded slots; class_weights optional
    (B, C); precomputed an optional `lesion_masks_cf` result shared across
    heads. Returns {'ball_loss_bce', 'ball_loss_dice'} of float32 scalars."""
    out = lmap.merge(logits).movedim(-1, 1)  # (B, L, D, H, W)
    if precomputed is None:
        precomputed = lesion_masks_cf(labels, unk_voxels, chosen_segment_mask,
                                      lmap, cfg.subseg_dilation,
                                      cfg.unk_dilation)
    seg, unk, lab = precomputed
    B, L = out.shape[:2]
    tumor_volumes = tumor_volumes.float()

    with torch.no_grad():
        to_penalize = ((1.0 - unk) * (1.0 - lab) + seg > 0).float()
        if class_weights is not None:
            cw = lmap.merge(class_weights.float())  # (B, L)
        else:
            cw = torch.ones((B, L), dtype=torch.float32, device=out.device)
        gate = seg.sum(dim=_SP3) > 0  # (B, L)
        active = torch.argmax(gate.float(), dim=-1)  # (B,), the first
        has_tumor = gate.any(dim=-1) & (tumor_volumes.sum(dim=-1) > 0)  # (B,)
        any_tumor, any_none = _to_host(
            torch.stack([has_tumor.any(), (~has_tumor).any()]))
        pick = active[:, None, None, None, None].expand(-1, 1, *out.shape[2:])

    zeros_b = torch.zeros((B,), dtype=torch.float32, device=out.device)
    bce_t = dice_t = bce_n = dice_n = zeros_b
    if any_tumor:  # a batch without reports skips the whole construction
        # the active channel's logits, in float32 as the JAX package's
        # one-hot contraction returns them
        bce_t, dice_t = _tumor_branch_batched(
            out.gather(1, pick)[:, 0].float(),
            seg.sum(dim=1),  # only the active channel is non-zero
            to_penalize.gather(1, pick)[:, 0], tumor_volumes,
            tumor_diameters.float(), cfg, cw.gather(1, active[:, None])[:, 0],
            has_tumor)
    if any_none:
        bce_n, dice_n = _no_tumor_branch_batched(out, to_penalize, cw)
    losses = {"ball_loss_bce": torch.where(has_tumor, bce_t, bce_n).mean()}
    if cfg.apply_dice_loss:
        losses["ball_loss_dice"] = torch.where(has_tumor, dice_t,
                                               dice_n).mean()
    else:
        losses["ball_loss_dice"] = torch.zeros((), dtype=torch.float32,
                                               device=out.device)
    return losses
