"""Legacy losses kept for the API of the reference's ``training/losses.py``
(counterpart of ``rsuper_tpu/losses/legacy.py``): the softmax Dice with an
adaptive Tversky alpha and the binary focal loss. The R-Super path does not
use them."""

from __future__ import annotations

import torch


def softmax_dice_loss(logits: torch.Tensor, target_indices: torch.Tensor,
                      smooth: float = 1e-5) -> torch.Tensor:
    """Adaptive-Tversky Dice over softmax probabilities with integer
    targets: `logits` (B, D, H, W, C), `target_indices` (B, D, H, W). The
    mean over classes of 1 − Dice, alpha = clip(FP / (FP + FN), 0.2, 0.8)
    per class. An index outside [0, C) one-hots to zeros, as
    ``jax.nn.one_hot`` does."""
    C = logits.shape[-1]
    p = torch.softmax(logits.float(), dim=-1)
    classes = torch.arange(C, device=logits.device)
    t = (target_indices[..., None] == classes).float()
    red = tuple(range(p.dim() - 1))  # every axis but the class axis
    tp_c = torch.sum(p * t, dim=red)
    fp_c = torch.sum(p * (1.0 - t), dim=red)
    fn_c = torch.sum((1.0 - p) * t, dim=red)
    alpha = torch.clamp(fp_c / (fp_c + fn_c + smooth), 0.2, 0.8)
    dice = tp_c / (tp_c + alpha * fp_c + (1.0 - alpha) * fn_c + smooth)
    return torch.mean(1.0 - dice)


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Binary focal loss on logits, the mean over every element."""
    p = torch.sigmoid(logits.float())
    t = targets.float()
    pt = p * t + (1.0 - p) * (1.0 - t)
    w = alpha * t + (1.0 - alpha) * (1.0 - t)
    loss = -w * (1.0 - pt) ** gamma * torch.log(torch.clamp(pt, 1e-8, 1.0))
    return torch.mean(loss)
