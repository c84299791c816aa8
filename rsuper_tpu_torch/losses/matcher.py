"""Hungarian matching of prediction channels to label channels for
multi-channel tumour instances (counterpart of
``rsuper_tpu/losses/matcher.py``): per batch item, the assignment that
minimises a soft-Dice cost, found on the host with scipy."""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def dice_cost_matrix(pred_probs: np.ndarray, labels: np.ndarray,
                     eps: float = 1e-6) -> np.ndarray:
    """(D, H, W, Cp), (D, H, W, Cl) → cost (Cp, Cl) = 1 − soft Dice."""
    p = pred_probs.reshape(-1, pred_probs.shape[-1]).astype(np.float64)
    t = labels.reshape(-1, labels.shape[-1]).astype(np.float64)
    inter = p.T @ t  # (Cp, Cl)
    sums = p.sum(0)[:, None] + t.sum(0)[None, :]
    dice = (2 * inter + eps) / (sums + eps)
    return 1.0 - dice


def hungarian_match(pred_probs: np.ndarray, labels: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Channel assignment (pred_idx, label_idx), int32, of least total
    Dice cost."""
    cost = dice_cost_matrix(pred_probs, labels)
    ri, ci = linear_sum_assignment(cost)
    return ri.astype(np.int32), ci.astype(np.int32)


def match_batch(pred_probs: np.ndarray, labels: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Channels-last (B, D, H, W, C) matching → two (B, C) int32 index
    arrays."""
    B = pred_probs.shape[0]
    out_p = np.zeros((B, pred_probs.shape[-1]), np.int32)
    out_l = np.zeros((B, labels.shape[-1]), np.int32)
    for b in range(B):
        out_p[b], out_l[b] = hungarian_match(pred_probs[b], labels[b])
    return out_p, out_l
