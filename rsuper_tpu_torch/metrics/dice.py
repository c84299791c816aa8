"""Dice metrics (the port's own copy of ``rsuper_tpu/metrics/dice.py``).

Reference: ``rsuper_train/metric/utils.py:30`` ``calculate_dice_split`` and
``:59`` ``calculate_dice``; on the host a fused reduction does what the
reference splits into blocks to bound GPU memory.
"""

from __future__ import annotations

import numpy as np


def dice_score(pred: np.ndarray, target: np.ndarray, eps: float = 1e-7) -> float:
    """Binary Dice between two masks (any shape)."""
    p = np.asarray(pred) > 0
    t = np.asarray(target) > 0
    inter = np.logical_and(p, t).sum(dtype=np.int64)
    denom = p.sum(dtype=np.int64) + t.sum(dtype=np.int64)
    return float((2.0 * inter + eps) / (denom + eps))


def dice_per_class(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Per-class Dice for channels-last (..., C) binary masks."""
    C = pred.shape[-1]
    return np.array(
        [dice_score(pred[..., c], target[..., c]) for c in range(C)], np.float64
    )
