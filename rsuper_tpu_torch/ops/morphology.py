"""Cube dilation for the device post-processing (counterpart of
``rsuper_tpu/ops/morphology.py:dilate_cube_cf``; not a Pallas kernel)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate_cube_cf(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Exact cube-kernel dilation of (..., D, H, W) binary arrays — equals
    scipy ``binary_dilation(structure=ones(3³), iterations=(k-1)//2)``.
    Returns x's type, values in {0, 1}."""
    if kernel_size % 2 == 0:
        kernel_size += 1
    if kernel_size <= 1:
        return x
    lead = x.shape[:-3]
    v = x.float().reshape(-1, 1, *x.shape[-3:])
    v = F.max_pool3d(v, kernel_size, stride=1, padding=kernel_size // 2)
    return (v > 0.5).to(x.dtype).reshape(*lead, *x.shape[-3:])
