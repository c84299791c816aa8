"""Volume preprocessing for prediction (the port's own copy of the parts of
``rsuper_tpu/data/preprocess.py`` that prediction uses, on the numpy/scipy
path): resample to 1 mm³, clip HU and z-score, pad to a minimum size."""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage as ndi

HU_CLIP = (-991.0, 500.0)


def resample_to_spacing(
    data: np.ndarray,
    spacing: Sequence[float],
    new_spacing=(1.0, 1.0, 1.0),
    order: int = 3,
) -> np.ndarray:
    """Resample a volume from `spacing` to `new_spacing` (mm). order=0 for
    labels."""
    zoom = np.asarray(spacing, np.float64) / np.asarray(new_spacing, np.float64)
    if np.allclose(zoom, 1.0, atol=1e-3):
        return data
    return ndi.zoom(data, zoom, order=order, mode="nearest", grid_mode=False)


def clip_and_normalize(image: np.ndarray, clip=HU_CLIP) -> np.ndarray:
    """Clip HU and z-score."""
    img = np.clip(image.astype(np.float32), clip[0], clip[1])
    mean = img.mean()
    std = img.std()
    return (img - mean) / max(std, 1e-8)


def pad_to_min_size(arr: np.ndarray, min_size: Sequence[int],
                    value=0.0) -> np.ndarray:
    """Zero-pad trailing spatial axes up to `min_size` (all at the end)."""
    spatial = arr.shape[-3:]
    pads = [(0, 0)] * (arr.ndim - 3) + [
        (0, max(0, m - s)) for s, m in zip(spatial, min_size)
    ]
    if not any(p[1] for p in pads):
        return arr
    return np.pad(arr, pads, mode="constant", constant_values=value)
