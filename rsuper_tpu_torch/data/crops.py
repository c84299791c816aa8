"""Host-side (numpy) cropping, the port's own copy of
``rsuper_tpu/data/crops.py``: the data-dependent, branchy part of the input
pipeline, kept on the CPU, feeding fixed-shape records to the device.

Equivalents of R-Super's crop family: ``crop_3d``, ``crop_around``
('small_rnd_shift'), ``random_crop_on_tumor`` (tumour 0.9 / organ /
background split), ``denoise_mask``, ``crop_foreground`` (bounding-box fit,
morphological fallback, random valid shift) and ``pad_pair``. The same
``np.random.Generator`` makes the same draws in the same order as the JAX
package's.

Arrays: image (D, H, W) float32; labels (C, D, H, W) uint8.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
from scipy import ndimage as ndi


def pad_pair(image: np.ndarray, labels: Optional[np.ndarray], size: Sequence[int]):
    """Symmetric zero-pad spatial dims up to `size` (both arrays identically)."""
    spatial = image.shape[-3:]
    pads = []
    for s, m in zip(spatial, size):
        total = max(0, m - s)
        pads.append((total // 2, total - total // 2))
    if not any(a or b for a, b in pads):
        return image, labels
    image = np.pad(image, pads)
    if labels is not None:
        labels = np.pad(labels, [(0, 0)] + pads)
    return image, labels


def _crop_at(image, labels, start, size):
    sl = tuple(slice(s, s + c) for s, c in zip(start, size))
    img = np.ascontiguousarray(image[sl])
    lab = None if labels is None else np.ascontiguousarray(labels[(slice(None),) + sl])
    return img, lab


def crop_3d(image, labels, size, mode: str = "random", rng=None):
    """Random or centre crop to `size`."""
    rng = rng or np.random.default_rng()
    D, H, W = image.shape
    if mode == "random":
        start = [int(rng.integers(0, max(1, d - c + 1))) for d, c in zip((D, H, W), size)]
    else:
        start = [(d - c) // 2 for d, c in zip((D, H, W), size)]
    return _crop_at(image, labels, start, size)


def crop_around(image, labels, size, center, rng=None, shift_frac: float = 0.25):
    """Crop containing `center`, randomly shifted by up to shift_frac·size
    (the reference's 'small_rnd_shift' mode)."""
    rng = rng or np.random.default_rng()
    start = []
    for dim, c, ctr in zip(image.shape, size, center):
        lo = int(ctr) - c // 2 + int(rng.integers(-int(c * shift_frac), int(c * shift_frac) + 1))
        lo = min(max(lo, 0), max(0, dim - c))
        start.append(lo)
    return _crop_at(image, labels, start, size)


def _random_voxel(mask, rng):
    idx = np.flatnonzero(mask)
    if idx.size == 0:
        return None
    flat = int(rng.choice(idx))
    return np.unravel_index(flat, mask.shape)


def random_crop_on_tumor(
    image,
    labels,
    lesion_classes: Sequence[int],
    size,
    tumor_case: bool,
    foreground_classes: Optional[Sequence[int]] = None,
    rng=None,
):
    """The reference's sampling mix: tumor 0.9 / organ 0.05 / background 0.05
    for tumor cases, organ 0.9 / background 0.1 otherwise, with fallbacks."""
    rng = rng or np.random.default_rng()
    r = rng.random()
    tumor_p, bg_p = (0.9, 0.05) if tumor_case else (0.0, 0.1)

    if r < tumor_p:
        present = [c for c in lesion_classes if labels[c].any()]
        if present:
            c = int(rng.choice(present))
            ctr = _random_voxel(labels[c], rng)
            return crop_around(image, labels, size, ctr, rng)
        return crop_3d(image, labels, size, "random", rng)
    if r < tumor_p + bg_p:
        bg = labels.sum(0) == 0
        ctr = _random_voxel(bg, rng)
        if ctr is None:
            return crop_3d(image, labels, size, "random", rng)
        return crop_around(image, labels, size, ctr, rng)
    # organ crop
    cand = [
        c
        for c in range(labels.shape[0])
        if c not in lesion_classes
        and (foreground_classes is None or c in foreground_classes)
        and labels[c].any()
    ]
    if not cand:
        return crop_3d(image, labels, size, "random", rng)
    c = int(rng.choice(cand))
    ctr = _random_voxel(labels[c], rng)
    return crop_around(image, labels, size, ctr, rng)


def denoise_mask(mask: np.ndarray, iterations: int = 3, largest_cc: bool = True):
    """Erode+dilate then AND with the original; optionally keep the largest
    connected component (reference ``denoise_mask`` :746)."""
    m = mask.astype(bool)
    er = ndi.binary_erosion(m, iterations=iterations)
    out = ndi.binary_dilation(er, iterations=iterations) & m
    if largest_cc and out.any():
        lab, n = ndi.label(out)
        if n > 1:
            counts = np.bincount(lab.ravel())
            counts[0] = 0
            out = lab == int(np.argmax(counts))
    return out


def crop_foreground(
    image,
    labels,
    foreground: np.ndarray,
    size,
    margin: int = 1,
    refine_iterations: int = 3,
    rng=None,
) -> Union[str, Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
    """Crop of exactly `size` fully containing the foreground mask's bounding
    box, randomly shifted within the valid range. Returns
    (image, labels, cropped_foreground) or an error string
    ('zero mask' / 'mask does not fit crop size') like the reference."""
    rng = rng or np.random.default_rng()
    fg = foreground.astype(bool)
    if not fg.any():
        return "zero mask"

    def bbox(m):
        out = []
        for ax in range(3):
            proj = np.any(m, axis=tuple(a for a in range(3) if a != ax))
            nz = np.flatnonzero(proj)
            out.append((max(int(nz[0]) - margin, 0),
                        min(int(nz[-1]) + margin, m.shape[ax] - 1)))
        return out

    bb = bbox(fg)
    if any(hi - lo + 1 > c for (lo, hi), c in zip(bb, size)):
        fg = denoise_mask(fg, iterations=refine_iterations)
        if not fg.any():
            return "zero mask"
        bb = bbox(fg)
        if any(hi - lo + 1 > c for (lo, hi), c in zip(bb, size)):
            return "mask does not fit crop size"

    start = []
    for (lo, hi), dim, c in zip(bb, fg.shape, size):
        s_lo = max(hi - (c - 1), 0)
        s_hi = min(lo, dim - c)
        if s_lo > s_hi:
            start.append(max(0, min(lo, dim - c)))
        else:
            start.append(int(rng.integers(s_lo, s_hi + 1)))

    img, lab = _crop_at(image, labels, start, size)
    sl = tuple(slice(s, s + c) for s, c in zip(start, size))
    cropped_fg = fg[sl]
    if not cropped_fg.any():
        return "zero mask"
    return img, lab, cropped_fg.astype(np.uint8)
