"""Surface-distance metrics: average surface distance, robust (95 %)
Hausdorff distance and normalised surface Dice (the port's own copy of
``rsuper_tpu/metrics/surface.py``; the same floats on the same masks).

Surface voxels are a mask minus its erosion; the distances of one mask's
surface voxels are read from the Euclidean distance transform (EDT) of the
other's surface complement. Spacing-aware via `sampling`. A mask without
surface gives the reference's clamp (``training/validation.py``: empty
masks → 500).

Both EDTs run on the bounding box of the two masks, one voxel wider on each
side (clipped to the volume): outside it both masks are empty, so the
surfaces, and every surface voxel's distance to the nearest surface voxel of
the other mask, are those of the whole volume, at a fraction of an organ's
cost of a CT volume. ``asd_hd95`` derives both metrics from one pair of
EDTs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy import ndimage as ndi

MAX_DISTANCE = 500.0


def _surface(mask: np.ndarray) -> np.ndarray:
    m = mask.astype(bool)
    if not m.any():
        return m
    return m & ~ndi.binary_erosion(m)


def _box(*masks: np.ndarray) -> Tuple[slice, ...]:
    """The bounding box of the masks' voxels, one voxel wider on each side
    within the volume (the whole volume when every mask is empty)."""
    union = np.logical_or.reduce([np.asarray(m, bool) for m in masks])
    box = []
    for axis in range(union.ndim):
        other = tuple(a for a in range(union.ndim) if a != axis)
        hit = np.flatnonzero(union.any(axis=other))
        if hit.size == 0:
            return tuple(slice(None) for _ in range(union.ndim))
        box.append(slice(max(hit[0] - 1, 0), hit[-1] + 2))
    return tuple(box)


def surface_distances(
    pred: np.ndarray, target: np.ndarray, sampling: Sequence[float] = (1.0, 1.0, 1.0)
) -> Tuple[np.ndarray, np.ndarray]:
    """(distances pred-surface→target-surface, target-surface→pred-surface)."""
    box = _box(pred, target)
    ps, ts = _surface(np.asarray(pred)[box]), _surface(np.asarray(target)[box])
    if not ps.any() or not ts.any():
        return np.array([MAX_DISTANCE]), np.array([MAX_DISTANCE])
    dt_t = ndi.distance_transform_edt(~ts, sampling=sampling)
    dt_p = ndi.distance_transform_edt(~ps, sampling=sampling)
    return dt_t[ps], dt_p[ts]


def _asd(d_pt: np.ndarray, d_tp: np.ndarray) -> float:
    return float(min((d_pt.mean() + d_tp.mean()) / 2.0, MAX_DISTANCE))


def _hd95(d_pt: np.ndarray, d_tp: np.ndarray) -> float:
    h = max(np.percentile(d_pt, 95), np.percentile(d_tp, 95))
    return float(min(h, MAX_DISTANCE))


def average_surface_distance(pred, target, sampling=(1.0, 1.0, 1.0)) -> float:
    return _asd(*surface_distances(pred, target, sampling))


def hausdorff95(pred, target, sampling=(1.0, 1.0, 1.0)) -> float:
    return _hd95(*surface_distances(pred, target, sampling))


def asd_hd95(pred, target, sampling=(1.0, 1.0, 1.0)) -> Tuple[float, float]:
    """(``average_surface_distance``, ``hausdorff95``) from one pair of
    EDTs: the same floats as the two calls."""
    d = surface_distances(pred, target, sampling)
    return _asd(*d), _hd95(*d)


def normalized_surface_dice(pred, target, tolerance: float = 1.0,
                            sampling=(1.0, 1.0, 1.0)) -> float:
    """NSD @ tolerance (mm): fraction of both masks' surface points lying
    within `tolerance` of the other mask's surface — the DeepMind
    surface-dice definition the reference's vendored library computes
    (``rsuper_train/metric/metrics.py`` compute_surface_dice_at_tolerance),
    on the EDT formulation. Both-empty masks score 1.0; one-empty scores
    0.0 (no surface within any finite tolerance)."""
    p = np.asarray(pred).astype(bool)
    t = np.asarray(target).astype(bool)
    if not p.any() and not t.any():
        return 1.0
    if not p.any() or not t.any():
        return 0.0
    d_pt, d_tp = surface_distances(p, t, sampling)
    ok = float((d_pt <= tolerance).sum() + (d_tp <= tolerance).sum())
    return ok / float(d_pt.size + d_tp.size)
