"""Report-guided pseudo-label refinement (counterpart of
``rsuper_tpu/baselines/pseudo_labels.py``; the reference's
``baselines/pseudo_labels/pseudo_label_report_refinement.py``): turn a
lesion probability map into the report's n lesion instances by growing
peaks — take the global peak, grow its 26-connected component above
``peak_cut × peak``, keep it if large enough, zero it, repeat.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.ndimage import label as cc_label


def extract_lesion_candidates(
    prob: np.ndarray,
    n_lesions: int,
    peak_cut: float = 0.40,
    min_voxels: int = 11,
    min_peak: float = 0.01,
) -> Tuple[np.ndarray, int]:
    """A uint8 mask of up to `n_lesions` peak-grown components, and how
    many were kept."""
    out = np.zeros(prob.shape, np.uint8)
    work = prob.astype(np.float32).copy()
    conn = np.ones((3, 3, 3), np.uint8)
    kept = 0
    while kept < n_lesions:
        peak = float(work.max(initial=0.0))
        if peak < min_peak:
            break
        peak_idx = np.unravel_index(int(work.argmax()), work.shape)
        lbl, _ = cc_label(work >= peak_cut * peak, structure=conn)
        comp = lbl == lbl[peak_idx]
        if comp.sum() >= min_voxels:
            out[comp] = 1
            kept += 1
        work[comp] = 0.0
    return out, kept


def refine_with_report(
    prob_maps: Dict[str, np.ndarray],
    lesion_counts: Dict[str, int],
    organ_masks: Optional[Dict[str, np.ndarray]] = None,
    **kwargs,
) -> Dict[str, np.ndarray]:
    """Per organ: at most the reported number of lesion instances from its
    probability map (restricted to the organ's mask where one is given);
    an organ the report gives no lesion gets an empty mask."""
    out = {}
    for organ, prob in prob_maps.items():
        n = int(lesion_counts.get(organ, 0))
        if n <= 0:
            out[organ] = np.zeros(prob.shape, np.uint8)
            continue
        if organ_masks is not None and organ in organ_masks:
            prob = prob * (organ_masks[organ] > 0)
        mask, _ = extract_lesion_candidates(prob, n, **kwargs)
        out[organ] = mask
    return out
