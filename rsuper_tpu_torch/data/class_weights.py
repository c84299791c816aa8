"""Per-sample class weights from lesion prevalence (the port's own copy of
``rsuper_tpu/data/class_weights.py``, on ``data/table.Table``): the
prevalence of each lesion class in the per-CT metadata, and
inverse-prevalence weights per sample, normalised to sum to C
(``--class_weights``)."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

from .table import Table


def lesion_class_to_organ(name: str) -> str:
    return name.replace("_lesion", "").replace("_", " ")


def class_proportions(
    per_ct: Table,
    sample_ids: Sequence[str],
    lesion_class_names: Sequence[str],
) -> Dict[str, float]:
    """Fraction of samples positive for each lesion class (+ 'healthy')."""
    if "BDMAP ID" in per_ct:
        per_ct = per_ct.rename({"BDMAP ID": "BDMAP_ID"})
    rows = per_ct.filter(per_ct["BDMAP_ID"].isin(set(sample_ids)))
    total = max(len(rows), 1)
    props: Dict[str, float] = {}
    pos_any = np.zeros(len(rows), bool)
    for cls in lesion_class_names:
        col = f"number of {lesion_class_to_organ(cls)} lesion instances"
        if col not in rows:
            props[cls] = 0.0
            continue
        pos = np.array([(0.0 if math.isnan(x) else x) >= 1
                        for x in rows[col].to_numeric()], bool)
        props[cls] = float(pos.sum()) / total
        pos_any |= pos
    props["healthy"] = float((~pos_any).sum()) / total
    return props


def sample_class_weights(
    labels: np.ndarray,
    proportions: Dict[str, float],
    class_names: Sequence[str],
    eps: float = 1e-4,
) -> np.ndarray:
    """Inverse-prevalence weight per class for ONE sample's labels
    (C, D, H, W), normalised to sum to C."""
    weights = []
    for i, c in enumerate(class_names):
        if c in proportions:
            p = proportions[c]
            positive = labels[i].sum() > 0
            weights.append(1.0 / (eps + (p if positive else 1.0 - p)))
        else:
            weights.append(1.0)
    w = np.asarray(weights, np.float32)
    return w / w.sum() * len(class_names)
