"""Sensitivity / Specificity / F1 / AUROC against report ground truth (the
port's own copy of ``rsuper_tpu/eval/sens_spec.py``, with ``data/table.py``'s
``Table`` in place of pandas and its own AUROC in place of scikit-learn's).

Reference: ``rsuper_train/calculate_sensitivity_specificity_F1_AUC.py``:
ground truth is per-CT lesion presence (``number of {organ} lesion
instances`` >= 1 from the metadata CSV); for every confidence threshold's
detection table, sweep ~300 volume thresholds and report Sens/Spec/F1 per
organ, plus a voxel-probability AUROC from the maximum probabilities.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
from scipy.stats import rankdata

from ..data.table import Column, Table, isna

ORGANS = ("liver", "pancreatic", "kidney")
VOLUME_THRESHOLDS = tuple(np.unique(np.round(np.geomspace(1, 300000, 300))))


def load_ground_truth(per_ct_csv: str,
                      organs: Sequence[str] = ORGANS) -> Table:
    """``BDMAP_ID`` and, per organ, ``gt_{organ}``: 1.0 where the CSV's
    ``number of {organ} lesion instances`` is a number >= 1, else 0.0. The
    ID column may be spelled ``BDMAP ID``."""
    gt = Table.read_csv(per_ct_csv)
    if "BDMAP ID" in gt:
        gt = gt.rename({"BDMAP ID": "BDMAP_ID"})
    cols = {"BDMAP_ID": gt["BDMAP_ID"]}
    for org in organs:
        n = gt[f"number of {org} lesion instances"].to_numeric()
        cols[f"gt_{org}"] = Column([float(v >= 1) for v in n], "float")
    return Table(cols)


def auroc(y: np.ndarray, p: np.ndarray) -> float:
    """Area under the ROC curve of scores `p` for binary labels `y` (both
    classes present): the Mann–Whitney U over n₁·n₀, ranks of tied scores
    their mean. Twice a sum of mid-ranks is an integer, so the result is one
    correctly rounded division of integers."""
    y = np.asarray(y, bool)
    n1 = int(y.sum())
    n0 = y.size - n1
    twice_rank_sum = int(round(2.0 * rankdata(p)[y].sum()))
    return (twice_rank_sum - n1 * (n1 + 1)) / (2 * n1 * n0)


def prob_auc(gt: Table, preds: Table,
             organs: Sequence[str] = ORGANS) -> Dict[str, float]:
    """Per organ, the AUROC of the maximum lesion probability against the
    ground truth over the cases in both tables with both cells present; NaN
    where one class alone is left."""
    merged = gt.merge(preds, on="BDMAP_ID")
    out = {}
    for org in organs:
        y = np.asarray(merged[f"gt_{org}"].to_numeric())
        p = np.asarray(merged[f"{org} tumor maximum probability"]
                       .to_numeric())
        keep = ~(np.isnan(y) | np.isnan(p))
        y, p = y[keep], p[keep]
        out[org] = (auroc(y, p) if np.unique(y).size >= 2
                    else float("nan"))
    return out


def sensitivity_specificity_f1(
    gt_bin: np.ndarray, volumes: np.ndarray, volume_threshold: float
) -> Dict[str, float]:
    pred = volumes >= volume_threshold
    gt_bin = gt_bin.astype(bool)
    tp = int(np.sum(gt_bin & pred))
    fn = int(np.sum(gt_bin & ~pred))
    fp = int(np.sum(~gt_bin & pred))
    tn = int(np.sum(~gt_bin & ~pred))
    sens = tp / (tp + fn) if tp + fn else float("nan")
    spec = tn / (tn + fp) if tn + fp else float("nan")
    f1 = 2 * tp / (2 * tp + fp + fn) if 2 * tp + fp + fn else float("nan")
    return {"sens": sens, "spec": spec, "f1": f1, "tp": tp, "fp": fp,
            "fn": fn, "tn": tn}


def evaluate_detection(
    gt: Table,
    detection_tables: Dict[float, Table],
    organs: Sequence[str] = ORGANS,
    volume_thresholds: Sequence[float] = VOLUME_THRESHOLDS,
) -> Dict[float, Table]:
    """Per confidence threshold: a table over volume thresholds with
    Sens/Spec/F1 per organ (+ the scalar probability AUROC)."""
    first = detection_tables[min(detection_tables)]
    aucs = prob_auc(gt, first, organs)
    out = {}
    for conf, preds in detection_tables.items():
        merged = gt.merge(preds, on="BDMAP_ID")
        vols = {org: np.nan_to_num(np.asarray(
            merged[f"{org} tumor volume predicted"].to_numeric()), nan=0.0)
            for org in organs}
        gts = {org: np.asarray(merged[f"gt_{org}"].values, np.float64)
               for org in organs}
        rows = []
        for vthr in volume_thresholds:
            row = {"threshold": float(vthr)}
            for org in organs:
                m = sensitivity_specificity_f1(gts[org], vols[org], vthr)
                row[f"{org}_sens"] = m["sens"]
                row[f"{org}_spec"] = m["spec"]
                row[f"{org}_f1"] = m["f1"]
                row[f"{org}_auc_prob"] = aucs[org]
            rows.append(row)
        out[conf] = Table.from_rows(rows)
    return out


def best_f1(evaluated: Dict[float, Table],
            organ: str = "pancreatic") -> Dict[str, float]:
    """Best F1 (and its operating point) across confidence × volume sweeps:
    the first row of each sweep's largest F1; a sweep whose F1 is missing
    throughout is passed over."""
    best = {"f1": -1.0, "conf": None, "volume_threshold": None}
    for conf, df in evaluated.items():
        f1s = df[f"{organ}_f1"].values
        valid = [i for i, v in enumerate(f1s) if not isna(v)]
        if not valid:
            continue
        idx = max(valid, key=lambda i: (f1s[i], -i))
        if f1s[idx] > best["f1"]:
            best = {"f1": float(f1s[idx]), "conf": conf,
                    "volume_threshold": float(df["threshold"].values[idx])}
    return best
