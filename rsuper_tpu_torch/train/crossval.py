"""Cross-validation aggregation: per-fold results → mean±std summary (the
port's own copy of ``rsuper_tpu/train/crossval.py``; its files are
byte-equal to the JAX package's for the same results).

Reference contract (``rsuper_train/train_ddp.py:751-779``): after each fold
trains, its per-class validation metrics are persisted; once every fold of
the k-fold experiment has results, a ``cross_validation.txt`` with per-class
mean±std Dice/ASD/HD95 (and the overall means) is written next to the fold
directories.

Layout here: fold ``i`` of experiment ``name`` trains into
``<cp_path>/<name>_fold<i>/`` and writes ``fold_results.json``; the summary
lands at ``<cp_path>/<name>_cross_validation.txt`` whenever the last fold
completes (any fold order — each fold attempts the summary, the one that
finds all k files writes it).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

_METRICS = ("dice", "asd", "hd95")


def fold_dir_name(base_name: str, fold: int) -> str:
    return f"{base_name}_fold{fold}"


def write_fold_results(exp_dir: str, fold: int, k_fold: int,
                       classes: Sequence[str], results: dict) -> str:
    """Persist one fold's per-class validation metrics as JSON."""
    payload = {
        "fold": int(fold),
        "k_fold": int(k_fold),
        "classes": list(classes),
    }
    for m in _METRICS:
        if m in results:
            payload[m] = [float(v) for v in np.asarray(results[m])]
    path = os.path.join(exp_dir, "fold_results.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def summarize_cross_validation(cp_path: str, base_name: str, k_fold: int,
                               classes: Sequence[str]) -> Optional[str]:
    """If every fold has results, write ``<base_name>_cross_validation.txt``
    (per-class mean±std over folds) and return its path; else None."""
    folds = []
    for i in range(k_fold):
        p = os.path.join(cp_path, fold_dir_name(base_name, i),
                         "fold_results.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            folds.append(json.load(f))

    lines = [f"{k_fold}-fold cross validation — {base_name}", ""]
    metrics = [m for m in _METRICS if all(m in fr for fr in folds)]
    width = max(len(c) for c in classes) + 2
    header = "class".ljust(width) + "".join(
        f"{m + ' mean±std':>22}" for m in metrics
    )
    lines.append(header)
    per_metric_all = {m: [] for m in metrics}
    for ci, cls in enumerate(classes):
        row = cls.ljust(width)
        for m in metrics:
            vals = np.array([fr[m][ci] for fr in folds], np.float64)
            per_metric_all[m].append(vals)
            row += f"{vals.mean():>12.4f}±{vals.std():<9.4f}"
        lines.append(row)
    lines.append("")
    row = "mean".ljust(width)
    for m in metrics:
        allv = np.stack(per_metric_all[m])  # (C, k)
        row += f"{allv.mean():>12.4f}±{allv.mean(axis=0).std():<9.4f}"
    lines.append(row)

    out = os.path.join(cp_path, f"{base_name}_cross_validation.txt")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out
