"""Detection-volume extraction from predicted lesion probability maps (the
port's own copy of ``rsuper_tpu/eval/detection.py``; ``data/table.py``'s
``Table`` in place of the pandas DataFrame).

Reference: ``rsuper_train/eval_AUC.py`` — per case and lesion channel: load
the probability map, resample to 1 mm³, then for 9 confidence thresholds
binarize, denoise with erosion(3³)×1 + dilation×2 ANDed with the original,
and record the surviving volume (+ the map's maximum probability). The
resulting per-case table feeds the Sens/Spec/F1/AUC sweep.

Embarrassingly parallel across cases (the reference uses a ProcessPool +
FileLock CSV appends; here a plain function → table, shardable by
``parts``/``part``). Host only: numpy and scipy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
from scipy import ndimage as ndi

from ..data.nifti import read_nifti
from ..data.preprocess import resample_to_spacing
from ..data.table import Table

THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
ORGANS = ("liver", "pancreatic", "kidney")


def detect_volumes(
    prob_map: np.ndarray,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    thresholds: Sequence[float] = THRESHOLDS,
    erode: bool = True,
) -> Dict:
    """Denoised tumor volume (voxels at 1 mm³) per confidence threshold +
    maximum probability."""
    arr = prob_map.astype(np.float32)
    if tuple(np.round(spacing, 3)) != (1.0, 1.0, 1.0):
        arr = resample_to_spacing(arr, spacing, (1.0, 1.0, 1.0), order=1)
    max_prob = float(arr.max()) if arr.size else 0.0
    volumes = {}
    cube = np.ones((3, 3, 3), bool)
    for th in thresholds:
        m = arr > th
        if erode and m.any():
            d = ndi.binary_erosion(m, structure=cube, iterations=1)
            d = ndi.binary_dilation(d, structure=cube, iterations=2)
            m = d & m
        volumes[th] = int(m.sum())
    return {"volumes": volumes, "max_prob": max_prob}


def detect_volume_from_mask(
    mask: np.ndarray,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    erode: bool = True,
) -> int:
    """Denoised volume of an already-binarised lesion mask — the fixed-0.5
    variant used by the reference's ``test_with_reports.py`` /
    ``calculate_sensitivity_specificity.py``."""
    det = detect_volumes(mask.astype(np.float32), spacing, thresholds=(0.5,),
                         erode=erode)
    return det["volumes"][0.5]


def detection_table_from_masks(
    outputs_dir: str,
    organs: Sequence[str] = ORGANS,
    parts: int = 1,
    part: int = 0,
) -> Table:
    """Per-case volumes from binary prediction masks
    (``<case>/<organ>_lesion.nii.gz``, the `predict_folder` layout)."""
    cases = sorted(
        d for d in os.listdir(outputs_dir)
        if os.path.isdir(os.path.join(outputs_dir, d))
    )[part::parts]
    rows = []
    for case in cases:
        row = {"BDMAP_ID": case}
        for organ in organs:
            path = os.path.join(outputs_dir, case, f"{organ}_lesion.nii.gz")
            if not os.path.exists(path):
                row[f"{organ} tumor volume predicted"] = np.nan
                continue
            img = read_nifti(path)
            row[f"{organ} tumor volume predicted"] = detect_volume_from_mask(
                img.data, img.spacing
            )
        rows.append(row)
    return Table.from_rows(rows)


# nnU-Net probability-stack channel indices (reference eval_AUC_nnunet.py:16)
NNUNET_TUMOUR_CH = {"liver": 8, "pancreatic": 7, "kidney": 2}


def detection_table_nnunet(
    outputs_folder: str,
    thresholds: Sequence[float] = THRESHOLDS,
    channel_map: Dict[str, int] = None,
    parts: int = 1,
    part: int = 0,
    case_ids: Sequence[str] = None,
) -> Dict[float, Table]:
    """Detection volumes from nnU-Net prediction folders: flat
    ``BDMAP_*.npz`` files whose ``probabilities`` array is a (C, D, H, W)
    stack with fixed tumor channels. Unlike `detection_table`, volumes are
    plain ``(prob >= th).sum()`` — no denoising or resampling (matches
    ``rsuper_train/eval_AUC_nnunet.py:31-50``)."""
    channel_map = channel_map or NNUNET_TUMOUR_CH
    files = sorted(
        f for f in os.listdir(outputs_folder)
        if f.endswith(".npz")
    )[part::parts]
    if case_ids is not None:
        keep = set(case_ids)
        files = [f for f in files if os.path.splitext(f)[0] in keep]
    rows: Dict[float, List[dict]] = {th: [] for th in thresholds}
    for fname in files:
        case = os.path.splitext(fname)[0]
        probs = np.load(os.path.join(outputs_folder, fname))["probabilities"]
        rec: Dict[float, dict] = {th: {"BDMAP_ID": case} for th in thresholds}
        for organ, ch in channel_map.items():
            prob = probs[ch]
            max_p = float(prob.max()) if prob.size else 0.0
            for th in thresholds:
                rec[th][f"{organ} tumor volume predicted"] = int((prob >= th).sum())
                rec[th][f"{organ} tumor maximum probability"] = max_p
        for th in thresholds:
            rows[th].append(rec[th])
    return {th: Table.from_rows(r) for th, r in rows.items()}


def detection_table(
    outputs_dir: str,
    thresholds: Sequence[float] = THRESHOLDS,
    organs: Sequence[str] = ORGANS,
    parts: int = 1,
    part: int = 0,
) -> Dict[float, Table]:
    """Scan a prediction folder (``<case>/<organ>_lesion_prob.nii.gz`` files,
    the `predict_folder` layout) into one table per confidence threshold
    with columns ``BDMAP_ID``, ``{organ} tumor volume predicted``,
    ``{organ} tumor maximum probability``."""
    cases = sorted(
        d for d in os.listdir(outputs_dir)
        if os.path.isdir(os.path.join(outputs_dir, d))
    )[part::parts]
    rows: Dict[float, List[dict]] = {th: [] for th in thresholds}
    for case in cases:
        rec: Dict[float, dict] = {th: {"BDMAP_ID": case} for th in thresholds}
        for organ in organs:
            name = f"{organ}_lesion_prob.nii.gz"
            path = os.path.join(outputs_dir, case, name)
            if not os.path.exists(path):
                for th in thresholds:
                    rec[th][f"{organ} tumor volume predicted"] = np.nan
                    rec[th][f"{organ} tumor maximum probability"] = np.nan
                continue
            img = read_nifti(path, dtype=np.float32)
            det = detect_volumes(img.data, img.spacing, thresholds)
            for th in thresholds:
                rec[th][f"{organ} tumor volume predicted"] = det["volumes"][th]
                rec[th][f"{organ} tumor maximum probability"] = det["max_prob"]
        for th in thresholds:
            rows[th].append(rec[th])
    return {th: Table.from_rows(r) for th, r in rows.items()}


def write_detection_parts(out_dir: str, tables: Dict[float, Table],
                          parts: int, part: int) -> None:
    """Persist one part's per-threshold tables as atomic part files
    (``tumor_detection_results_th{th}.part{part}of{parts}.csv``) — the
    lock-free analogue of the reference's FileLock CSV appends
    (``eval_AUC.py:12-30,321``)."""
    for th, df in tables.items():
        path = os.path.join(
            out_dir, f"tumor_detection_results_th{th}.part{part}of{parts}.csv"
        )
        tmp = path + ".tmp"
        df.to_csv(tmp)
        os.replace(tmp, path)


def merge_detection_parts(out_dir: str, parts: int):
    """If every part file of every threshold exists, concatenate them
    (sorted, de-duplicated by BDMAP_ID) into the canonical
    ``tumor_detection_results_th{th}.csv`` files and return the merged
    table dict; else return None (some part still running)."""
    merged: Dict[float, Table] = {}
    for th in THRESHOLDS:
        frames = []
        for part in range(parts):
            path = os.path.join(
                out_dir,
                f"tumor_detection_results_th{th}.part{part}of{parts}.csv",
            )
            if not os.path.exists(path):
                return None
            frames.append(Table.read_csv(path))
        merged[th] = (Table.concat(frames)
                      .drop_duplicates(subset="BDMAP_ID")
                      .sort_values("BDMAP_ID"))
    for th, df in merged.items():
        # two parts can finish near-simultaneously and both reach the merge;
        # a pid-unique tmp + os.replace keeps the canonical file complete at
        # all times (both writers produce identical content — last wins)
        path = os.path.join(out_dir, f"tumor_detection_results_th{th}.csv")
        tmp = f"{path}.tmp.{os.getpid()}"
        df.to_csv(tmp)
        os.replace(tmp, path)
    return merged
