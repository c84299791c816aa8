"""Organ-mask label maps (counterpart of ``rsuper_tpu/organ_masks/labels.py``).

Numpy versions of the reference's ``organ_masks`` tools:
* ``split_labels.py``: the 35-label sub-segment integer map of the nnU-Net
  OrganSubSegmenter, split into one binary mask an organ plus the merged
  liver and pancreas;
* ``combine_labels.py``: the region-based integer map (with lesion ∩
  sub-segment overlap classes) that nnU-Net was trained on.

The nnU-Net inference itself (``organ_masks/predict_suborgans.py``) needs
``nnunetv2`` and the published checkpoint; this module is everything
downstream of the integer map.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# sub-segmenter output integer map (reference split_labels.py:15-52)
SUBSEG_LABELS: Dict[str, int] = {
    "background": 0, "aorta": 1, "gall_bladder": 2, "kidney_left": 3,
    "kidney_right": 4, "postcava": 5, "spleen": 6, "stomach": 7,
    "adrenal_gland_left": 8, "adrenal_gland_right": 9, "bladder": 10,
    "celiac_trunk": 11, "colon": 12, "duodenum": 13, "esophagus": 14,
    "femur_left": 15, "femur_right": 16, "hepatic_vessel": 17, "intestine": 18,
    "lung_left": 19, "lung_right": 20, "portal_vein_and_splenic_vein": 21,
    "prostate": 22, "rectum": 23,
    **{f"liver_segment_{i}": 23 + i for i in range(1, 9)},
    "pancreas_head": 32, "pancreas_body": 33, "pancreas_tail": 34,
}

MERGED_ORGANS = {
    "liver": [f"liver_segment_{i}" for i in range(1, 9)],
    "pancreas": ["pancreas_head", "pancreas_body", "pancreas_tail"],
}

# region-based training map with lesion-overlap classes
# (reference combine_labels.py:17-60, truncated to the classes that matter
# for mask reconstruction; overlap classes X_Y mean lesion X inside organ Y)
REGION_LABELS: Dict[str, int] = {
    "background": 0, "kidney_right": 1, "kidney_left": 2, "kidney_lesion": 3,
    "kidney_lesion_kidney_right": 4, "kidney_lesion_kidney_left": 5,
    "pancreas": 6, "pancreas_head": 7, "pancreas_body": 8, "pancreas_tail": 9,
    "pancreatic_lesion": 10, "pancreatic_lesion_pancreas_head": 11,
    "pancreatic_lesion_pancreas_body": 12, "pancreatic_lesion_pancreas_tail": 13,
    "liver": 14, **{f"liver_segment_{i}": 14 + i for i in range(1, 9)},
    "liver_lesion": 23,
    **{f"liver_lesion_liver_segment_{i}": 23 + i for i in range(1, 9)},
    "spleen": 32, "colon": 33, "stomach": 34, "duodenum": 35,
    "common_bile_duct": 36, "intestine": 37, "aorta": 38, "postcava": 39,
    "adrenal_gland_left": 40, "adrenal_gland_right": 41, "gall_bladder": 42,
    "bladder": 43, "celiac_trunk": 44, "esophagus": 45, "hepatic_vessel": 46,
    "portal_vein_and_splenic_vein": 47, "lung_left": 48, "lung_right": 49,
}


def split_label_map(
    int_map: np.ndarray,
    labels: Dict[str, int] = SUBSEG_LABELS,
    include_merged: bool = True,
) -> Dict[str, np.ndarray]:
    """Integer map → {organ: binary mask} (+ liver/pancreas unions).

    Reference ``split_labels.py``: one binary file per organ, plus merged
    whole-organ masks for sub-segmented organs.
    """
    out = {}
    for name, idx in labels.items():
        if name == "background":
            continue
        out[name] = (int_map == idx).astype(np.uint8)
    if include_merged:
        for organ, parts in MERGED_ORGANS.items():
            acc = np.zeros(int_map.shape, np.uint8)
            for p in parts:
                if p in out:
                    acc |= out[p]
            out[organ] = acc
    return out


def merged_organ(masks: Dict[str, np.ndarray], organ: str) -> np.ndarray:
    parts = MERGED_ORGANS.get(organ, [organ])
    acc = None
    for p in parts:
        m = (masks[p] > 0).astype(np.uint8)
        acc = m if acc is None else (acc | m)
    return acc


def combine_label_maps(
    masks: Dict[str, np.ndarray],
    labels: Dict[str, int] = REGION_LABELS,
) -> np.ndarray:
    """Per-organ binary masks → region-based integer map with lesion-overlap
    classes (reference ``combine_labels.py``). Later entries overwrite earlier
    ones; lesion∩sub-segment overlap classes are synthesised from the pairs
    named ``<lesion>_<segment>`` in `labels`."""
    shape = next(iter(masks.values())).shape
    out = np.zeros(shape, np.int16)
    # plain classes in index order
    for name, idx in sorted(labels.items(), key=lambda kv: kv[1]):
        if name == "background":
            continue
        base = masks.get(name)
        if base is not None:
            out[base > 0] = idx
            continue
        # overlap class "X_lesion_<organpart>"?
        for lesion in ("kidney_lesion", "pancreatic_lesion", "liver_lesion"):
            prefix = lesion + "_"
            if name.startswith(prefix):
                seg = name[len(prefix):]
                if lesion in masks and seg in masks:
                    overlap = (masks[lesion] > 0) & (masks[seg] > 0)
                    out[overlap] = idx
                break
    return out
