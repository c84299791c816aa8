"""nnU-Net dataset preparation (counterpart of
``rsuper_tpu/organ_masks/dataset_prep.py``): the reference's
``verify_data.py`` (CT and mask shapes agree), ``Dataset300_smallAtlas.py``
(the ``dataset.json``) and ``copy_dataset.py``/``symlink.py`` (the
``<case>_0000.nii.gz`` layout). The nnU-Net inference stays an external
step (``organ_masks/predict_suborgans.py``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..data.nifti import read_nifti


def verify_data(images_dir: str, labels_dir: str) -> List[str]:
    """Return case ids whose CT and label shapes disagree (reference
    ``verify_data.py``)."""
    bad = []
    for f in sorted(os.listdir(labels_dir)):
        if not f.endswith((".nii", ".nii.gz")):
            continue
        case = f.split(".nii")[0]
        img_path = None
        for cand in (f, case + "_0000.nii.gz", case + "_0000.nii"):
            p = os.path.join(images_dir, cand)
            if os.path.exists(p):
                img_path = p
                break
        if img_path is None:
            bad.append(case + " (missing image)")
            continue
        img = read_nifti(img_path)
        lab = read_nifti(os.path.join(labels_dir, f))
        if img.data.shape != lab.data.shape:
            bad.append(f"{case} (image {img.data.shape} vs label {lab.data.shape})")
    return bad


def make_dataset_json(
    out_path: str,
    labels: Dict[str, int],
    num_training: int,
    channel_names: Optional[Dict[str, str]] = None,
    file_ending: str = ".nii.gz",
) -> dict:
    """nnU-Net v2 dataset.json (reference ``Dataset300_smallAtlas.py``)."""
    spec = {
        "channel_names": channel_names or {"0": "CT"},
        "labels": labels,
        "numTraining": num_training,
        "file_ending": file_ending,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(spec, f, indent=2)
    return spec


def link_cases(
    src_images: str, dst_images: str, suffix: str = "_0000", copy: bool = False
) -> int:
    """Symlink (or copy) CTs into nnU-Net's ``<case>_0000.nii.gz`` layout."""
    import shutil

    os.makedirs(dst_images, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(src_images)):
        if not f.endswith((".nii", ".nii.gz")):
            continue
        case = f.split(".nii")[0]
        ext = ".nii.gz" if f.endswith(".nii.gz") else ".nii"
        dst = os.path.join(dst_images, f"{case}{suffix}{ext}")
        if os.path.exists(dst):
            continue
        src = os.path.abspath(os.path.join(src_images, f))
        if copy:
            shutil.copy(src, dst)
        else:
            os.symlink(src, dst)
        n += 1
    return n
