"""Canonical class lists (the port's own copy of
``rsuper_tpu/config/label_names.py``).

The mask dataset's 26 classes include ``pancreatic_lesion``; the report
dataset's 39 organ classes have no lesion class (``RSuperDataConfig``
enforces it). Class lists are always consumed sorted.
"""

MASK_DATASET_PANCREAS_CLASSES = sorted([
    "aorta", "adrenal_gland_left", "adrenal_gland_right", "bladder",
    "celiac_trunk", "colon", "duodenum", "esophagus", "gall_bladder",
    "hepatic_vessel", "intestine", "kidney_left", "kidney_right", "liver",
    "lung_left", "lung_right", "pancreas", "pancreas_body", "pancreas_head",
    "pancreas_tail", "pancreatic_lesion", "portal_vein_and_splenic_vein",
    "postcava", "prostate", "spleen", "stomach",
])

REPORT_DATASET_CLASSES = sorted([
    "aorta", "adrenal_gland_left", "adrenal_gland_right", "bladder",
    "celiac_trunk", "colon", "duodenum", "esophagus", "femur_left",
    "femur_right", "gall_bladder", "hepatic_vessel", "intestine",
    "kidney_left", "kidney_right",
    *[f"liver_segment_{i}" for i in range(1, 9)],
    "lung_left", "lung_right", "pancreas_body", "pancreas_head",
    "pancreas_tail", "portal_vein_and_splenic_vein", "postcava", "prostate",
    "rectum", "spleen", "stomach",
])

# joint training list: report classes + whole organs + lesion channels
JOINT_CLASSES = sorted(set(REPORT_DATASET_CLASSES) | {
    "liver", "pancreas", "kidney_lesion", "liver_lesion", "pancreatic_lesion",
})
