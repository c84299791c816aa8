"""The baselines of the reference (counterpart of
``rsuper_tpu/baselines/``): Model-Genesis restoration pairs and
report-guided pseudo-labels, host-side numpy."""

from .model_genesis import generate_restoration_pair
from .pseudo_labels import extract_lesion_candidates, refine_with_report

__all__ = [
    "generate_restoration_pair",
    "extract_lesion_candidates",
    "refine_with_report",
]
