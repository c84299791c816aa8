"""Detection evaluation on the host: lesion volumes from predicted
probability maps, and Sens/Spec/F1/AUROC against report ground truth (the
port's counterpart of ``rsuper_tpu/eval``)."""

from .detection import detect_volumes, detection_table
from .sens_spec import evaluate_detection, sensitivity_specificity_f1, prob_auc

__all__ = [
    "detect_volumes",
    "detection_table",
    "evaluate_detection",
    "sensitivity_specificity_f1",
    "prob_auc",
]
