"""In-training validation: sliding-window inference per test case, Dice and
surface distances per class, or on the 2D pathway slice-wise inference and
the volumetric Dice (the port's counterpart of
``rsuper_tpu/train/validation.py``).

Reference: ``rsuper_train/training/validation.py`` (threshold 0.5 on
multi-label sigmoids, ASD/HD95 with NaN→500 clamp, per-class means over the
cases that contain the class). The probabilities are blended on the device
and leave it as float16, as the JAX call leaves them by default, so the
threshold is taken on the same float16 values; the 2D pathway's leave it
as float32, as the JAX package's 2D function returns them.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..inference.sliding_window import sliding_window_inference
from ..inference.sliding_window2d import sliding_window_inference_2d
from ..metrics import asd_hd95, dice_score
from ..utils.profiling import PhaseTimer


def validation_model(model: torch.nn.Module) -> torch.nn.Module:
    """The one model instance a run keeps for validation: a copy of
    `model`'s modules, without gradients, in eval mode. ``run_validation``
    loads the weights it evaluates into it, so the training model's
    parameters are never written."""
    val = copy.deepcopy(model).eval()
    for p in val.parameters():
        p.grad = None
        p.requires_grad_(False)
    return val


def head_fn(model: torch.nn.Module):
    """(K, *window, 1) windows → the final head's (K, *window, C) logits
    (``out[0]`` of a deep-supervised ``"segmentation"``)."""

    def fn(x):
        out = model(x)["segmentation"]
        return out[0] if isinstance(out, (list, tuple)) else out

    return fn


def validate_cases(
    model_fn,
    cases,  # iterable of (image (D,H,W), labels (C,D,H,W))
    num_classes: int,
    window=(128, 128, 128),
    batch: int = 4,
    device="cuda",
    timer: Optional[PhaseTimer] = None,
) -> Dict[str, np.ndarray]:
    """Per-class mean dice/asd/hd95 over the cases where the class exists.
    `model_fn` maps windows to logits on `device`. With `timer`, each case
    adds its sliding window (device work, waited for) as ``val_window`` and
    its metrics on the host as ``val_metrics``."""
    timer = timer or PhaseTimer()
    dices = np.zeros(num_classes)
    asds = np.zeros(num_classes)
    hds = np.zeros(num_classes)
    counts = np.zeros(num_classes)

    def class_metrics(pred_c, target):
        return (dice_score(pred_c, target),) + asd_hd95(pred_c, target)

    # the classes of a case are measured in threads: the EDTs release the
    # interpreter lock, and each class keeps its own sums, so the floats are
    # those of a loop over the classes
    workers = max(1, min(num_classes, os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        for image, labels in cases:
            with timer.phase("val_window"):
                probs = sliding_window_inference(
                    model_fn, image, num_classes, window=window, batch=batch,
                    device=device)
            with timer.phase("val_metrics"):
                pred = probs > 0.5
                targets = {c: labels[c] > 0 for c in range(num_classes)}
                present = [c for c, t in targets.items() if t.any()]
                futures = [pool.submit(class_metrics, pred[..., c],
                                       targets[c]) for c in present]
                for c, fut in zip(present, futures):
                    d, asd, hd = fut.result()
                    counts[c] += 1
                    dices[c] += d
                    asds[c] += asd
                    hds[c] += hd

    denom = np.maximum(counts, 1)
    return {
        "dice": dices / denom,
        "asd": asds / denom,
        "hd95": hds / denom,
        "cases_per_class": counts,
    }


def validate_cases_2d(
    model_fn,
    cases,  # iterable of (image (D,H,W), labels (C,D,H,W))
    num_classes: int,
    window=(256, 256),
    threshold: float = 0.5,
    batch: int = 8,
    device="cuda",
    timer: Optional[PhaseTimer] = None,
) -> Dict[str, np.ndarray]:
    """The 2D pathway's validation: slice-wise sliding-window inference
    (``sliding_window_inference_2d``) stacked back into the volume, then
    the volumetric Dice per class over the cases that contain it (the
    reference's 2D mode evaluates the same way). With `timer`, each case
    adds its inference as ``val_window`` and its metrics as
    ``val_metrics``."""
    timer = timer or PhaseTimer()
    dices = np.zeros(num_classes)
    counts = np.zeros(num_classes)
    for image, labels in cases:
        with timer.phase("val_window"):
            probs = sliding_window_inference_2d(
                model_fn, image, num_classes, window=window, batch=batch,
                device=device)
        with timer.phase("val_metrics"):
            pred = probs > threshold
            for c in range(num_classes):
                target = labels[c] > 0
                if not target.any():
                    continue
                counts[c] += 1
                dices[c] += dice_score(pred[..., c], target)
    denom = np.maximum(counts, 1)
    return {"dice": dices / denom, "cases_per_class": counts}


def run_validation(val_model: torch.nn.Module, state, cfg, cases: Sequence,
                   num_classes: int, device="cuda",
                   timer: Optional[PhaseTimer] = None) -> Dict[str, np.ndarray]:
    """The one validation harness of the in-loop pass and the end-of-fold
    pass (the reference runs the same eval_net at ``train_ddp.py:388`` and
    ``:751``): the EMA weights when ``cfg.ema`` (else the parameters) are
    loaded into `val_model` (``validation_model``), whose final head is
    evaluated at ``cfg.training_size`` windows: 3D ones in batches of 4,
    or, on the 2D pathway (``cfg.is_2d``), the slices' windows in batches
    of 8 (``validate_cases_2d``)."""
    weights = state.ema_params if cfg.ema else dict(
        state.model.named_parameters())
    with torch.no_grad():
        val_model.load_state_dict(weights)
    validate = validate_cases_2d if cfg.is_2d else validate_cases
    return validate(head_fn(val_model), cases, num_classes,
                    window=tuple(cfg.training_size), device=device,
                    timer=timer)
