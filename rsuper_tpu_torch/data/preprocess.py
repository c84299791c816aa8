"""Offline preprocessing, NIfTI → training-ready arrays (the port's own copy
of ``rsuper_tpu/data/preprocess.py``): resample to 1 mm³ (cubic spline for
the image, nearest for labels; orders 0 and 1 through the native host
library where it is built), clip HU to [-991, 500] and z-score, pad to a
minimum size, and write one compressed ``.npz`` per case: ``image``
float32 (x, y, z), ``labels`` packed bits over the class axis, and the
spacing and class metadata in a ``.json`` beside it."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
from scipy import ndimage as ndi

from .nifti import as_canonical, read_nifti

HU_CLIP = (-991.0, 500.0)


def resample_to_spacing(
    data: np.ndarray,
    spacing: Sequence[float],
    new_spacing=(1.0, 1.0, 1.0),
    order: int = 3,
) -> np.ndarray:
    """Resample a volume from `spacing` to `new_spacing` (mm). order=0 for
    labels. Orders 0 and 1 use the native kernels where the library is
    built; cubic stays on scipy."""
    zoom = np.asarray(spacing, np.float64) / np.asarray(new_spacing, np.float64)
    if np.allclose(zoom, 1.0, atol=1e-3):
        return data
    if order in (0, 1):
        from . import native_io

        out_shape = tuple(int(round(s * z)) for s, z in zip(data.shape, zoom))
        native = native_io.resample(data, out_shape, order=order)
        if native is not None:
            return native
    return ndi.zoom(data, zoom, order=order, mode="nearest", grid_mode=False)


def clip_and_normalize(image: np.ndarray, clip=HU_CLIP) -> np.ndarray:
    """Clip HU and z-score."""
    img = np.clip(image.astype(np.float32), clip[0], clip[1])
    mean = img.mean()
    std = img.std()
    return (img - mean) / max(std, 1e-8)


def pad_to_min_size(arr: np.ndarray, min_size: Sequence[int],
                    value=0.0) -> np.ndarray:
    """Zero-pad trailing spatial axes up to `min_size` (all at the end)."""
    spatial = arr.shape[-3:]
    pads = [(0, 0)] * (arr.ndim - 3) + [
        (0, max(0, m - s)) for s, m in zip(spatial, min_size)
    ]
    if not any(p[1] for p in pads):
        return arr
    return np.pad(arr, pads, mode="constant", constant_values=value)


def preprocess_case(
    image_path: str,
    label_paths: Optional[Dict[str, str]],
    out_path: str,
    classes: Optional[Sequence[str]] = None,
    min_size=(128, 128, 128),
    new_spacing=(1.0, 1.0, 1.0),
) -> Dict:
    """Convert one CT (+ per-organ binary label NIfTIs) into a training npz.

    `label_paths`: {class_name: nii path}; missing organs become zero
    channels. `classes` fixes the channel order (sorted class names);
    defaults to the sorted keys.
    """
    img = as_canonical(read_nifti(image_path, dtype=np.float32))
    spacing = img.spacing
    image = resample_to_spacing(img.data, spacing, new_spacing, order=3)
    image = clip_and_normalize(image)
    image = pad_to_min_size(image, min_size)

    labels_arr = None
    if label_paths is not None:
        if classes is None:
            classes = sorted(label_paths)
        chans = []
        for cls in classes:
            p = label_paths.get(cls)
            if p is None or not os.path.exists(p):
                chans.append(np.zeros(image.shape, np.uint8))
                continue
            lab = as_canonical(read_nifti(p))
            arr = resample_to_spacing(
                (lab.data > 0).astype(np.uint8), lab.spacing, new_spacing,
                order=0)
            chans.append(pad_to_min_size(arr, min_size).astype(np.uint8))
        labels_arr = np.stack(chans, axis=0)
        # background = no other label
        if "background" in classes and label_paths.get("background") is None:
            bi = list(classes).index("background")
            others = np.delete(labels_arr, bi, axis=0)
            labels_arr[bi] = (others.sum(0) == 0).astype(np.uint8)

    out = {"image": image.astype(np.float32)}
    meta = {
        "orig_spacing": [float(s) for s in spacing],
        "spacing": list(new_spacing),
        "shape": list(image.shape),
    }
    if labels_arr is not None:
        out["labels"] = np.packbits(labels_arr.astype(bool), axis=0)
        out["num_classes"] = np.asarray(len(classes))
        meta["classes"] = list(classes)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **out)
    with open(os.path.splitext(out_path)[0] + ".json", "w") as f:
        json.dump(meta, f)
    return meta


def load_case(npz_path: str, num_classes: Optional[int] = None):
    """Load a preprocessed case → (image f32 (x, y, z), labels uint8
    (C, x, y, z) unpacked from the packed-bit planes, or None)."""
    with np.load(npz_path) as z:
        image = z["image"]
        labels = None
        if "labels" in z:
            n = int(z["num_classes"]) if "num_classes" in z else num_classes
            labels = np.unpackbits(z["labels"], axis=0)[:n]
    return image, labels
