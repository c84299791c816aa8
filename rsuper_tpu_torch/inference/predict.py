"""Batch prediction: preprocessing → sliding window → organ-gated
post-processing (counterpart of ``rsuper_tpu/inference/predict.py``).

The default path thresholds, gates each lesion channel by its dilated organ
mask and bit-packs the masks on the device, so only packed uint8 words (and,
on request, a few lesion probability channels) leave it.
"""

from __future__ import annotations

import os
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from scipy import ndimage as ndi

from ..data.nifti import as_canonical, read_nifti, write_nifti
from ..data.preprocess import (clip_and_normalize, pad_to_min_size,
                               resample_to_spacing)
from ..ops.morphology import dilate_cube_cf
from ..utils.device import resolve_device
from .sliding_window import (sliding_window_inference,
                             sliding_window_probs_device)

Z_CHUNK = 800  # z-chunking for scans of more than 800 slices

# u8 → f16 probability restore table
_U8_PROB_LUT = (np.arange(256, dtype=np.float32) / 255.0).astype(np.float16)

_PAIRS = {
    "kidney": ("kidney_right", "kidney_left"),
    "adrenal": ("adrenal_gland_right", "adrenal_gland_left"),
    "lung": ("lung_right", "lung_left"),
}


def keep_largest_component(mask: np.ndarray) -> np.ndarray:
    lab, n = ndi.label(mask > 0)
    if n <= 1:
        return (mask > 0).astype(np.uint8)
    counts = np.bincount(lab.ravel())
    counts[0] = 0
    return (lab == int(np.argmax(counts))).astype(np.uint8)


def postprocess_prediction(
    probs: np.ndarray,
    classes: Sequence[str],
    threshold: float = 0.5,
    connected_components: bool = False,
) -> Dict[str, np.ndarray]:
    """Host post-processing of the ungated path (``organ_mask_on_lesion``
    off): probs (D, H, W, C) → {class: binary mask}, optionally keeping the
    largest component of each lesion mask."""
    masks: Dict[str, np.ndarray] = {}
    for i, cls in enumerate(classes):
        m = (probs[..., i] > threshold).astype(np.uint8)
        if connected_components and "lesion" in cls:
            m = keep_largest_component(m)
        masks[cls] = m
    return masks


def _lesion_routing(classes: Sequence[str]) -> Dict[int, Optional[tuple]]:
    """Lesion → organ routing by channel index (paired organs merged, uterus
    → prostate): lesion channel → tuple of organ channels whose union gates
    it; None = no gating; () = all-ones (bone/breast, effectively
    ungated)."""
    idx = {c: i for i, c in enumerate(classes)}
    routing: Dict[int, Optional[tuple]] = {}
    for i, cls in enumerate(classes):
        if "lesion" not in cls:
            continue
        organ = cls.split("_")[0].replace("pancreatic", "pancreas")
        if organ in _PAIRS:
            a, b = _PAIRS[organ]
            routing[i] = (idx[a], idx[b]) if a in idx and b in idx else None
        elif organ == "uterus":
            routing[i] = (idx["prostate"],) if "prostate" in idx else None
        elif organ == "gallbladder":
            routing[i] = ((idx["gall_bladder"],) if "gall_bladder" in idx
                          else None)
        elif organ in ("bone", "breast"):
            routing[i] = ()
        else:
            routing[i] = (idx[organ],) if organ in idx else None
    return routing


def device_postprocess_packed(probs: torch.Tensor, classes: Sequence[str],
                              threshold: float = 0.5,
                              organ_dilation: int = 3) -> torch.Tensor:
    """Threshold + organ-gate on the device and bit-pack the per-class masks
    into uint8 words: (D, H, W, C) probs → (D, H, W, ceil(C/8)) uint8, on
    the probabilities' device."""
    binm = probs > threshold
    routing = _lesion_routing(classes)
    gated = []
    for i in range(len(classes)):
        m = binm[..., i]
        organs = routing.get(i, None)
        if i in routing and organs:
            u = torch.zeros(probs.shape[:3], dtype=torch.float32,
                            device=probs.device)
            for oi in organs:
                u = torch.maximum(u, binm[..., oi].float())
            # `dil` iterations of a 3³ cube = one (2·dil+1)³ cube
            u = dilate_cube_cf(u, 2 * organ_dilation + 1)
            m = m & (u > 0)
        gated.append(m)
    out = torch.stack(gated, dim=-1)
    words = []
    for s in range(0, len(classes), 8):
        chunk = out[..., s:s + 8].to(torch.int32)
        pows = 2 ** torch.arange(chunk.shape[-1], dtype=torch.int32,
                                 device=probs.device)
        words.append((chunk * pows).sum(dim=-1))
    return torch.stack(words, dim=-1).to(torch.uint8)


def unpack_masks(packed: np.ndarray,
                 classes: Sequence[str]) -> Dict[str, np.ndarray]:
    """(D, H, W, ceil(C/8)) uint8 words → {class: (D, H, W) uint8 mask}."""
    masks = {}
    for i, cls in enumerate(classes):
        w, b = divmod(i, 8)
        masks[cls] = ((packed[..., w] >> b) & 1).astype(np.uint8)
    return masks


def predict_masks_volume(
    model_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
    volume: np.ndarray,
    classes: Sequence[str],
    window=(128, 128, 128),
    batch: int = 8,
    organ_mask: Optional[np.ndarray] = None,
    threshold: float = 0.5,
    organ_dilation: int = 3,
    connected_components: bool = False,
    prob_channels: Optional[Sequence[int]] = None,
    prob_wire: str = "u8",
    device="cuda",
):
    """Ensemble → threshold → organ-gate → bit-pack on the device; only
    packed masks (and the `prob_channels` probabilities, if asked for) are
    transferred. Returns `masks`, or `(masks, probs)` with probs
    (D, H, W, len(prob_channels)) float16. `prob_wire` "u8" rounds p·255 on
    the device (error ≤ 1/510); "f16" transfers half precision."""
    want_probs = prob_channels is not None
    chan = [int(c) for c in prob_channels] if want_probs else []
    if prob_wire not in ("u8", "f16"):
        raise ValueError(f"prob_wire must be 'u8' or 'f16', got {prob_wire!r}")

    def run(vol):
        acc = None
        for fn in model_fns:
            p = sliding_window_probs_device(
                fn, vol, len(classes), window=window, batch=batch,
                organ_mask=organ_mask, device=device)
            acc = p if acc is None else acc + p
        mean = acc / len(model_fns)
        packed = device_postprocess_packed(mean, classes, threshold,
                                           organ_dilation).cpu().numpy()
        if not want_probs:
            return packed, None
        psel = mean[..., chan]
        if prob_wire == "u8":
            wire = torch.round(torch.clamp(psel, 0.0, 1.0) * 255.0).to(
                torch.uint8)
            return packed, _U8_PROB_LUT[wire.cpu().numpy()]
        return packed, psel.to(torch.float16).cpu().numpy()

    D = volume.shape[0]
    if D <= Z_CHUNK:
        packed, probs = run(volume)
    else:
        halo = window[0]
        packed = probs = None
        z = 0
        while z < D:
            z1 = min(z + Z_CHUNK, D)
            lo, hi = max(0, z - halo), min(D, z1 + halo)
            chunk, pchunk = run(volume[lo:hi])
            if packed is None:
                packed = np.zeros(volume.shape + (chunk.shape[-1],), np.uint8)
                if want_probs:
                    probs = np.zeros(volume.shape + (len(chan),), np.float16)
            packed[z:z1] = chunk[z - lo: z - lo + (z1 - z)]
            if want_probs:
                probs[z:z1] = pchunk[z - lo: z - lo + (z1 - z)]
            z = z1
    masks = unpack_masks(packed, classes)
    if connected_components:
        for cls in classes:
            if "lesion" in cls:
                masks[cls] = keep_largest_component(masks[cls])
    return (masks, probs) if want_probs else masks


def predict_volume(model_fns, volume: np.ndarray, num_classes: int,
                   window=(128, 128, 128), batch: int = 8,
                   organ_mask: Optional[np.ndarray] = None,
                   device="cuda") -> np.ndarray:
    """Ensemble-averaged probabilities on host, with z-chunking."""
    def run(vol):
        acc = None
        for fn in model_fns:
            p = sliding_window_inference(
                fn, vol, num_classes, window=window, batch=batch,
                organ_mask=organ_mask, device=device)
            acc = p if acc is None else acc + p
        return acc / len(model_fns)

    D = volume.shape[0]
    if D <= Z_CHUNK:
        return run(volume)
    halo = window[0]
    probs = np.zeros(volume.shape + (num_classes,), np.float32)
    z = 0
    while z < D:
        z1 = min(z + Z_CHUNK, D)
        lo, hi = max(0, z - halo), min(D, z1 + halo)
        chunk = run(volume[lo:hi])
        probs[z:z1] = chunk[z - lo: z - lo + (z1 - z)]
        z = z1
    return probs


def preprocess_volume(path: str, min_size=(128, 128, 128)):
    """NIfTI → normalized 1 mm³ canonical volume + restore metadata."""
    img = as_canonical(read_nifti(path, dtype=np.float32))
    spacing = img.spacing
    vol = resample_to_spacing(img.data, spacing, (1.0, 1.0, 1.0), order=3)
    resampled_shape = vol.shape
    vol = clip_and_normalize(vol)
    vol = pad_to_min_size(vol, min_size)
    return vol, {
        "affine": img.affine,
        "orig_shape": img.data.shape,
        "spacing": spacing,
        "resampled_shape": resampled_shape,
        "padded_shape": vol.shape,
    }


def restore_geometry(mask: np.ndarray, meta: Dict, order: int = 0) -> np.ndarray:
    """Unpad + resample a 1 mm³ prediction back to the original voxel grid."""
    rs = meta["resampled_shape"]
    mask = mask[: rs[0], : rs[1], : rs[2]]
    out = resample_to_spacing(mask.astype(np.uint8), (1.0, 1.0, 1.0),
                              meta["spacing"], order=order)
    target = meta["orig_shape"]
    out = out[: target[0], : target[1], : target[2]]
    pads = [(0, t - s) for t, s in zip(target, out.shape)]
    if any(p[1] for p in pads):
        out = np.pad(out, pads)
    return out


def predict_folder(
    model_fns,
    input_dir: str,
    output_dir: str,
    classes: Sequence[str],
    window=(128, 128, 128),
    batch: int = 8,
    threshold: float = 0.5,
    organ_mask_on_lesion: bool = True,
    connected_components: bool = False,
    save_probabilities: bool = False,
    prob_wire: str = "u8",
    ids: Optional[Sequence[str]] = None,
    parts: int = 1,
    part: int = 0,
    resume: bool = True,
    device="cuda",
) -> List[str]:
    """Predict every NIfTI CT in `input_dir`; per-class masks under
    ``output_dir/<id>/``. Supports parts-sharding and resume; a failing case
    is logged to ``prediction_errors.txt`` and skipped."""
    device = resolve_device(device)  # a missing card raises here, not per case
    os.makedirs(output_dir, exist_ok=True)
    vols = sorted(f for f in os.listdir(input_dir)
                  if f.endswith((".nii", ".nii.gz")))
    if ids is not None:
        keep = set(ids)
        vols = [f for f in vols if f.split(".nii")[0] in keep]
    vols = vols[part::parts]

    done = []
    for fname in vols:
        case = fname.split(".nii")[0]
        case_dir = os.path.join(output_dir, case)
        marker = os.path.join(case_dir, "done")
        if resume and os.path.exists(marker):
            done.append(case)
            continue
        try:
            vol, meta = preprocess_volume(os.path.join(input_dir, fname),
                                          min_size=window)
            lesion_probs = None
            if organ_mask_on_lesion:
                lesion_idx = [i for i, c in enumerate(classes)
                              if "lesion" in c]
                out = predict_masks_volume(
                    model_fns, vol, classes, window=window, batch=batch,
                    threshold=threshold,
                    connected_components=connected_components,
                    prob_channels=lesion_idx if save_probabilities else None,
                    prob_wire=prob_wire, device=device)
                if save_probabilities:
                    masks, lesion_probs = out
                    lesion_probs = {classes[c]: lesion_probs[..., k]
                                    for k, c in enumerate(lesion_idx)}
                else:
                    masks = out
            else:
                probs = predict_volume(model_fns, vol, len(classes),
                                       window=window, batch=batch,
                                       device=device)
                masks = postprocess_prediction(
                    probs, classes, threshold=threshold,
                    connected_components=connected_components)
                if save_probabilities:
                    lesion_probs = {cls: probs[..., i]
                                    for i, cls in enumerate(classes)
                                    if "lesion" in cls}
            os.makedirs(case_dir, exist_ok=True)
            for cls, m in masks.items():
                write_nifti(os.path.join(case_dir, f"{cls}.nii.gz"),
                            restore_geometry(m, meta), meta["affine"])
            if lesion_probs is not None:
                for cls, p in lesion_probs.items():
                    write_nifti(os.path.join(case_dir, f"{cls}_prob.nii.gz"),
                                p.astype(np.float32), np.eye(4))
            with open(marker, "w") as f:
                f.write("ok\n")
            done.append(case)
        except Exception:
            with open(os.path.join(output_dir, "prediction_errors.txt"),
                      "a") as f:
                f.write(f"{case}\n{traceback.format_exc()}\n")
    return done
