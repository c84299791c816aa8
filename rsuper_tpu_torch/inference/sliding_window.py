"""Sliding-window inference with the accumulator on the device
(counterpart of ``rsuper_tpu/inference/sliding_window.py``).

Windows on a half-window-stride grid go through the model in batches; the
sigmoid probabilities and the blend weight share one (D, H, W, C+1) float32
accumulator on the device, and only the blended volume leaves it. Windows
whose organ-mask overlap is empty are skipped. Runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device


def window_starts(size: int, window: int, stride: int) -> list:
    """Start offsets covering [0, size) with `stride`, last window clamped
    flush to the end."""
    if size <= window:
        return [0]
    n = math.ceil((size - window) / stride)
    starts = [min(i * stride, size - window) for i in range(n + 1)]
    return sorted(set(starts))


def _grid(shape, window, stride):
    zs = window_starts(shape[0], window[0], stride[0])
    ys = window_starts(shape[1], window[1], stride[1])
    xs = window_starts(shape[2], window[2], stride[2])
    return np.array([(z, y, x) for z in zs for y in ys for x in xs], np.int32)


def _gaussian_window(window, sigma_scale: float = 0.125) -> np.ndarray:
    """nnU-Net-style importance map, (*window, 1) float32."""
    ws = []
    for w in window:
        c = (w - 1) / 2.0
        x = np.arange(w) - c
        ws.append(np.exp(-(x**2) / (2 * (w * sigma_scale) ** 2)))
    m = ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]
    m = m / m.max()
    return np.maximum(m, 1e-4).astype(np.float32)[..., None]


def sliding_window_probs_device(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    volume: np.ndarray,
    num_classes: int,
    window: Sequence[int] = (128, 128, 128),
    overlap: float = 0.5,
    batch: int = 8,
    organ_mask: Optional[np.ndarray] = None,
    blend: str = "uniform",
    device="cuda",
) -> torch.Tensor:
    """Blended sigmoid probabilities for one volume, left on `device` as a
    (D, H, W, C) float32 tensor cropped to the input shape.

    `model_fn` maps (K, *window, 1) float32 windows on `device` to
    (K, *window, C) logits."""
    device = resolve_device(device)
    window = tuple(window)
    stride = tuple(max(1, int(w * (1.0 - overlap))) for w in window)
    orig_shape = volume.shape
    pad = [max(0, w - s) for s, w in zip(orig_shape, window)]
    if any(pad):
        volume = np.pad(volume, [(0, p) for p in pad])
        if organ_mask is not None:
            organ_mask = np.pad(organ_mask, [(0, p) for p in pad])
    shape = volume.shape

    starts = _grid(shape, window, stride)
    if organ_mask is not None:
        keep = []
        for s in starts:
            sl = tuple(slice(a, a + w) for a, w in zip(s, window))
            keep.append(bool(organ_mask[sl].any()))
        starts = starts[np.asarray(keep)] if any(keep) else starts[:1]

    with torch.inference_mode():
        # float16 transfer, as the JAX path: the normalised CT fits f16
        vol = torch.from_numpy(np.asarray(volume, np.float16)).to(device)
        vol = vol.float()[..., None]
        acc = torch.zeros((*shape, num_classes + 1), dtype=torch.float32,
                          device=device)
        wmap = (torch.from_numpy(_gaussian_window(window)).to(device)
                if blend == "gaussian"
                else torch.ones((*window, 1), dtype=torch.float32,
                                device=device))
        for i in range(0, len(starts), batch):
            sl = starts[i:i + batch]
            wins = torch.stack([
                vol[z:z + window[0], y:y + window[1], x:x + window[2]]
                for z, y, x in sl])
            probs = torch.sigmoid(model_fn(wins).float())
            for j, (z, y, x) in enumerate(sl):
                region = acc[z:z + window[0], y:y + window[1],
                             x:x + window[2]]
                region[..., :num_classes] += probs[j] * wmap
                region[..., num_classes:] += wmap
        out = acc[..., :num_classes] / torch.clamp(acc[..., num_classes:],
                                                   min=1e-4)
        if any(pad):
            out = out[: orig_shape[0], : orig_shape[1], : orig_shape[2]]
    return out


def sliding_window_inference(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    volume: np.ndarray,
    num_classes: int,
    window: Sequence[int] = (128, 128, 128),
    overlap: float = 0.5,
    batch: int = 8,
    organ_mask: Optional[np.ndarray] = None,
    blend: str = "uniform",
    out_dtype=np.float16,
    device="cuda",
) -> np.ndarray:
    """Blended sigmoid probabilities (D, H, W, C) for one volume, on host,
    transferred as `out_dtype`."""
    probs = sliding_window_probs_device(
        model_fn, volume, num_classes, window=window, overlap=overlap,
        batch=batch, organ_mask=organ_mask, blend=blend, device=device)
    tdt = {np.dtype(np.float16): torch.float16,
           np.dtype(np.float32): torch.float32}[np.dtype(out_dtype)]
    return probs.to(tdt).cpu().numpy()
