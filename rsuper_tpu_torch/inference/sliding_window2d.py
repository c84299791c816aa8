"""2D sliding-window inference for the slice models (counterpart of
``rsuper_tpu/inference/sliding_window2d.py``).

A 2D model runs over every z-slice of a volume, with in-plane half-overlap
windows where the slice is larger than the window, in batches of windows.
The volume, the windows, the sigmoid probabilities and their float32
accumulator stay on the device; only the blended volume leaves it. The
windows are added in the JAX function's order, so the blended floats are
its own.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .sliding_window import window_starts


def sliding_window_inference_2d(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    volume: np.ndarray,
    num_classes: int,
    window: Sequence[int] = (256, 256),
    overlap: float = 0.5,
    batch: int = 8,
    device="cuda",
) -> np.ndarray:
    """Blended sigmoid probabilities (D, H, W, C), float32 on the host.
    `model_fn` maps (K, h, w, 1) float32 windows on `device` to
    (K, h, w, C) logits."""
    device = resolve_device(device)
    D, H, W = volume.shape
    window = tuple(window)
    pad = [max(0, w - s) for s, w in zip((H, W), window)]
    vol = np.pad(volume, [(0, 0), (0, pad[0]), (0, pad[1])]) if any(pad) \
        else volume
    Hp, Wp = vol.shape[1:]
    stride = tuple(max(1, int(w * (1 - overlap))) for w in window)
    ys = window_starts(Hp, window[0], stride[0])
    xs = window_starts(Wp, window[1], stride[1])
    coords = [(z, y, x) for z in range(D) for y in ys for x in xs]
    wh, ww = window
    with torch.inference_mode():
        v = torch.from_numpy(np.ascontiguousarray(vol, np.float32)).to(
            device)
        acc = torch.zeros((D, Hp, Wp, num_classes + 1), dtype=torch.float32,
                          device=device)
        for i in range(0, len(coords), batch):
            sl = coords[i:i + batch]
            tiles = torch.stack([v[z, y:y + wh, x:x + ww]
                                 for z, y, x in sl])[..., None]
            probs = torch.sigmoid(model_fn(tiles).float())
            for j, (z, y, x) in enumerate(sl):
                acc[z, y:y + wh, x:x + ww, :num_classes] += probs[j]
                acc[z, y:y + wh, x:x + ww, num_classes] += 1.0
        out = acc[..., :num_classes] / torch.clamp(acc[..., num_classes:],
                                                   min=1.0)
        return out[:, :H, :W].cpu().numpy()
