"""Counter-gated NIfTI sanity dumps (counterpart of
``rsuper_tpu/utils/debug_dumps.py``).

The reference saves the first ~10 batches of every intermediate (labels,
known and unknown masks, the chosen segment, the Ball Loss's pseudo-masks,
per-voxel BCE maps) as ``.nii.gz`` for a visual check
(``losses_foundation.py`` ``debug_save_labels``). Here it is a host-side
utility that takes numpy arrays or tensors on any device, which it moves to
the host.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.nifti import write_nifti


def _host(arr) -> np.ndarray:
    """A numpy array of `arr`; a tensor is detached and moved to the host
    (bf16, which numpy lacks, as float32: exact)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        return arr.numpy()
    return np.asarray(arr)


class SanityDumper:
    """Dump the first `limit` calls' tensors as one NIfTI a channel."""

    def __init__(self, out_dir: str = "./SanityCheck", limit: int = 10):
        self.out_dir = out_dir
        self.limit = limit
        self.counter = 0

    def dump(self, tensors: Dict[str, object],
             class_names: Optional[Sequence[str]] = None,
             batch_idx: int = 0) -> None:
        """`tensors`: {name: (B, D, H, W, C) or (B, D, H, W)} channels-last
        arrays or tensors; item `batch_idx`'s channels are written to
        ``<out_dir>/<call>/<name>_<class>.nii.gz`` as float32 (an all-zero
        channel of a multi-channel tensor is skipped, as the reference skips
        it). Nothing once `limit` calls have dumped."""
        if self.counter >= self.limit:
            return
        sub = os.path.join(self.out_dir, str(self.counter))
        os.makedirs(sub, exist_ok=True)
        for name, arr in tensors.items():
            arr = _host(arr)
            if arr.ndim == 4:  # (B, D, H, W)
                arr = arr[..., None]
            vol = arr[batch_idx]
            C = vol.shape[-1]
            for c in range(C):
                ch = vol[..., c].astype(np.float32)
                if C > 1 and not ch.any():
                    continue
                label = (class_names[c] if class_names and c < len(class_names)
                         else str(c))
                write_nifti(os.path.join(sub, f"{name}_{label}.nii.gz"), ch)
        self.counter += 1
