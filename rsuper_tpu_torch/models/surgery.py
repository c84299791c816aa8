"""Output-layer class surgery for transfer learning across class lists (the
port's counterpart of ``rsuper_tpu/models/surgery.py``).

Equivalent of the reference's ``update_output_layer_onk``
(``rsuper_train/model/dim3/medformer.py:224-320``): when fine-tuning a
checkpoint trained with a different class list, keep the per-class 1×1×1
conv weights (and biases) of classes present in both lists; everything else
keeps its fresh initialisation.

Works on ``state_dict``s. The class is the FIRST axis of the ``outc`` /
``aux_out`` weights (``Conv1``/``CFConv1``: ``weight`` (C_out, C_in),
``bias`` (C_out,)), where the JAX package's channels-last kernels carry it
last.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

HEADS = ("outc", "aux_out")  # the modules whose out-channel is the class


def _remap_first_axis(new, old, old_classes, new_classes):
    out = new.clone()
    old_idx = {c: i for i, c in enumerate(old_classes)}
    for j, cls in enumerate(new_classes):
        if cls in old_idx:
            out[j] = old[old_idx[cls]]
    return out


def update_output_layers(
    new_state: Mapping[str, torch.Tensor],
    old_state: Mapping[str, torch.Tensor],
    old_classes: Sequence[str],
    new_classes: Sequence[str],
) -> Dict[str, torch.Tensor]:
    """Return `new_state` with class-matched head rows copied from
    `old_state`. Other tensors are copied wholesale when shapes match
    (standard transfer), so call this INSTEAD of a plain load. The result
    keeps `new_state`'s types and devices."""
    out = {}
    for key, new in new_state.items():
        old = old_state.get(key)
        is_head = any(h in key for h in HEADS)
        if old is None:
            out[key] = new
        elif is_head and old.shape[1:] == new.shape[1:]:
            out[key] = _remap_first_axis(
                new, old.to(new), list(old_classes), list(new_classes))
        elif old.shape == new.shape:
            out[key] = old.to(new)
        else:
            out[key] = new
    return out
