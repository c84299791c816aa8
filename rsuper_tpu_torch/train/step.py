"""The training step: forward → R-Super losses → backward → clip → update →
EMA (counterpart of ``rsuper_tpu/train/step.py``), for one device and 3D
input. The model computes in its ``dtype`` (bf16 in training) with float32
parameters, optimizer state and loss accumulations; it casts by hand, there
is no ``torch.autocast``. The mesh, spatial sharding and the 2D lift are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..losses import LesionChannelMap, LossConfig, calculate_loss
from .state import TrainState


def loss_fn(model, batch: Dict[str, Any], lmap: LesionChannelMap,
            cfg: LossConfig, model_genesis: bool = False,
            clip_only: bool = False):
    """(overall loss, dict of every loss term) of one batch: ``image``
    (B, D, H, W, 1), ``label``, ``unk``, ``segment_mask`` (B, D, H, W, C),
    ``volumes`` (B, T), ``diameters`` (B, T, 3), optional ``class_weights``."""
    if batch["image"].dim() != 5:
        raise NotImplementedError("the 2D pathway is not ported yet: image "
                                  "must be (B, D, H, W, 1)")
    out = model(batch["image"])
    losses = calculate_loss(
        out, batch.get("label"), batch.get("unk"), batch.get("segment_mask"),
        batch.get("volumes"), batch.get("diameters"), lmap, cfg,
        class_weights=batch.get("class_weights"),
        model_genesis=model_genesis, clip_only=clip_only)
    return losses["overall"], losses


def build_train_step(lmap: LesionChannelMap, cfg: LossConfig = LossConfig(),
                     ema_alpha: float = 0.99, model_genesis: bool = False,
                     clip_only: bool = False):
    """Returns ``step(state, batch) -> (state, losses)``. The state is
    updated in place; the losses come back detached."""

    def train_step(state: TrainState, batch):
        state.model.zero_grad(set_to_none=True)
        overall, losses = loss_fn(state.model, batch, lmap, cfg,
                                  model_genesis, clip_only)
        overall.backward()
        state.apply_gradients(ema_alpha=ema_alpha)
        return state, {k: v.detach() for k, v in losses.items()}

    return train_step


def build_eval_step(use_ema: bool = False):
    """Returns ``eval_step(state, image)``: sigmoid probabilities of the
    final head, from the parameters or their EMA copy."""

    @torch.inference_mode()
    def eval_step(state: TrainState, image):
        if use_ema:
            out = torch.func.functional_call(state.model, state.ema_params,
                                             (image,))
        else:
            out = state.model(image)
        seg = out["segmentation"]
        logits = seg[0] if isinstance(seg, (list, tuple)) else seg
        return torch.sigmoid(logits)

    return eval_step
