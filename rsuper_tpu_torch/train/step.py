"""The training step: forward → R-Super losses → backward → clip → update →
EMA (counterpart of ``rsuper_tpu/train/step.py``), for one device, on 3D
volumes and on the 2D pathway's slices. The model computes in its ``dtype`` (bf16 in training) with float32
parameters, optimizer state and loss accumulations; it casts by hand, there
is no ``torch.autocast``. The CLIP step (``clip_only``) runs the encoder and
its heads only. A 2D batch's outputs and masks are lifted to depth-1
volumes, so the 3D loss stack serves both. The mesh and spatial sharding
are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..losses import LesionChannelMap, LossConfig, calculate_loss
from .state import TrainState


def _lift_2d(x):
    """(B, H, W, C) → (B, 1, H, W, C): 2D-pathway tensors become depth-1
    volumes so the loss stack (spatial axes (1, 2, 3)) serves both modes."""
    return x[:, None] if x is not None and x.dim() == 4 else x


def loss_fn(model, batch: Dict[str, Any], lmap: LesionChannelMap,
            cfg: LossConfig, model_genesis: bool = False,
            clip_only: bool = False):
    """(overall loss, dict of every loss term) of one batch: ``image``
    (B, D, H, W, 1), ``label``, ``unk``, ``segment_mask`` (B, D, H, W, C),
    ``volumes`` (B, T), ``diameters`` (B, T, 3), optional ``class_weights``
    and, for ``clip_only``, ``report_embedding`` (B, F). A 2D batch has
    (B, H, W, ·) images and masks, lifted after the model with
    ``_lift_2d``. A ``clip_only`` step runs the model's encoder and heads
    alone (the CLIP loss reads nothing of the decoder)."""
    if clip_only:
        out = model.branches(model.encoder(batch["image"])[4])
    else:
        out = model(batch["image"])
    if batch["image"].dim() == 4 and not clip_only:  # 2D slices
        seg = out.get("segmentation")
        if isinstance(seg, (tuple, list)):
            out = {**out, "segmentation": [_lift_2d(h) for h in seg]}
        else:
            out = {**out, "segmentation": _lift_2d(seg)}
        batch = {**batch, **{k: _lift_2d(batch.get(k))
                             for k in ("label", "unk", "segment_mask")}}
    losses = calculate_loss(
        out, batch.get("label"), batch.get("unk"), batch.get("segment_mask"),
        batch.get("volumes"), batch.get("diameters"), lmap, cfg,
        class_weights=batch.get("class_weights"),
        model_genesis=model_genesis, clip_only=clip_only,
        report_embeddings=batch.get("report_embedding"))
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
        # a parameter the loss does not reach (the decoder of a CLIP step, a
        # head no term reads) updates with a zero gradient, as the JAX step's
        # gradient of the whole tree does: AdamW would skip it, weight decay
        # included
        for p in state.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
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
