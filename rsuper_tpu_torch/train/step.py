"""The training step: forward → R-Super losses → backward → clip → update →
EMA (counterpart of ``rsuper_tpu/train/step.py``), for one device, on 3D
volumes and on the 2D pathway's slices. The model computes in its ``dtype`` (bf16 in training) with float32
parameters, optimizer state and loss accumulations; it casts by hand, there
is no ``torch.autocast``. The CLIP step (``clip_only``) runs the encoder and
its heads only. A 2D batch's outputs and masks are lifted to depth-1
volumes, so the 3D loss stack serves both.

With a `group` (``parallel.mesh.DataParallel``, this rank's place in the
rank grid) a rank runs its data rank's items (``batch_size / data`` of the
global batch): its loss terms are its shares of the global batch's
(``losses/dispatcher.py``, coupled over the data group), its backward gives
its share of the gradient, and ``parallel.mesh.all_reduce_mean_`` reduces
the gradients in buckets. Every rank then holds the gradient of the global
batch's loss, the step the JAX package takes on its ``(data, model)``
mesh, and reports the global terms, the same bits on every rank.

With spatial sharding (``group.spatial``) the model runs on the rank's run
of depth planes of the image (of rows of a 2D slice: ``shard_depth`` splits
axis 1 of both), and its sharded outputs are gathered to whole volumes (or
slices, lifted after the gather) at the model/loss boundary, as
``rsuper_tpu/train/step.py`` gathers them: every loss then runs on whole
volumes, the same bits on every rank of the model group, so the Ball Loss's
host reads take the same branches there. Each rank seeds its backward with
1/S of the loss; a parameter's gradient is then a partial whose sum over
the model group is the data rank's (``parallel/spatial.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..losses import LesionChannelMap, LossConfig, calculate_loss
from ..parallel.mesh import all_reduce_mean_, mean_over_ranks
from ..parallel.spatial import gather_segmentation, shard_depth
from .state import TrainState


def _lift_2d(x):
    """(B, H, W, C) → (B, 1, H, W, C): 2D-pathway tensors become depth-1
    volumes so the loss stack (spatial axes (1, 2, 3)) serves both modes."""
    return x[:, None] if x is not None and x.dim() == 4 else x


def loss_fn(model, batch: Dict[str, Any], lmap: LesionChannelMap,
            cfg: LossConfig, model_genesis: bool = False,
            clip_only: bool = False, group=None):
    """(overall loss, dict of every loss term) of one batch: ``image``
    (B, D, H, W, 1), ``label``, ``unk``, ``segment_mask`` (B, D, H, W, C),
    ``volumes`` (B, T), ``diameters`` (B, T, 3), optional ``class_weights``
    and, for ``clip_only``, ``report_embedding`` (B, F). A 2D batch has
    (B, H, W, ·) images and masks, lifted after the model with
    ``_lift_2d``. A ``clip_only`` step runs the model's encoder and heads
    alone (the CLIP loss reads nothing of the decoder). With `group`, the
    terms are this rank's shares of the global batch's; with
    ``group.spatial`` the model runs depth-sharded (row-sharded in 2D) and
    its outputs are gathered before the losses."""
    sp = None if group is None else group.spatial
    image = batch["image"]
    extra = ()
    if sp is not None:
        image, extra = shard_depth(image, sp), (sp,)
    if clip_only:
        out = model.branches(model.encoder(image, *extra)[4])
    else:
        out = model(image, *extra)
    if sp is not None:
        out = gather_segmentation(out, sp, image.shape[1])
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
        report_embeddings=batch.get("report_embedding"), group=group)
    return losses["overall"], losses


def gradients(model, batch: Dict[str, Any], lmap: LesionChannelMap,
              cfg: LossConfig, model_genesis: bool = False,
              clip_only: bool = False, group=None) -> Dict[str, Any]:
    """Every parameter's ``.grad`` from one batch and the detached loss
    terms. A parameter the loss does not reach (the decoder of a CLIP step,
    a head no term reads) gets a zero gradient, as the JAX step's gradient
    of the whole tree has: AdamW would skip it, weight decay included. With
    `group` the gradients are reduced over the ranks (the mean over the
    data group of the sums over the model group) and the terms are the
    global batch's, the same on every rank."""
    model.zero_grad(set_to_none=True)
    overall, losses = loss_fn(model, batch, lmap, cfg, model_genesis,
                              clip_only, group)
    sp = None if group is None else group.spatial
    (overall if sp is None else overall * (1.0 / sp.size)).backward()
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if group is None:
        return {k: v.detach() for k, v in losses.items()}
    all_reduce_mean_([p.grad for p in params], group)
    terms = mean_over_ranks(torch.stack([v.detach().float()
                                         for v in losses.values()]), group)
    return dict(zip(losses, terms.unbind()))


def build_train_step(lmap: LesionChannelMap, cfg: LossConfig = LossConfig(),
                     ema_alpha: float = 0.99, model_genesis: bool = False,
                     clip_only: bool = False, group=None):
    """Returns ``step(state, batch) -> (state, losses)``. The state is
    updated in place; the losses come back detached (with `group`, the
    global batch's)."""

    def train_step(state: TrainState, batch):
        losses = gradients(state.model, batch, lmap, cfg, model_genesis,
                           clip_only, group)
        state.apply_gradients(ema_alpha=ema_alpha)
        return state, losses

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
