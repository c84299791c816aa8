"""Train state: the model (its float32 parameters), the optimizer, the EMA
copy of the parameters and the step counter (counterpart of
``rsuper_tpu/train/state.py``). PyTorch updates in place, so one state object
lives through the run instead of a new pytree per step."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from .optim import Optimizer, ema_update


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]]
    step: int = 0

    def apply_gradients(self, ema_alpha: float = 0.99) -> "TrainState":
        """Clip, update the parameters from their ``.grad``, count the step,
        then move the EMA copy with the step counted after the update."""
        self.optimizer.step(self.step)
        self.step += 1
        if self.ema_params is not None:
            ema_update(self.ema_params, dict(self.model.named_parameters()),
                       self.step, ema_alpha)
        return self


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       ema: bool = True) -> TrainState:
    """State at step 0; the EMA copy starts as a copy of the parameters."""
    ema_params = ({k: p.detach().clone() for k, p in model.named_parameters()}
                  if ema else None)
    return TrainState(model=model, optimizer=optimizer, ema_params=ema_params)
