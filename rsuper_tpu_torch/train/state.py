"""Train state: the model (its float32 parameters), the optimizer, the EMA
copy of the parameters and the step counter (counterpart of
``rsuper_tpu/train/state.py``). PyTorch updates in place, so one state object
lives through the run instead of a new pytree per step.

With ``zero_ema`` over a data-parallel group, the EMA copy of each large
parameter is this rank's slice of it, split as ``zero_partition`` says
(``ema_axes``); ``full_ema`` gathers it for validation, export and
checkpoints, as the JAX loop's ``gather_tree`` does."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..parallel.mesh import DataParallel, gather_tree, shard, zero_partition
from .optim import Optimizer, ema_update


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]]
    step: int = 0
    ema_axes: Optional[Dict[str, Optional[int]]] = None
    dp: Optional[DataParallel] = None

    def _ema_sources(self) -> Dict[str, torch.Tensor]:
        """The parameters, or with a split EMA copy this rank's slices."""
        params = dict(self.model.named_parameters())
        if self.ema_axes is None:
            return params
        return {k: p if self.ema_axes[k] is None
                else shard(p, self.ema_axes[k], self.dp)
                for k, p in params.items()}

    def apply_gradients(self, ema_alpha: float = 0.99) -> "TrainState":
        """Clip, update the parameters from their ``.grad``, count the step,
        then move the EMA copy with the step counted after the update."""
        self.optimizer.step(self.step)
        self.step += 1
        if self.ema_params is not None:
            ema_update(self.ema_params, self._ema_sources(), self.step,
                       ema_alpha)
        return self

    def full_ema(self) -> Optional[Dict[str, torch.Tensor]]:
        """The whole EMA copy (every rank must call it when it is split)."""
        if self.ema_params is None or self.ema_axes is None:
            return self.ema_params
        return gather_tree(self.ema_params, self.ema_axes, self.dp)

    @torch.no_grad()
    def load_ema(self, full: Dict[str, torch.Tensor]) -> None:
        """Copy a whole EMA copy in (this rank keeps its slices)."""
        for k, v in self.ema_params.items():
            a = None if self.ema_axes is None else self.ema_axes[k]
            src = full[k] if a is None else shard(full[k], a, self.dp)
            v.copy_(src)

    def gather_ema(self) -> "TrainState":
        """Make the EMA copy whole for good (the end of a run)."""
        self.ema_params = self.full_ema()
        self.ema_axes = None
        return self


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       ema: bool = True,
                       dp: Optional[DataParallel] = None,
                       zero_ema: bool = False) -> TrainState:
    """State at step 0; the EMA copy starts as a copy of the parameters,
    split over `dp`'s ranks with `zero_ema`."""
    axes = None
    sources = dict(model.named_parameters())
    if zero_ema and ema and dp is not None:
        axes = zero_partition(sources, dp.world)
        sources = {k: p if axes[k] is None else shard(p, axes[k], dp)
                   for k, p in sources.items()}
    ema_params = ({k: p.detach().clone() for k, p in sources.items()}
                  if ema else None)
    return TrainState(model=model, optimizer=optimizer,
                      ema_params=ema_params, ema_axes=axes, dp=dp)
