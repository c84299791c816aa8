"""Optimizer, learning-rate schedule, gradient clipping and EMA (counterpart
of ``rsuper_tpu/train/optim.py``, which builds them from optax).

* ``warmup_poly_schedule``: exponential warm-up ``e^(10·(e/w − 1))`` that
  reaches 1 at the warm-up boundary, then polynomial decay ``(1 − e/E)^0.9``,
  with e = floor(step / steps_per_epoch);
* ``make_optimizer``: AdamW (eps 1e-5, decoupled weight decay on every
  parameter, biases and LayerNorm scales included: one parameter group), Adam
  or SGD with momentum, behind gradient clipping to a global norm. The clip
  follows optax: g · clip / max(‖g‖, clip), not PyTorch's
  clip / (‖g‖ + 1e-6);
* ``ema_update``: EMA with alpha = min(1 − 1/(step + 1), alpha).

The learning rate is set from the step counter before every update, so the
optimizer holds no schedule state of its own.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch


def warmup_poly_schedule(base_lr: float, warmup_epochs: int, max_epochs: int,
                         steps_per_epoch: int,
                         power: float = 0.9) -> Callable[[int], float]:
    """Learning rate as a function of the number of updates already made."""

    def schedule(step: int) -> float:
        epoch = math.floor(step / steps_per_epoch)
        decay = max(1.0 - epoch / max_epochs, 0.0) ** power
        if not warmup_epochs:
            return base_lr * decay
        warm = 1.0 if epoch >= warmup_epochs else math.exp(
            10.0 * (epoch / warmup_epochs - 1.0))
        return base_lr * (warm if epoch <= warmup_epochs else decay)

    return schedule


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by max_norm / max(‖g‖, max_norm); returns the
    global norm ‖g‖ (float32, on the gradients' device, no host sync)."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([g.float() for g in grads])))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class Optimizer:
    """A ``torch.optim`` optimizer behind gradient clipping, with its
    learning rate set from a schedule of the update count."""

    def __init__(self, opt: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 clip_norm: Optional[float]):
        self.opt, self.schedule, self.clip_norm = opt, schedule, clip_norm

    @property
    def params(self):
        return [p for g in self.opt.param_groups for p in g["params"]]

    def step(self, count: int) -> None:
        """One update from the parameters' ``.grad``; `count` is the number
        of updates made before this one."""
        if self.clip_norm is not None:
            clip_by_global_norm(
                [p.grad for p in self.params if p.grad is not None],
                self.clip_norm)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(count)
        self.opt.step()


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str = "adamw",
                   base_lr: float = 6e-4, warmup_epochs: int = 5,
                   max_epochs: int = 150, steps_per_epoch: int = 1000,
                   weight_decay: float = 0.05, betas=(0.9, 0.999),
                   momentum: float = 0.9,
                   clip_norm: Optional[float] = 1.0) -> Optimizer:
    schedule = warmup_poly_schedule(base_lr, warmup_epochs, max_epochs,
                                    steps_per_epoch)
    params = list(params)
    name = name.lower()
    if name == "adamw":
        opt = torch.optim.AdamW(params, lr=base_lr, betas=tuple(betas),
                                eps=1e-5, weight_decay=weight_decay)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=base_lr, betas=tuple(betas),
                               eps=1e-8)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=base_lr, momentum=momentum)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return Optimizer(opt, schedule, clip_norm)


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], step: int,
               alpha: float = 0.99) -> Dict[str, torch.Tensor]:
    """In-place EMA update of `ema_params` with the step-dependent ramp:
    a = min(1 − 1/(step + 1), alpha), `step` counted after the update."""
    a = min(1.0 - 1.0 / (float(step) + 1.0), alpha)
    keys = list(ema_params)
    ema = [ema_params[k] for k in keys]
    torch._foreach_mul_(ema, a)
    torch._foreach_add_(ema, [params[k].detach() for k in keys], alpha=1.0 - a)
    return ema_params
