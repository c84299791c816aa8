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

``ZeroOptimizer`` is ZeRO-1 over the data-parallel ranks (the JAX loop's
``zero_opt``): each rank keeps the optimizer's state for its slice of the
large parameters only (``parallel.mesh.zero_partition``), updates that
slice from the averaged gradient after the global-norm clip of the whole
gradient, and gathers the updated slices into the parameters, in buckets.
The update is elementwise, so it gives the bits of the replicated update.
Its ``state_dict`` is the whole state in the replicated optimizer's
layout.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, Dict, Iterable, List, Optional

import torch

from ..parallel.mesh import DataParallel, gather_shards, shard


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

    def _clip(self, params) -> None:
        if self.clip_norm is not None:
            clip_by_global_norm([p.grad for p in params if p.grad is not None],
                                self.clip_norm)

    def step(self, count: int) -> None:
        """One update from the parameters' ``.grad``; `count` is the number
        of updates made before this one."""
        self._clip(self.params)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(count)
        self.opt.step()

    def state_dict(self) -> dict:
        return self.opt.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state)


class ZeroOptimizer(Optimizer):
    """ZeRO-1 over `dp`'s ranks: `base`'s optimizer rebuilt on this rank's
    slices of the parameters that `axes` splits (one axis or None a
    parameter, in `base`'s order; ``parallel.mesh.zero_partition``), the
    whole parameter where None."""

    def __init__(self, base: Optimizer, axes: List[Optional[int]],
                 dp: DataParallel):
        self.full = base.params
        self.axes = list(axes)
        self.dp = dp
        self.slices = [
            p if a is None else torch.nn.Parameter(
                shard(p.detach(), a, dp).clone())
            for p, a in zip(self.full, self.axes)]
        cls = type(base.opt)
        # the defaults hold keys the constructor does not take (AdamW's
        # decoupled_weight_decay)
        accepted = inspect.signature(cls).parameters
        opt = cls(self.slices, **{k: v for k, v in base.opt.defaults.items()
                                  if k in accepted})
        super().__init__(opt, base.schedule, base.clip_norm)

    def step(self, count: int) -> None:
        """Clip the whole averaged gradient, update this rank's slices and
        gather them into the parameters. A slice is taken from its
        parameter before each update, so parameters loaded in place (a
        warm start, a resume) need nothing more."""
        self._clip(self.full)
        with torch.no_grad():
            for p, s, a in zip(self.full, self.slices, self.axes):
                if a is not None:
                    s.copy_(shard(p, a, self.dp))
                    s.grad = shard(p.grad, a, self.dp).contiguous()
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(count)
        self.opt.step()
        split = [i for i, a in enumerate(self.axes) if a is not None]
        whole = gather_shards([self.slices[i] for i in split],
                              [self.axes[i] for i in split], self.dp)
        with torch.no_grad():
            for i, w in zip(split, whole):
                self.full[i].copy_(w)
                self.slices[i].grad = None

    def state_dict(self) -> dict:
        """The whole state, gathered, in the layout of the replicated
        optimizer's ``state_dict`` (every rank must call it)."""
        sd = self.opt.state_dict()
        state = {i: dict(st) for i, st in sd["state"].items()}
        split = [(i, k) for i, st in state.items() if self.axes[i] is not None
                 for k, v in st.items() if torch.is_tensor(v) and v.dim()]
        whole = gather_shards([state[i][k] for i, k in split],
                              [self.axes[i] for i, _ in split], self.dp)
        for (i, k), w in zip(split, whole):
            state[i][k] = w
        return {**sd, "state": state}

    def load_state_dict(self, state: dict) -> None:
        """Load a whole state (either mode's checkpoint): this rank keeps
        its slices."""
        sd = {"param_groups": state["param_groups"], "state": {}}
        for i, st in state["state"].items():
            a = self.axes[int(i)]
            sd["state"][i] = {
                k: shard(v, a, self.dp).clone()
                if a is not None and torch.is_tensor(v) and v.dim() else v
                for k, v in st.items()}
        self.opt.load_state_dict(sd)


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
