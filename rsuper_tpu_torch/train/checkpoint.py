"""Checkpoints: latest / every-N / best retention and resume (the port's
counterpart of ``rsuper_tpu/train/checkpoint.py``, with ``torch.save`` in
place of orbax).

A checkpoint ``<dir>/<tag>`` holds the model's, the optimizer's and the EMA
copy's ``state_dict``s and the step. It is written to a temporary file in
the same directory, flushed to disk and ``os.replace``d, so a run cut
mid-write never leaves a torn ``latest``. Saves are synchronous: when
``_save`` returns, the checkpoint is durable, so ``wait()`` has nothing to
wait for.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .state import TrainState


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, save_every: int = 25):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_every = save_every
        self.best_metric = -float("inf")

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, tag)

    def wait(self) -> None:
        """Every save is durable when it returns; nothing is pending."""

    def _save(self, tag: str, state: TrainState) -> None:
        payload = {
            "params": state.model.state_dict(),
            "opt_state": state.optimizer.opt.state_dict(),
            "ema_params": state.ema_params,
            "step": int(state.step),
        }
        path = self._path(tag)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.directory)

    def save_epoch(self, state: TrainState, epoch: int,
                   metric: Optional[float] = None) -> None:
        self._save("latest", state)
        if self.save_every and (epoch + 1) % self.save_every == 0:
            self._save(f"epoch_{epoch + 1}", state)
        if metric is not None and metric > self.best_metric:
            self.best_metric = metric
            self._save("best", state)

    def restore(self, state: TrainState, tag: str = "latest") -> TrainState:
        """Load `tag` into `state` (same model and optimizer), in place."""
        device = next(state.model.parameters()).device
        payload = torch.load(self._path(tag), map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["params"])
        state.optimizer.opt.load_state_dict(payload["opt_state"])
        if state.ema_params is not None:
            if payload["ema_params"] is None:
                raise ValueError(f"{self._path(tag)} holds no EMA copy")
            with torch.no_grad():
                for k, v in state.ema_params.items():
                    v.copy_(payload["ema_params"][k])
        state.step = int(payload["step"])
        return state

    def has(self, tag: str = "latest") -> bool:
        return os.path.exists(self._path(tag))
