"""Checkpoints: latest / every-N / best retention and resume, warm starts
from a donor's parameters, and the read-only parameter load that serving
uses (the port's counterpart of ``rsuper_tpu/train/checkpoint.py``, with
``torch.save`` in place of orbax).

A checkpoint ``<dir>/<tag>`` holds the model's, the optimizer's and the EMA
copy's ``state_dict``s and the step (a converted reference checkpoint,
``save_params``, holds the parameters alone). It is written to a temporary
file in the same directory, flushed to disk and ``os.replace``d, so a run
cut mid-write never leaves a torn ``latest``. Saves are synchronous: when
``_save`` returns, the checkpoint is durable, so ``wait()`` has nothing to
wait for. Only a save creates the directory: reading never does.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from typing import Dict, Optional, Sequence

import torch

from .state import TrainState


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(path: str, payload) -> None:
    """``torch.save`` `payload` to `path` atomically and durably, creating
    its directory."""
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(directory)


class CheckpointManager:
    def __init__(self, directory: str, save_every: int = 25):
        self.directory = os.path.abspath(directory)
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
        _write(self._path(tag), payload)

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


def save_params(directory: str, params: Dict[str, torch.Tensor],
                tag: str = "best") -> str:
    """Write `params` (a ``state_dict``) as ``<directory>/<tag>`` holding the
    parameters alone, as the JAX package's checkpoint converter writes
    ``{"params": ...}``; returns the path."""
    path = os.path.join(os.path.abspath(directory), tag)
    _write(path, {"params": {k: v.detach().cpu() for k, v in params.items()}})
    return path


def load_params(directory: str, tag: str = "best",
                ema: bool = False) -> Dict[str, torch.Tensor]:
    """The parameters of ``<directory>/<tag>`` as a ``state_dict`` on the
    CPU, for serving: no optimizer, no train state. Falls back to ``latest``
    when `tag` is absent (JAX ``predict.py:81``). With `ema` the EMA copy,
    and a checkpoint without one raises. A missing directory raises
    ``FileNotFoundError`` and is not created."""
    ckpt = CheckpointManager(directory)
    if not os.path.isdir(ckpt.directory):
        raise FileNotFoundError(
            f"checkpoint directory {ckpt.directory} does not exist")
    use = tag if ckpt.has(tag) else "latest"
    if not ckpt.has(use):
        raise FileNotFoundError(
            f"{ckpt.directory} holds neither {tag!r} nor 'latest'")
    payload = torch.load(ckpt._path(use), map_location="cpu",
                         weights_only=True)
    if not ema:
        return payload["params"]
    if payload.get("ema_params") is None:
        raise ValueError(
            f"--ema: {ckpt._path(use)} holds no EMA copy (a converted "
            "checkpoint holds the parameters alone: convert the reference's "
            "EMA weights with convert_checkpoint --ema instead)")
    return {**payload["params"], **payload["ema_params"]}


def parse_class_list(spec: str):
    """A class list from a YAML/JSON list file or a comma-separated string,
    SORTED — the reference sorts the old-classes yaml on load
    (``train_ddp.py:438`` "we will sort them!"). PyYAML is optional: without
    it a file is read as JSON."""
    if os.path.exists(spec):
        with open(spec) as f:
            text = f.read()
        try:
            import yaml
        except ImportError:
            classes = json.loads(text)
        else:
            try:
                classes = yaml.safe_load(text)
            except yaml.YAMLError:
                classes = json.loads(text)
        if isinstance(classes, dict):  # tolerate {'classes': [...]} wrappers
            classes = classes.get("classes")
        if not isinstance(classes, (list, tuple)):
            # guessing (e.g. values()[0] of a {name: index} mapping) would
            # silently yield a wrong class ordering for head surgery
            raise ValueError(
                f"{spec}: expected a YAML/JSON list of class names or a "
                "{'classes': [...]} mapping")
    else:
        classes = [c for c in spec.split(",") if c.strip()]
    return sorted(str(c).strip() for c in classes)


def _donor_params(path: str) -> Dict[str, torch.Tensor]:
    """The donor's parameters as a ``state_dict``: from an ``.npz`` of flax
    parameters (``tools/export_params_npz.py``), carried across by
    ``params_from_flax``, or from ``<path>/best``, the best checkpoint of
    ``CheckpointManager``."""
    if os.path.isfile(path):
        import numpy as np

        from ..models.params import params_from_flax

        with np.load(path) as flat:
            return params_from_flax({k: flat[k] for k in flat.files})
    payload = torch.load(os.path.join(path, "best"), map_location="cpu",
                         weights_only=True)
    return payload["params"]


def load_pretrained_params(state: TrainState, path: str,
                           old_classes: Optional[Sequence[str]] = None,
                           new_classes: Optional[Sequence[str]] = None
                           ) -> TrainState:
    """Non-strict transfer-learning load (reference ``model/utils.py:125-129``)
    into ``state.model``'s parameters, in place: tensors whose name and shape
    match are copied; everything else keeps its fresh init, and so does the
    EMA copy, as in the JAX package (which replaces the parameters alone).
    The log reports how many tensors transferred (a warning at zero). An
    unreadable donor logs a warning and leaves `state` as it is.

    With `old_classes` + `new_classes` (reference --update_output_layer
    --old_classes, ``train_ddp.py:437-438`` → ``update_output_layer_onk``)
    the output heads are remapped class by class
    (``models/surgery.update_output_layers``)."""
    logger = logging.getLogger("rsuper")
    where = path if os.path.isfile(path) else os.path.join(
        os.path.abspath(path), "best")
    try:
        donor = _donor_params(path)
    except (OSError, KeyError, TypeError, ValueError, RuntimeError,
            pickle.UnpicklingError) as e:  # unreadable / not a checkpoint
        logger.warning("pretrained load failed for %s (%s: %s) — keeping "
                       "fresh init", where, type(e).__name__, e)
        return state
    model = state.model
    current = model.state_dict()
    if old_classes:
        from ..models.surgery import update_output_layers

        new = update_output_layers(current, donor, list(old_classes),
                                   list(new_classes))
        logger.info(
            "pretrained transfer from %s with class surgery: %d old -> %d "
            "new classes (%d shared)", where, len(old_classes),
            len(new_classes), len(set(old_classes) & set(new_classes)))
    else:
        same = {k for k, v in current.items()
                if k in donor and donor[k].shape == v.shape}
        new = {k: donor[k].to(v) if k in same else v
               for k, v in current.items()}
        log = logger.warning if not same else logger.info
        log("pretrained transfer from %s: %d/%d parameter tensors matched "
            "by name+shape (non-strict)", where, len(same), len(current))
    with torch.no_grad():
        model.load_state_dict(new)
    return state
