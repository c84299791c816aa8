"""Logging and the metrics sink (the port's own copy of
``rsuper_tpu/utils/logging.py``): a python logger writing ``train.log``, the
config snapshot ``config.txt``, and scalars appended to ``metrics.jsonl``
and to a TensorBoard event file. In a data-parallel job of several ranks
each rank writes ``train.rank{i}.log`` and ``metrics.rank{i}.jsonl``, and
rank 0 alone the TensorBoard file (every rank logs the same scalars)."""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict

from ..parallel.multihost import process_info


def _rank_suffix() -> str:
    """'' in one process; '.rank{i}' in a job of several ranks, so that the
    ranks' files in one experiment directory do not interleave."""
    rank, world = process_info()
    return f".rank{rank}" if world > 1 else ""


def setup_logger(exp_dir: str, name: str = "rsuper") -> logging.Logger:
    """The run's logger, writing to ``<exp_dir>/train.log`` and stderr. A
    second call for another directory moves the file handler there."""
    os.makedirs(exp_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    path = os.path.abspath(os.path.join(exp_dir,
                                        f"train{_rank_suffix()}.log"))
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler) and h.baseFilename != path:
            logger.removeHandler(h)
            h.close()
    if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger


def dump_config(exp_dir: str, cfg) -> None:
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "config.txt"), "w") as f:
        if dataclasses.is_dataclass(cfg):
            cfg = dataclasses.asdict(cfg)
        for k, v in sorted(cfg.items()):
            f.write(f"{k}: {v}\n")


class MetricsLogger:
    """JSONL scalars + a TensorBoard event file (``utils/tb_events.py``)."""

    def __init__(self, exp_dir: str, tensorboard: bool = True):
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, f"metrics{_rank_suffix()}.jsonl")
        self.tb = None
        if tensorboard and process_info()[0] == 0:
            from .tb_events import EventWriter

            self.tb = EventWriter(os.path.join(exp_dir, "tb"))

    def log(self, step: int, values: Dict[str, Any], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            key = f"{prefix}{k}" if prefix else k
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                rec[key] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            for k, v in rec.items():
                if k in ("step", "time") or not isinstance(v, float):
                    continue
                self.tb.add_scalar(k, v, step)
