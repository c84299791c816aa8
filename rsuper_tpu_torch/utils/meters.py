"""Console progress meters (the port's own copy of ``AverageMeter`` of
``rsuper_tpu/utils/meters.py``)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":.4f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return (f"{self.name} {format(self.val, self.fmt[1:])} "
                f"({format(self.avg, self.fmt[1:])})")
