"""Static lesion-channel mapping (counterpart of
``rsuper_tpu/losses/lesions.py``; host-side, the port's own copy).

Channels whose class name contains one of the suffixes {lesion, cyst, pdac,
pnet} are grouped by their ``<organ>_<suffix>`` prefix (``pancreatic`` →
``pancreas``) and merged with an elementwise max. The name scan runs once,
when the map is built; ``merge`` is an index and a max over the last axis.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

LESION_SUFFIXES = ("lesion", "cyst", "pdac", "pnet")


def _group_name(cls: str, suffix: str) -> str:
    name = cls[: cls.index("_" + suffix) + len("_" + suffix)]
    return name.replace("pancreatic", "pancreas")


@dataclasses.dataclass(frozen=True)
class LesionChannelMap:
    """Frozen mapping from the C class channels to the L merged lesion
    channels."""

    classes: Tuple[str, ...]
    lesion_names: Tuple[str, ...]
    groups: Tuple[Tuple[int, ...], ...]  # per lesion channel: class indices

    @classmethod
    def from_classes(cls, classes: Sequence[str]) -> "LesionChannelMap":
        classes = tuple(classes)
        names: list[str] = []
        groups: dict[str, list[int]] = {}
        for i, c in enumerate(classes):
            for suffix in LESION_SUFFIXES:
                if suffix in c:
                    name = _group_name(c, suffix)
                    if name not in groups:
                        groups[name] = []
                        names.append(name)
                    groups[name].append(i)
        return cls(
            classes=classes,
            lesion_names=tuple(names),
            groups=tuple(tuple(groups[n]) for n in names),
        )

    @property
    def num_lesion_channels(self) -> int:
        return len(self.lesion_names)

    def merge(self, x: torch.Tensor) -> torch.Tensor:
        """(..., C) → (..., L) by max over each lesion group. ``amax`` splits
        the gradient evenly among ties, as ``jnp.max`` does."""
        if x.shape[-1] != len(self.classes):
            raise ValueError(f"expected {len(self.classes)} channels, got "
                             f"{x.shape[-1]}")
        cols = [x[..., list(idxs)].amax(dim=-1) for idxs in self.groups]
        return torch.stack(cols, dim=-1)

    def lesion_class_indices(self) -> Tuple[int, ...]:
        """Channels whose class name contains 'lesion'."""
        return tuple(i for i, c in enumerate(self.classes) if "lesion" in c)
