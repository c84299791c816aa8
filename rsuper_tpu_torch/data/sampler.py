"""Epoch samplers (the port's own copies of ``rsuper_tpu/data/sampler.py``).

* ``ChunkedSampler``: R-Super's fixed-work epochs. The full index
  permutation is shuffled once a cycle, each epoch serves
  `samples_per_epoch` indices, the last chunk of a cycle is padded from the
  next, and the indices are sliced round-robin across data-parallel shards.
* ``OrganBatchSampler``: CLIP-pretraining batches whose items all share one
  crop organ, drawn from (seed, global step) alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class ChunkedSampler:
    def __init__(
        self,
        num_items: int,
        samples_per_epoch: int,
        shard: int = 0,
        num_shards: int = 1,
        seed: int = 0,
    ):
        assert 0 <= shard < num_shards
        self.num_items = num_items
        self.samples_per_epoch = samples_per_epoch
        self.shard = shard
        self.num_shards = num_shards
        self.seed = seed
        self._perm: Optional[np.ndarray] = None
        self._pos = 0
        self._cycle = 0

    def _refill(self):
        rng = np.random.default_rng(self.seed + self._cycle)
        self._perm = rng.permutation(self.num_items)
        self._pos = 0
        self._cycle += 1

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """Global indices for `epoch`, padded to samples_per_epoch, then
        round-robin sliced for this shard."""
        if self._perm is None:
            self._refill()
        out: List[int] = []
        while len(out) < self.samples_per_epoch:
            take = min(
                self.samples_per_epoch - len(out), len(self._perm) - self._pos
            )
            out.extend(self._perm[self._pos : self._pos + take].tolist())
            self._pos += take
            if self._pos >= len(self._perm):
                self._refill()
        chunk = np.asarray(out[: self.samples_per_epoch])
        return chunk[self.shard :: self.num_shards]


class OrganBatchSampler:
    """Batches whose members all cropped on the same organ (the reference's
    ``sampler_clip.py``): InfoNCE negatives must not be separable by organ.
    Batch `step` draws from ``default_rng(seed + step)`` alone, so every
    shard, and a run resumed at any step, draws the same global batch."""

    def __init__(
        self,
        crop_organs: Sequence[str],
        batch_size: int,
        seed: int = 0,
        shard: int = 0,
        num_shards: int = 1,
    ):
        assert 0 <= shard < num_shards
        assert batch_size % num_shards == 0, (
            f"global batch {batch_size} must divide over {num_shards} shards"
        )
        self.organ_to_indices: Dict[str, np.ndarray] = {}
        organs = np.asarray(list(crop_organs))
        for organ in sorted(set(crop_organs)):
            self.organ_to_indices[organ] = np.flatnonzero(organs == organ)
        self.organs = sorted(self.organ_to_indices)
        self.batch_size = batch_size
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards

    def batch(self, step: int) -> np.ndarray:
        """The full (global) batch of `step`, the same on every shard."""
        rng = np.random.default_rng(self.seed + step)
        organ = self.organs[int(rng.integers(len(self.organs)))]
        pool = self.organ_to_indices[organ]
        return rng.choice(pool, size=self.batch_size,
                          replace=len(pool) < self.batch_size)

    def epoch_indices(self, epoch: int, steps_per_epoch: int) -> np.ndarray:
        """This shard's slice of `steps_per_epoch` consecutive global
        batches, in the layout of ``ChunkedSampler.epoch_indices``."""
        out = []
        for s in range(steps_per_epoch):
            b = self.batch(epoch * steps_per_epoch + s)
            out.extend(b[self.shard :: self.num_shards].tolist())
        return np.asarray(out)
