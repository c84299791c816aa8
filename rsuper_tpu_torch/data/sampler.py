"""Epoch sampler (the port's own copy of ``ChunkedSampler`` of
``rsuper_tpu/data/sampler.py``): R-Super's fixed-work epochs. The full index
permutation is shuffled once a cycle, each epoch serves
`samples_per_epoch` indices, the last chunk of a cycle is padded from the
next, and the indices are sliced round-robin across data-parallel shards.
The CLIP sampler (``OrganBatchSampler``) is not ported.
"""

from __future__ import annotations

from typing import List, Optional

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
