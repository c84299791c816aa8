"""CLIP-pretraining data: a report embedding with every record (the port's
own copy of ``ReportEmbeddingStore`` and ``ClipRecordAdapter`` of
``rsuper_tpu/data/clip.py``).

The embeddings are precomputed, one float32 ``<case_id>.npy`` a case in the
``--clip_source`` directory (the reference embeds each report with
Clinical-Longformer, mean-pooled and L2-normalised). The encoder that writes
them is not ported: it needs the ``transformers`` package and the encoder's
weights.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class ReportEmbeddingStore:
    """``get(case_id)``: the case's embedding from `directory`, or None."""

    def __init__(self, directory: str):
        self.directory = directory

    def get(self, case_id: str) -> Optional[np.ndarray]:
        path = os.path.join(self.directory, f"{case_id}.npy")
        return np.load(path) if os.path.exists(path) else None


class ClipRecordAdapter:
    """Wraps a dataset so each record carries ``report_embedding``: float32
    of width `dim`, zeros for a case without an embedding."""

    def __init__(self, dataset, store: ReportEmbeddingStore, dim: int = 768):
        self.dataset = dataset
        self.store = store
        self.dim = dim

    def __len__(self):
        return len(self.dataset)

    @property
    def cases(self):
        return self.dataset.cases

    def crop_organs(self):
        return self.dataset.crop_organs()

    def sample(self, index: int, rng=None):
        rec = self.dataset.sample(index, rng)
        case = self.dataset.cases[index % len(self.dataset.cases)]
        emb = self.store.get(case.case_id)
        rec["report_embedding"] = (
            emb.astype(np.float32) if emb is not None
            else np.zeros((self.dim,), np.float32))
        return rec
