"""Symmetric InfoNCE of the CLIP-style pretraining baseline (counterpart of
``rsuper_tpu/losses/info_nce.py``, one device).

Reference: ``rsuper_train/training/info_nce.py:63-118`` (implicit negatives:
the other items' positives) and the clip path of ``calculate_loss``
(``losses_foundation.py:841-856``): the loss is taken both ways, CT →
report and report → CT. Every step runs in float32. The form that gathers
negatives across devices waits for multi-GPU (``ROADMAP.md`` §1 item 8).
"""

from __future__ import annotations

import torch

TEMPERATURE = 0.1
EPS = 1e-12


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    """``x / max(‖x‖, EPS)`` written as ``x · rsqrt(max(Σx², EPS²))`` so
    that its gradient at x = 0 is finite (``F.normalize`` differentiates
    the norm, whose gradient there is 0/0). A CLIP head whose patch merge
    leaves one voxel outputs exactly zero from its instance norm."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=EPS * EPS))


def info_nce(query: torch.Tensor, positive_key: torch.Tensor) -> torch.Tensor:
    """Implicit-negative InfoNCE: logits = q̂ k̂ᵀ / TEMPERATURE, the labels on
    the diagonal."""
    q = _l2norm(query.float())
    k = _l2norm(positive_key.float())
    logits = (q @ k.t()) / TEMPERATURE
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.diagonal(logp).mean()


def symmetric_info_nce(ct_embeddings: torch.Tensor,
                       report_embeddings: torch.Tensor) -> torch.Tensor:
    """0.5 · (CT → report + report → CT)."""
    return 0.5 * (info_nce(ct_embeddings, report_embeddings)
                  + info_nce(report_embeddings, ct_embeddings))
