"""Symmetric InfoNCE of the CLIP-style pretraining baseline (counterpart of
``rsuper_tpu/losses/info_nce.py``).

Reference: ``rsuper_train/training/info_nce.py:63-118`` (implicit negatives:
the other items' positives) and the clip path of ``calculate_loss``
(``losses_foundation.py:841-856``): the loss is taken both ways, CT →
report and report → CT. Every step runs in float32.

Across data-parallel ranks (a ``parallel.mesh.DataParallel`` `group`) there
are two forms. ``symmetric_info_nce(..., group=)`` is the JAX package's
``axis_name`` form and the reference's: the negatives gathered from every
rank, the loss scaled by the number of ranks, the gradient flowing to this
rank's embeddings only, so that averaging the ranks' gradients gives the
gradient of the global batch's loss. ``symmetric_info_nce_share`` is what
the training step takes: this rank's items against every rank's, whose mean
over the ranks is the loss of the global batch, value and gradient both, as
the JAX step computes it on its mesh.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import DataParallel, gather_rows

TEMPERATURE = 0.1
EPS = 1e-12


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    """``x / max(‖x‖, EPS)`` written as ``x · rsqrt(max(Σx², EPS²))`` so
    that its gradient at x = 0 is finite (``F.normalize`` differentiates
    the norm, whose gradient there is 0/0). A CLIP head whose patch merge
    leaves one voxel outputs exactly zero from its instance norm."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=EPS * EPS))


def _nll_rows(q: torch.Tensor, k: torch.Tensor,
              first: int = 0) -> torch.Tensor:
    """The mean over the rows of q of −log softmax(q̂ k̂ᵀ / TEMPERATURE) at
    each row's positive, row i's being key ``first + i``."""
    logits = (_l2norm(q.float()) @ _l2norm(k.float()).t()) / TEMPERATURE
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.diagonal(logp, offset=first).mean()


def info_nce(query: torch.Tensor, positive_key: torch.Tensor) -> torch.Tensor:
    """Implicit-negative InfoNCE: logits = q̂ k̂ᵀ / TEMPERATURE, the labels on
    the diagonal."""
    return _nll_rows(query, positive_key)


def _gather_local_grad(x: torch.Tensor, group: DataParallel) -> torch.Tensor:
    """Every rank's rows in rank order; the gradient reaches this rank's
    own rows only (the reference's gather)."""
    parts = [torch.empty_like(x) for _ in range(group.world)]
    dist.all_gather(parts, x.detach().contiguous(), group=group.group)
    parts[group.rank] = x
    return torch.cat(parts)


def symmetric_info_nce(ct_embeddings: torch.Tensor,
                       report_embeddings: torch.Tensor,
                       group: Optional[DataParallel] = None) -> torch.Tensor:
    """0.5 · (CT → report + report → CT). With `group`, the JAX package's
    ``axis_name`` form: the negatives are every rank's items and the loss
    is scaled by the number of ranks."""
    scale = 1.0
    ct, rep = ct_embeddings, report_embeddings
    if group is not None:
        ct = _gather_local_grad(ct, group)
        rep = _gather_local_grad(rep, group)
        scale = float(group.world)
    return 0.5 * (info_nce(ct, rep) + info_nce(rep, ct)) * scale


def symmetric_info_nce_share(ct_embeddings: torch.Tensor,
                             report_embeddings: torch.Tensor,
                             group: DataParallel) -> torch.Tensor:
    """This rank's share of the global batch's symmetric InfoNCE: its rows
    against the keys of every rank (``gather_rows``, whose gradient goes
    back to the rank that owns each key). Its mean over the ranks is the
    loss of the global batch, whose rows are the ranks' in rank order."""
    b = ct_embeddings.shape[0]
    first = group.rank * b
    ct_all = gather_rows(ct_embeddings, group)
    rep_all = gather_rows(report_embeddings, group)
    return 0.5 * (_nll_rows(ct_embeddings, rep_all, first)
                  + _nll_rows(report_embeddings, ct_all, first))
