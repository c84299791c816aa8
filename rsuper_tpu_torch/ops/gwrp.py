"""Global Weighted Rank Pooling (counterpart of ``rsuper_tpu/ops/gwrp.py``).

Voxels are ranked in descending order and weighted ``w_i ∝ d^i`` with ``d =
(1 − c)^(1/N)``, so the top N ranks hold the fraction c of the mass. The Ball
Loss uses the hard cut-off: weights are zero past rank N, normalised to sum
1, in voxel order.

``gwrp_weights_binned`` ranks by value bins instead of a sort: `levels` bins
over (0, max x], and every voxel of a bin has the rank "number of voxels in
strictly higher bins". The JAX package builds that table with one-hot
contractions (the TPU has no fast scatter); here it is a ``bincount``, a
reversed ``cumsum`` and an index lookup, which give the same integer ranks.
"""

from __future__ import annotations

import torch


def _decay(n, c: float) -> torch.Tensor:
    n = torch.clamp(torch.as_tensor(n, dtype=torch.float32), min=1.0)
    return (1.0 - c) ** (1.0 / n)


def _n(n, device) -> torch.Tensor:
    return torch.as_tensor(n, dtype=torch.float32, device=device)


def gwrp_pool(x: torch.Tensor, n, c: float = 0.75) -> torch.Tensor:
    """Exact (sort-based) GWRP pooling of an array to a scalar: sort
    descending, w_i = d^i normalised to sum 1, Σ x_i w_i."""
    flat = x.reshape(-1).float()
    sorted_desc = -torch.sort(-flat).values
    d = _decay(_n(n, x.device), c)
    w = d ** torch.arange(flat.shape[0], dtype=torch.float32, device=x.device)
    return torch.sum(sorted_desc * (w / w.sum()))


def _hard_cutoff(ranks: torch.Tensor, n: torch.Tensor, c: float) -> torch.Tensor:
    """ranks (B, L), n (B,) → weights ∝ d^rank below rank n, sum 1 a row."""
    n = n[:, None]
    w = torch.where(ranks < n, _decay(n, c) ** ranks, torch.zeros_like(ranks))
    return w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-30)


@torch.no_grad()
def gwrp_weights_exact(x: torch.Tensor, n, c: float = 0.75) -> torch.Tensor:
    """Exact hard-cut-off GWRP weights in voxel order: ranks from a full
    stable descending argsort."""
    flat = x.reshape(-1).float()
    L = flat.shape[0]
    order = torch.argsort(-flat, stable=True)
    ranks = torch.empty(L, dtype=torch.float32, device=x.device)
    ranks[order] = torch.arange(L, dtype=torch.float32, device=x.device)
    return _hard_cutoff(ranks[None], _n(n, x.device).reshape(1), c
                        ).reshape(x.shape)


@torch.no_grad()
def gwrp_weights_binned_batched(x: torch.Tensor, n, c: float = 0.75, *,
                                levels: int = 256) -> torch.Tensor:
    """``gwrp_weights_binned`` for every item of x (B, ...) with n (B,)."""
    B = x.shape[0]
    flat = x.reshape(B, -1).float()
    L = flat.shape[1]
    hi = torch.clamp(flat.max(dim=1, keepdim=True).values, min=1e-30)
    # bin 0 = the lowest positive values, bin levels-1 = the highest; values
    # <= 0 get -1. The order of the operations is the JAX function's: the
    # bin edges move with it
    b = torch.clamp(torch.ceil(flat / hi * levels).long(), 0, levels) - 1
    item = torch.arange(B, device=x.device)[:, None] * (levels + 1)
    counts = torch.bincount((b + 1 + item).reshape(-1),
                            minlength=B * (levels + 1))
    counts = counts.reshape(B, levels + 1)[:, 1:]
    higher = counts.flip(1).cumsum(1).flip(1) - counts
    ranks = higher.gather(1, b.clamp(min=0)).float()
    ranks = torch.where(b < 0, torch.full_like(ranks, float(L)), ranks)
    return _hard_cutoff(ranks, _n(n, x.device).reshape(B), c).reshape(x.shape)


def gwrp_weights_binned(x: torch.Tensor, n, c: float = 0.75, *,
                        levels: int = 256) -> torch.Tensor:
    """Approximate hard-cut-off GWRP weights by bin ranking: ranks are
    resolved to `levels` value bins over (0, max(x)]; voxels with value <= 0
    get rank L (never selected when n <= count(x > 0))."""
    n = _n(n, x.device).reshape(1)
    return gwrp_weights_binned_batched(x[None], n, c, levels=levels)[0]


def gwrp_weights(x: torch.Tensor, n, c: float = 0.75, *, method: str = "auto",
                 levels: int = 256) -> torch.Tensor:
    """Hard-cut-off GWRP weights in voxel order (sum 1 over the top-n ranks).
    `method`: "exact" sorts, "binned" ranks by value bins, "auto" takes the
    exact one up to 64³ voxels."""
    if method == "auto":
        method = "exact" if x.numel() <= 64 ** 3 else "binned"
    if method == "exact":
        return gwrp_weights_exact(x, n, c)
    return gwrp_weights_binned(x, n, c, levels=levels)
