"""Top-N voxel selection by a value threshold (counterpart of
``rsuper_tpu/ops/selection.py``).

The reference selects the N highest-valued voxels of a masked volume with
``topk`` for a data-dependent N. Here the threshold t with ``count(x ≥ t) ≈
n`` is found by bisection — `iters` passes of a count — and the mask is
``(x ≥ t) & (x > 0)``: voxels that are exactly zero are never selected. If
fewer than n voxels are positive, the mask holds every positive voxel
(callers handle the shortfall). With continuous network outputs ties have
measure zero, so the selected count is within the bisection's resolution of
n.

``topn_threshold`` is the bisection itself, step for step, in plain PyTorch.
The masks take their thresholds from ``ops/topn.py``: the CUDA kernels on
CUDA tensors, the plain bisection on CPU tensors; both give the same bits.
Nothing here is differentiable.
"""

from __future__ import annotations

import torch

from .topn import topn_threshold_multi, topn_threshold_multi_batched


@torch.no_grad()
def topn_threshold(x: torch.Tensor, n, *, iters: int = 26,
                   hi=None) -> torch.Tensor:
    """The bisection's largest threshold t in [0, hi] with ``count(x ≥ t) ≥
    n`` (`hi` defaults to max x). A float32 scalar tensor."""
    x = x.float()
    n = torch.as_tensor(n, dtype=torch.float32, device=x.device)
    hi = x.max() if hi is None else torch.as_tensor(
        hi, dtype=torch.float32, device=x.device)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = (x >= mid).sum() >= n
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def _masks(x: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """x (..., *spatial) against thresholds ts (..., K) → (..., K, *spatial)."""
    lead = ts.dim() - 1
    xb = x.detach().unsqueeze(lead)
    ts = ts.reshape(ts.shape + (1,) * (x.dim() - lead))
    return ((xb >= ts) & (xb > 0)).float()


@torch.no_grad()
def topn_mask(x: torch.Tensor, n, *, iters: int = 26) -> torch.Tensor:
    """Binary float32 mask over the ~n largest strictly positive entries of
    `x` (any shape)."""
    n = torch.as_tensor(n, dtype=torch.float32, device=x.device).reshape(1)
    return _masks(x, topn_threshold_multi(x, n, iters=iters))[0]


@torch.no_grad()
def topn_masks_multi(x: torch.Tensor, ns, *, iters: int = 26) -> torch.Tensor:
    """Stack of binary masks (K, *x.shape), one per n in `ns` (K,); the K
    bisections share one kernel launch."""
    return _masks(x, topn_threshold_multi(x, ns, iters=iters))


@torch.no_grad()
def topn_masks_multi_batched(x: torch.Tensor, ns, *,
                             iters: int = 26) -> torch.Tensor:
    """x (B, *spatial), ns (B, K) → masks (B, K, *spatial); one kernel launch
    for the whole batch."""
    return _masks(x, topn_threshold_multi_batched(x, ns, iters=iters))
