"""Spatial sharding: the depth of every volume (the rows of every 2D
slice) split over the ranks of a model group (the port's counterpart of
``spatial_constraint`` and ``gather_spatial`` in
``rsuper_tpu/parallel/mesh.py``).

The JAX package annotates the batch with depth sharded over the mesh's
``model`` axis and lets GSPMD partition the convs (halo exchanges) and the
instance norms (cross-shard sums). The port does the same by hand. Rank m
of a model group of S ranks holds depth planes ``[m·D/S, (m+1)·D/S)`` of
its data rank's items, and the model's sharded stages compute on them with
these autograd functions:

* ``shard_depth``: the rank's planes of a tensor every rank holds whole;
  its backward pads the gradient with zeros to the whole depth;
* ``gather_depth``: the whole depth from every rank's planes (an
  ``all_gather``); its backward sums the ranks' gradients and keeps the
  rank's planes (a reduce-scatter, as ``all_reduce`` and a slice);
* ``halo_exchange(x, lo, hi, sp)``: x with its neighbours' ``lo`` planes
  below and ``hi`` planes above, zeros beyond the volume's outer faces
  (``outer="zeros"``) or nothing there (``outer="drop"``, where the
  kernel's own SAME padding serves the face); its backward returns the
  halo planes' gradients to their owners and adds them there;
* ``reduce_sum``: the instance norms' cross-shard sums (no autograd: the
  norms' backwards sum their own means);
* ``group_sum``: a sum over the group with autograd (the
  squeeze-and-excitation mean): its backward sums the ranks' partial
  gradients, as the norms' backwards sum theirs.

A stage that mixes the whole volume (attention, shifted windows, a ViT)
runs on ``gather_depth``'s whole volumes on every rank of the group, and
``shard_depth`` takes the rank's planes of its output: the stage's
gradient partials then sum over the group as a sharded stage's do.

Every exchange is an ``all_gather`` or an ``all_reduce`` on the model
group, which NCCL and gloo both run on CUDA tensors. ``TRAFFIC`` counts
the calls and bytes of each kind of traffic (``halo``, ``norm``,
``gather``, and ``reduce``, the step's gradient reduction in
``mesh.all_reduce_mean_``); with ``TIMED`` set each collective is also
timed between two device synchronisations.

Gradient convention: every rank seeds its backward with 1/S of the
replicated loss. A parameter's ``.grad`` is then a partial whose sum over
the model group is the data rank's gradient (``mesh.all_reduce_mean_``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List

import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class Spatial:
    """This rank's place in its model group: the group's ranks split the
    depth (axis 1) of every sharded tensor, rank ``rank`` of ``size``
    holding the ``rank``-th run of equal length. ``group`` is the
    ``torch.distributed`` process group (None: the default group)."""

    rank: int
    size: int
    group: Any = None

    def halo(self, lo: int, hi: int):
        """(low, high) planes a ``outer="drop"`` exchange adds: none at an
        outer face."""
        return (lo if self.rank > 0 else 0,
                hi if self.rank < self.size - 1 else 0)


# ------------------------------------------------------ raw collectives
KINDS = ("halo", "norm", "gather", "reduce")
# calls, bytes (this rank's input) and, while TIMED, ms of the collectives
# by kind since the last ``reset_traffic``
TRAFFIC = {k: dict(calls=0, bytes=0, ms=0.0) for k in KINDS}
TIMED = False


def reset_traffic() -> None:
    for rec in TRAFFIC.values():
        rec.update(calls=0, bytes=0, ms=0.0)


def collective(kind: str, t: torch.Tensor, run):
    """``run()``, one collective of `kind` on this rank's `t`, counted in
    ``TRAFFIC`` (and timed while ``TIMED``)."""
    rec = TRAFFIC[kind]
    rec["calls"] += 1
    rec["bytes"] += t.numel() * t.element_size()
    if not TIMED:
        return run()
    sync = t.is_cuda
    if sync:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = run()
    if sync:
        torch.cuda.synchronize(t.device)
    rec["ms"] += 1e3 * (time.perf_counter() - t0)
    return out


def _all_gather(t: torch.Tensor, sp: Spatial, kind: str) -> List[torch.Tensor]:
    """Every rank's `t` (one shape on all ranks), in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(sp.size)]
    collective(kind, t, lambda: dist.all_gather(parts, t, group=sp.group))
    return parts


def _all_reduce_(t: torch.Tensor, sp: Spatial, kind: str) -> torch.Tensor:
    """`t` summed over the group in place (`t` contiguous)."""
    collective(kind, t, lambda: dist.all_reduce(t, group=sp.group))
    return t


def reduce_sum(t: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """A copy of `t` summed over the model group, no autograd: the
    cross-shard sums of the instance norms."""
    return _all_reduce_(t.detach().contiguous().clone(), sp, "norm")


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, sp):
        ctx.sp = sp
        return reduce_sum(t, sp)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.sp), None


def group_sum(t: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """`t` summed over the model group, differentiable: every rank computes
    on the sum, so each rank's gradient of it is a partial, and the
    backward sums them (the gradient of each rank's own term)."""
    return _GroupSum.apply(t, sp)


# ------------------------------------------------------------- halos
def _narrow(x, start: int, n: int):
    return x.narrow(1, start, n)


def halo_planes(x: torch.Tensor, lo: int, hi: int, sp: Spatial,
                outer: str = "zeros") -> torch.Tensor:
    """The slab of `x` (depth axis 1) with `lo` planes of the rank below
    and `hi` of the rank above; beyond the volume's faces zeros
    (``outer="zeros"``) or nothing (``"drop"``); `x` itself without
    `sp`. No autograd."""
    if sp is None or lo == hi == 0:
        return x
    d = x.shape[1]
    if lo > d or hi > d:
        raise ValueError(f"a halo of ({lo}, {hi}) planes needs at least as "
                         f"many local planes, got {d}")
    send = torch.cat([_narrow(x, 0, hi), _narrow(x, d - lo, lo)], dim=1)
    parts = _all_gather(send, sp, "halo")
    pieces = []
    if sp.rank > 0:
        pieces.append(_narrow(parts[sp.rank - 1], hi, lo))
    elif outer == "zeros":
        pieces.append(x.new_zeros((x.shape[0], lo, *x.shape[2:])))
    pieces.append(x)
    if sp.rank < sp.size - 1:
        pieces.append(_narrow(parts[sp.rank + 1], 0, hi))
    elif outer == "zeros":
        pieces.append(x.new_zeros((x.shape[0], hi, *x.shape[2:])))
    return torch.cat(pieces, dim=1)


def halo_return(g: torch.Tensor, lo: int, hi: int, sp: Spatial,
                outer: str = "zeros") -> torch.Tensor:
    """The backward of ``halo_planes``: the gradient of the rank's own
    planes, with the gradients that its neighbours' halos took of them
    added. No autograd."""
    if sp is None or lo == hi == 0:
        return g
    lo_e, hi_e = (lo, hi) if outer == "zeros" else sp.halo(lo, hi)
    d = g.shape[1] - lo_e - hi_e
    mine = _narrow(g, lo_e, d).contiguous().clone()
    low = (_narrow(g, 0, lo) if sp.rank > 0
           else g.new_zeros((g.shape[0], lo, *g.shape[2:])))
    high = (_narrow(g, lo_e + d, hi) if sp.rank < sp.size - 1
            else g.new_zeros((g.shape[0], hi, *g.shape[2:])))
    parts = _all_gather(torch.cat([low, high], dim=1), sp, "halo")
    if sp.rank < sp.size - 1 and lo:  # the rank above took my top planes
        _narrow(mine, d - lo, lo).add_(_narrow(parts[sp.rank + 1], 0, lo))
    if sp.rank > 0 and hi:  # the rank below took my bottom planes
        _narrow(mine, 0, hi).add_(_narrow(parts[sp.rank - 1], lo, hi))
    return mine


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, sp, outer):
        ctx.args = (lo, hi, sp, outer)
        return halo_planes(x.detach(), lo, hi, sp, outer)

    @staticmethod
    def backward(ctx, g):
        return halo_return(g, *ctx.args), None, None, None, None


def halo_exchange(x: torch.Tensor, lo: int, hi: int, sp: Spatial,
                  outer: str = "zeros") -> torch.Tensor:
    """`x` (depth axis 1) with its neighbours' `lo` planes below and `hi`
    above, differentiable (``halo_planes``, ``halo_return``)."""
    if lo == hi == 0:
        return x
    return _Halo.apply(x, lo, hi, sp, outer)


# ---------------------------------------------------------- shards
class _ShardDepth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        d = x.shape[1] // sp.size
        ctx.whole, ctx.start = x.shape, sp.rank * d
        return _narrow(x.detach(), ctx.start, d).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.whole)
        _narrow(out, ctx.start, g.shape[1]).copy_(g)
        return out, None


def shard_depth(x: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """The rank's run of depth planes of `x`, which every rank of the
    group holds whole; the depth must divide by the group's size. `x`
    itself without `sp`."""
    if sp is None:
        return x
    if x.shape[1] % sp.size:
        raise ValueError(f"depth {x.shape[1]} does not divide over "
                         f"{sp.size} spatial shards")
    return _ShardDepth.apply(x, sp)


class _GatherDepth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp, ctx.d = sp, x.shape[1]
        return torch.cat(_all_gather(x.detach(), sp, "gather"), dim=1)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_(g.contiguous().clone(), ctx.sp, "gather")
        return _narrow(g, ctx.sp.rank * ctx.d, ctx.d).contiguous(), None


def gather_depth(x: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """The whole depth of a sharded tensor on every rank of the group; `x`
    itself without `sp`."""
    return x if sp is None else _GatherDepth.apply(x, sp)


def gather_segmentation(out: dict, sp: Spatial, depth: int) -> dict:
    """The model's outputs with every segmentation head that is sharded
    (its axis 1 the local `depth`: a volume's (B, D, H, W, C) or a 2D
    model's (B, H, W, C) rows) gathered whole: the model/loss boundary
    (``gather_spatial``)."""
    seg = out.get("segmentation")
    if seg is None:
        return out

    def whole(t):
        return (gather_depth(t, sp) if t is not None and t.dim() in (4, 5)
                and t.shape[1] == depth else t)

    if isinstance(seg, (list, tuple)):
        return {**out, "segmentation": [whole(t) for t in seg]}
    return {**out, "segmentation": whole(seg)}
