"""The ``(data, model)`` rank grid as ``torch.distributed`` process groups
(the port's counterpart of ``rsuper_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``(data, model)`` mesh: the global
batch is sharded over ``data``, each volume's depth over ``model``, and XLA
computes the exact loss of the global batch and its exact gradient. The
port runs one process a rank. Ranks form a ``data × model`` grid, rank =
d·S + m for S = ``spatial_shard`` (the JAX mesh's reshape of its devices),
with one ``data`` group (the ranks of one m) and one ``model`` group (the
ranks of one d) per rank (``grid``). The ranks of model group d hold the
same ``batch_size / data`` items, data rank d's, and split their depth
(``parallel/spatial.py``). The step is then the JAX step:

* every loss term of the global batch is the mean over the data ranks of
  the term that a data rank computes on its items, once the terms that
  couple the batch read the whole data group: the adaptive-Tversky
  ``alpha`` sums its counts over the data ranks (``sum_over_ranks``), and
  the CLIP loss takes its negatives from every data rank's embeddings
  (``gather_rows``). Both carry their gradient back across the ranks;
* each rank's backward gives its share of the global gradient: with S > 1
  a partial whose sum over the model group is the data rank's share
  (``spatial.py``'s convention). ``all_reduce_mean_`` sums the gradients
  over every rank and divides by the data ranks: the sum over the model
  group and the mean over the data group, one ``all_reduce``;
* the logged terms are the mean over the data ranks of their terms,
  summed in rank order (``mean_over_ranks``), so every rank logs the same
  bits.

ZeRO-1 (``zero_partition``, ``shard``, ``gather_shards``,
``gather_tree``)
keeps the optimizer state and, with ``zero_ema``, the EMA copy of each large
parameter as one slice a data rank, split along the axis that the JAX
package's ``zero_sharding_tree`` picks; the ranks of a model group hold the
same slices.

The collectives here are the port's own autograd functions on
``all_reduce`` and ``all_gather``, which NCCL and gloo (also on CUDA
tensors) both have; each names its process group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from .spatial import Spatial, collective

# the gradient all-reduce goes in buckets of about this many bytes
BUCKET_BYTES = 25 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the rank grid: its ``rank`` in its data
    group of ``world`` ranks and that group (``group``; None: the default
    group, every rank), and with spatial sharding its place in its model
    group (``spatial``: rank, size and group). The rank's device is the one
    its tensors are on (``torch.cuda.set_device`` of
    ``multihost.init_distributed``)."""

    rank: int = 0
    world: int = 1
    group: Any = None
    spatial: Optional[Spatial] = None


_GRIDS: Dict[int, DataParallel] = {}


def grid(spatial_shard: int) -> DataParallel:
    """This rank's place in the ``data × model`` grid of the job with
    `spatial_shard` = S ranks a model group: rank = d·S + m. The groups
    are made once a job (``dist.new_group`` on every rank, in the same
    order) and kept; S = 1 is the default group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if spatial_shard <= 1:
        return DataParallel(rank=rank, world=world)
    if world % spatial_shard:
        raise ValueError(f"spatial_shard {spatial_shard} must divide the "
                         f"{world} available devices")
    if spatial_shard not in _GRIDS:
        S, data = spatial_shard, world // spatial_shard
        mine = {}
        for m in range(S):  # data groups: the ranks of one m
            g = dist.new_group([d * S + m for d in range(data)])
            if rank % S == m:
                mine["data"] = g
        for d in range(data):  # model groups: the ranks of one d
            g = dist.new_group([d * S + m for m in range(S)])
            if rank // S == d:
                mine["model"] = g
        _GRIDS[S] = DataParallel(
            rank=rank // S, world=data, group=mine["data"],
            spatial=Spatial(rank=rank % S, size=S, group=mine["model"]))
    return _GRIDS[spatial_shard]


def current(spatial_shard: int = 1) -> Optional[DataParallel]:
    """This process's place in the rank grid once ``torch.distributed`` is
    initialised (also at world size 1), else None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return grid(spatial_shard)


def forget_grids() -> None:
    """Drop the kept groups (a job's end: ``destroy_process_group``)."""
    _GRIDS.clear()


def data_parallel_size(batch_size: int, n_devices: int) -> int:
    """The number of data-parallel ranks for `batch_size` on `n_devices`:
    the largest count that divides the batch, ``gcd(batch_size,
    n_devices)``, the JAX loop's rule for its data axis."""
    return math.gcd(batch_size, n_devices)


def zero_partition(params: Mapping[str, torch.Tensor], world: int,
                   min_size: int = 16384) -> Dict[str, Optional[int]]:
    """The axis along which ZeRO-1 splits each parameter over `world`
    ranks, or None where it stays whole on every rank: a tensor of at least
    `min_size` elements is split along its largest dimension that `world`
    divides (the first of equal ones), the others stay replicated. This is
    ``zero_sharding_tree``'s rule, on the port's layout of each tensor: the
    same tensors are split, along a dimension of the same size."""
    out = {}
    for name, p in params.items():
        shape = tuple(p.shape)
        out[name] = None
        if shape and math.prod(shape) >= min_size:
            for a in sorted(range(len(shape)), key=lambda a: -shape[a]):
                if shape[a] % world == 0:
                    out[name] = a
                    break
    return out


def shard(t: torch.Tensor, axis: int, dp: DataParallel) -> torch.Tensor:
    """Rank ``dp.rank``'s slice of `t` along `axis` (a view)."""
    size = t.shape[axis] // dp.world
    return t.narrow(axis, dp.rank * size, size)


def _buckets(items: Sequence, tensors: Sequence[torch.Tensor],
             bucket_bytes: int):
    """`items` in consecutive runs whose `tensors` hold about
    `bucket_bytes` together (at least one item a run)."""
    run, size = [], 0
    for item, t in zip(items, tensors):
        nbytes = t.numel() * t.element_size()
        if run and size + nbytes > bucket_bytes:
            yield run
            run, size = [], 0
        run.append(item)
        size += nbytes
    if run:
        yield run


@torch.no_grad()
def gather_shards(slices: Sequence[torch.Tensor],
                  axes: Sequence[int], dp: DataParallel,
                  bucket_bytes: int = BUCKET_BYTES) -> List[torch.Tensor]:
    """The whole tensors of every rank's `slices` (each split along its
    entry of `axes`; one type), gathered in buckets of about `bucket_bytes`
    of this rank's slices: one ``all_gather`` of a flat buffer a bucket."""
    out: List[torch.Tensor] = []
    for bucket in _buckets(range(len(slices)), slices, bucket_bytes):
        flat = torch.cat([slices[i].reshape(-1) for i in bucket])
        parts = [torch.empty_like(flat) for _ in range(dp.world)]
        dist.all_gather(parts, flat, group=dp.group)
        offset = 0
        for i in bucket:
            n = slices[i].numel()
            out.append(torch.cat([q[offset:offset + n].view(slices[i].shape)
                                  for q in parts], dim=axes[i]))
            offset += n
    return out


def gather_tree(tree: Mapping[str, torch.Tensor],
                partition: Mapping[str, Optional[int]],
                dp: DataParallel) -> Dict[str, torch.Tensor]:
    """Whole tensors of a tree whose entries are split as `partition` says
    (the others pass through): for validation, export and checkpoints.
    Every rank must call it."""
    split = [k for k in tree if partition.get(k) is not None]
    whole = dict(zip(split, gather_shards(
        [tree[k] for k in split], [partition[k] for k in split], dp)))
    return {k: whole.get(k, v) for k, v in tree.items()}


class _SumOverRanks(torch.autograd.Function):
    """y = Σ over ranks of x; the gradient of every rank's x is the sum of
    the ranks' gradients of y."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        y = x.detach().clone()
        dist.all_reduce(y, group=dp.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.dp.group)
        return g, None


def sum_over_ranks(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable: the statistic of the
    global batch that a batch-coupled loss term reads."""
    return _SumOverRanks.apply(x, dp)


class _GatherRows(torch.autograd.Function):
    """The ranks' (b, ...) tensors stacked in rank order, (world·b, ...);
    each rank's gradient is the sum of the ranks' gradients of its rows."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp, ctx.rows = dp, x.shape[0]
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(dp.world)]
        dist.all_gather(parts, x, group=dp.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.dp.group)
        return g.narrow(0, ctx.dp.rank * ctx.rows, ctx.rows), None


def gather_rows(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """Every rank's rows of `x` in rank order, differentiable: the global
    batch of a term that compares each item with all the others."""
    return _GatherRows.apply(x, dp)


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor], dp: DataParallel,
                     bucket_bytes: int = BUCKET_BYTES) -> int:
    """Sum `tensors` over every rank and divide by the data ranks, in
    place: the mean over the data group of the sums over the model group
    (the plain mean without spatial sharding). In buckets of about
    `bucket_bytes` (one flat buffer and one ``all_reduce`` over the
    default group a bucket); returns the bytes reduced."""
    tensors = list(tensors)
    for bucket in _buckets(tensors, tensors, bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective("reduce", flat, lambda: dist.all_reduce(flat))
        flat.mul_(1.0 / dp.world)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
    return sum(t.numel() * t.element_size() for t in tensors)


@torch.no_grad()
def mean_over_ranks(values: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The mean over the data ranks of `values`, summed in rank order on
    every rank, so that every rank holds the same bits."""
    values = values.detach().contiguous()
    parts = [torch.empty_like(values) for _ in range(dp.world)]
    dist.all_gather(parts, values, group=dp.group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total / dp.world
