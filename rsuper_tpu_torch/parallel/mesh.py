"""The data axis as ``torch.distributed`` data parallelism (the port's
counterpart of ``rsuper_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``(data, model)`` mesh: the global
batch is sharded over ``data`` and XLA computes the exact loss of the global
batch and its exact gradient. The port runs one process a rank, each with
``batch_size / world`` items, and gets the same step this way:

* every loss term of the global batch is the mean over the ranks of the
  term that a rank computes on its items, once the terms that couple the
  batch read the whole group: the adaptive-Tversky ``alpha`` sums its
  counts over the ranks (``sum_over_ranks``), and the CLIP loss takes its
  negatives from every rank's embeddings (``gather_rows``). Both carry
  their gradient back across the ranks, so rank r's backward gives rank r's
  share of the global gradient;
* the gradients are then averaged over the ranks (``all_reduce_mean_``),
  which gives every rank the gradient of the global-batch loss;
* the logged terms are the mean over the ranks of the ranks' terms,
  summed in rank order (``mean_over_ranks``), so every rank logs the same
  bits.

ZeRO-1 (``zero_partition``, ``shard``, ``gather_shards``,
``gather_tree``)
keeps the optimizer state and, with ``zero_ema``, the EMA copy of each large
parameter as one slice a rank, split along the axis that the JAX package's
``zero_sharding_tree`` picks.

The collectives here are the port's own autograd functions on
``all_reduce`` and ``all_gather``, which NCCL and gloo (also on CUDA
tensors) both have. Spatial sharding (the mesh's ``model`` axis) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

# the gradient all-reduce goes in buckets of about this many bytes
BUCKET_BYTES = 25 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the data-parallel group, the default process
    group of ``torch.distributed``: its rank and the number of ranks. The
    rank's device is the one its tensors are on (``torch.cuda.set_device``
    of ``multihost.init_distributed``)."""

    rank: int = 0
    world: int = 1


def current() -> Optional[DataParallel]:
    """The data-parallel group of this process once ``torch.distributed``
    is initialised (also at world size 1), else None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return DataParallel(rank=dist.get_rank(), world=dist.get_world_size())


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
        dist.all_gather(parts, flat)
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
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
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
        dist.all_gather(parts, x)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g.narrow(0, ctx.dp.rank * ctx.rows, ctx.rows), None


def gather_rows(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """Every rank's rows of `x` in rank order, differentiable: the global
    batch of a term that compares each item with all the others."""
    return _GatherRows.apply(x, dp)


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor], dp: DataParallel,
                     bucket_bytes: int = BUCKET_BYTES) -> int:
    """Average `tensors` over the ranks in place, in buckets of about
    `bucket_bytes` (one flat buffer and one ``all_reduce`` a bucket);
    returns the bytes reduced."""
    tensors = list(tensors)
    for bucket in _buckets(tensors, tensors, bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat.mul_(1.0 / dp.world)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
    return sum(t.numel() * t.element_size() for t in tensors)


@torch.no_grad()
def mean_over_ranks(values: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The mean over the ranks of `values`, summed in rank order on every
    rank, so that every rank holds the same bits."""
    values = values.detach().contiguous()
    parts = [torch.empty_like(values) for _ in range(dp.world)]
    dist.all_gather(parts, values)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total / dp.world
