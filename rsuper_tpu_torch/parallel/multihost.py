"""Several processes in one training job (the port's counterpart of
``rsuper_tpu/parallel/multihost.py``).

The process mapping differs from the JAX package's, since PyTorch runs one
process a GPU where JAX runs one a host:

* ``--dist_num_processes`` is the number of ranks (GPUs) and
  ``--dist_process_id`` the global rank;
* ``--local_device_ids`` names the one card of this rank (a list raises);
  without it a rank takes card ``rank % torch.cuda.device_count()``;
* ``--dist_coordinator host:port`` is rank 0's TCP store.

Rank r loads items r, r + world, ... of every global batch (the samplers'
``shard=r``, ``num_shards=world``) and augments each with the draws of its
place in the global batch (``local_rows``); rank 0 writes the checkpoints.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def local_device_id(local_device_ids: Optional[str]) -> Optional[int]:
    """The one card id of ``--local_device_ids``, None when absent."""
    if local_device_ids is None:
        return None
    ids = [s.strip() for s in str(local_device_ids).split(",") if s.strip()]
    if len(ids) != 1:
        raise ValueError(
            f"--local_device_ids {local_device_ids!r}: the port runs one "
            "process a GPU, so each process takes exactly one device id "
            "(JAX runs one process a host with a list)")
    return int(ids[0])


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_device_ids: Optional[str] = None,
                     device="cuda") -> Tuple[int, int, torch.device]:
    """Connect this process to the job and return (rank, world, device).

    `coordinator` is ``host:port`` of rank 0's TCP store. On `device` cuda
    (the default; it raises without CUDA) the rank takes its card and talks
    NCCL, on the CPU gloo. A first collective on the device connects every
    rank before any work, as JAX's ``sync_global_devices`` does."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = local_device_id(local_device_ids)
        if local is None:
            local = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    else:
        local_device_id(local_device_ids)  # a list raises here too
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    probe = torch.ones((), device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != num_processes:
        raise RuntimeError(f"the first all_reduce over {num_processes} "
                           f"ranks gave {probe.item()}")
    return dist.get_rank(), dist.get_world_size(), dev


def process_info() -> Tuple[int, int]:
    """(rank, world) of this process; (0, 1) outside a job."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    return process_info()[0] == 0


def local_rows(batch_size: int, rank: int, world: int) -> np.ndarray:
    """The places in the global batch of `batch_size` of rank `rank`'s
    items: the samplers give rank r the items r, r + world, ..., so its
    items take the global batch's draws at these places (the counterpart of
    ``global_key_slices``)."""
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} must divide over "
                         f"{world} ranks")
    return np.arange(rank, batch_size, world)
