"""Process-group and mesh helpers for one card, several cards and several
processes."""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..knn.sharded import Mesh, make_mesh

logger = logging.getLogger(__name__)


def local_devices() -> List[torch.device]:
    """The cards of this process, from torchrun's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` and the n visible cards: a contiguous block of
    ``n // LOCAL_WORLD_SIZE`` cards when n >= ``LOCAL_WORLD_SIZE``, else
    card ``LOCAL_RANK % n``; every visible card when either variable is
    unset (one process a host, as the JAX package has it)."""
    n = torch.cuda.device_count()
    local_rank = os.environ.get("LOCAL_RANK")
    local_world = os.environ.get("LOCAL_WORLD_SIZE")
    if local_rank is None or local_world is None or n == 0:
        ids = range(n)
    elif n >= int(local_world):
        per = n // int(local_world)
        ids = range(int(local_rank) * per, (int(local_rank) + 1) * per)
    else:
        ids = [int(local_rank) % n]
    return [torch.device("cuda", i) for i in ids]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the ``torch.distributed`` process group of ``num_processes``
    processes as rank ``process_id``, through ``coordinator_address``
    (``host:port``): NCCL when a card is visible, gloo otherwise.  Before
    a NCCL group starts, this process's current card becomes the first of
    :func:`local_devices`.

    A no-op when a group is already initialised, and in a single process
    unless an address is given.  A failed start raises."""
    if dist.is_initialized():
        return
    if not coordinator_address:
        if num_processes is not None and num_processes > 1:
            raise ValueError("several processes need a coordinator_address "
                             "(host:port)")
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_devices()[0])
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes or 1,
                            rank=process_id or 0)
    logger.info("torch.distributed initialized (%s): rank %d of %d",
                backend, dist.get_rank(), dist.get_world_size())


def auto_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (q, d) mesh over the first ``n_devices`` of ``devices`` (default:
    this process's cards, :func:`local_devices`).  The database axis ``d``
    takes them all but one factor of 2, which goes to the query axis ``q``
    when n >= 4 and even."""
    if devices is None:
        devices = local_devices()
    n = n_devices or len(devices)
    q_shards, d_shards = 1, n
    if n >= 4 and n % 2 == 0:
        q_shards, d_shards = 2, n // 2
    return make_mesh(q_shards, d_shards, devices=devices[:n])


def device_summary() -> str:
    """The visible devices, counted by name, and the processes."""
    names = [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())] or ["cpu"]
    kinds = {}
    for name in names:
        kinds[name] = kinds.get(name, 0) + 1
    world = dist.get_world_size() if dist.is_initialized() else 1
    return (f"{len(names)} device(s) across {world} process(es): "
            + ", ".join(f"{v}x {k}" for k, v in kinds.items()))
