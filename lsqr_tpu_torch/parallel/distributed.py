"""Multi-process entry points.

PyTorch counterpart of :mod:`lsqr_tpu.parallel.distributed`. The pattern is
single-program multiple-data: every process runs the same program,
:func:`initialize_distributed` joins them into one ``torch.distributed``
world, and the mesh of :mod:`.sharding` spans every rank of it; no process
stands above the ranks. The backend is named, never switched in silence:
NCCL for ranks on cards (one card a rank: NCCL refuses two ranks on one
card), gloo for ranks on the CPU (gloo also takes CUDA tensors, staged
through the host, so several ranks can share one card under gloo).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .sharding import lsqr_sharded, make_mesh

__all__ = ["initialize_distributed", "global_mesh", "lsqr_multihost"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> None:
    """Join this process to the distributed world (idempotent).

    ``coordinator_address``: ``host:port`` of rank 0 (a TCP rendezvous), or
    an init URL (``tcp://...``, ``file://...``); None reads torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). ``backend``: "nccl" or "gloo"; None takes NCCL where a card
    is present and gloo where none is. A NCCL rank uses the card
    ``LOCAL_RANK`` (the rank modulo the card count without it). A second
    call returns at once, unless it names another backend than the world's,
    which raises ValueError."""
    import torch.distributed as dist

    if dist.is_initialized():
        if backend is not None and dist.get_backend() != backend:
            raise ValueError(f"the world runs {dist.get_backend()}, not {backend}")
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    world = -1 if num_processes is None else int(num_processes)
    rank = -1 if process_id is None else int(process_id)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())


def global_mesh(axis_name: str = "rows"):
    """A 1-D mesh over every rank of every process (u/b row-split over the
    whole world)."""
    return make_mesh(axis_name=axis_name)


def lsqr_multihost(A, b, damp: float = 0.0, **kwargs):
    """Row-partitioned solve over every rank of the world. Call it from all
    processes with the same A and b; every process gets the same result.

    This is :func:`lsqr_tpu_torch.parallel.lsqr_sharded` on the global
    mesh."""
    mesh = kwargs.pop("mesh", None) or global_mesh(kwargs.get("axis_name", "rows"))
    return lsqr_sharded(A, b, damp, mesh=mesh, **kwargs)
