"""Multi-process initialization and the per-process mesh, on
``torch.distributed``.

Counterpart of :mod:`jrlqp_tpu.parallel.distributed` (distributed.py:30-68).
Where the JAX package builds one global mesh over every chip of every host,
each torch process drives its own devices: it builds its shards of the
global batch with :func:`process_local_batch_slice`, solves them over
:func:`global_mesh` with :func:`~jrlqp_tpu_torch.parallel.mesh.
solve_sharded`, and the statistics are all-reduced across the processes::

    from jrlqp_tpu_torch.parallel import distributed, solve_sharded
    distributed.initialize("10.0.0.1:29500", num_processes=2, process_id=r)
    mesh = distributed.global_mesh()
    sl = distributed.process_local_batch_slice(global_batch)
    res, stats = solve_sharded(local_problems, opt, mesh=mesh)  # stats global
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

__all__ = ["initialize", "global_mesh", "process_local_batch_slice"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Initialize the default process group when running multi-process.

    A no-op for a single process (``num_processes`` <= 1, or no arguments
    and no ``WORLD_SIZE`` > 1 in the environment) and when the group is
    already initialized. ``coordinator_address`` is ``host:port`` of rank
    0; without it the environment (``MASTER_ADDR``/``MASTER_PORT``, as
    ``torchrun`` sets them) is read. ``backend`` defaults to nccl when a
    CUDA device is visible, else gloo. An explicit multi-process setup that
    fails raises."""
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        init_method = "env://"
    else:
        init_method = (f"tcp://{coordinator_address}" if coordinator_address
                       else "env://")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend, init_method=init_method, **kw)


def global_mesh(axis: str = "batch") -> Mesh:
    """1-D mesh over this process's CUDA devices (those it can see; give
    each process its own with ``CUDA_VISIBLE_DEVICES``). The statistics of
    a solve on it are all-reduced over every process of the group."""
    return make_mesh(axis=axis)


def process_local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch this process builds and solves: equal
    contiguous parts by rank."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)
