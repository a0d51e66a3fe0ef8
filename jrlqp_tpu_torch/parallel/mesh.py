"""Device-mesh sharding of QP batches.

Counterpart of :mod:`jrlqp_tpu.parallel.mesh` (mesh.py:30-142). The GI
method needs no communication between problems, so a batch is split along
its leading dimension into contiguous shards, each solved on its own
device by the chosen engine; the only reduction is the convergence
accounting of :class:`BatchStats`, a sum and a max over the shards and, when
``torch.distributed`` is initialized, one ``all_reduce(SUM)`` and one
``all_reduce(MAX)`` across the processes.

A :class:`Mesh` is an ordered list of ``torch.device``s and an axis name.
:func:`make_mesh` takes the CUDA devices and raises where there are fewer
than asked; a mesh of CPU devices must be asked for by name
(``make_mesh(devices=[torch.device("cpu")] * 8)``), which is how the tests
run the shard and gather code without a card. A mesh may name one device
several times (four shards on ``cuda:0``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..problems import QPProblem
from ..solver.dense import solve_batch
from ..solver.fast import solve_refined, solve_refined_kernel
from ..solver.state import GIResult
from ..types import SUCCESS, SolverOptions

__all__ = ["Mesh", "make_mesh", "shard_batch", "solve_sharded", "BatchStats"]

ENGINES = ("f64", "refined", "pallas")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices the shards of a batch go to, in order."""

    devices: tuple[torch.device, ...]
    axis: str = "batch"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices``, by default of
    every CUDA device. Raises where fewer devices exist than asked (the JAX
    package falls back to the CPU there, mesh.py:37-40; here that would
    hide the card)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have == 0:
            raise RuntimeError("make_mesh: no CUDA device (pass devices= to "
                               "build a mesh of other devices)")
        devices = [torch.device("cuda", i) for i in range(have)]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(f"make_mesh: need {n_devices} devices, have "
                               f"{len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devices=devices, axis=axis)


def shard_batch(pbs: QPProblem, mesh: Mesh) -> list[QPProblem]:
    """The batch split along its leading dimension into ``mesh.size``
    contiguous shards of near-equal size (the first ones one lane larger
    where it does not divide), each moved to its device."""
    parts = [torch.tensor_split(getattr(pbs, f.name), mesh.size)
             for f in dataclasses.fields(QPProblem)]
    return [QPProblem(**{f.name: parts[k][i].to(dev) for k, f in
                         enumerate(dataclasses.fields(QPProblem))})
            for i, dev in enumerate(mesh.devices)]


@dataclasses.dataclass(frozen=True)
class BatchStats:
    """Convergence accounting reduced over every shard (and every process
    when ``torch.distributed`` is initialized): total iterations,
    SUCCESS count, max iterations."""

    total_iterations: int
    n_success: int
    max_iterations: int


def _solve_shard(pb: QPProblem, opt: SolverOptions, engine: str,
                 fused_init: bool) -> GIResult:
    if engine == "pallas":
        return solve_refined_kernel(pb, opt, fused_init=fused_init)
    if engine == "refined":
        return solve_refined(pb, opt)
    return solve_batch(pb, opt)


def _stats(res: GIResult) -> BatchStats:
    """The statistics of ``res``, all-reduced across the processes of an
    initialized process group."""
    it = res.iterations.long()
    vals = torch.stack([it.sum(), (res.status == SUCCESS).sum(),
                        it.max() if it.numel() else it.new_zeros(())])
    if dist.is_available() and dist.is_initialized():
        dev = (res.x.device if dist.get_backend() == "nccl"
               else torch.device("cpu"))
        sums, mx = vals[:2].to(dev), vals[2:].to(dev)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX)
        vals = torch.cat([sums, mx])
    total, n_ok, max_it = (int(v) for v in vals.cpu())
    return BatchStats(total_iterations=total, n_success=n_ok,
                      max_iterations=max_it)


def solve_sharded(
    pbs: QPProblem,
    opt: SolverOptions = SolverOptions(),
    mesh: Optional[Mesh] = None,
    axis: str = "batch",
    engine: str = "f64",
    fused_init: bool = False,
) -> tuple[GIResult, BatchStats]:
    """Solve a batch of QPs sharded over a device mesh (counterpart of
    ``jrlqp_tpu.parallel.solve_sharded``).

    Each shard runs the chosen engine on its device: ``"f64"`` the J/R
    engine (:func:`jrlqp_tpu_torch.solver.dense.solve_batch`),
    ``"refined"`` the f32 torch loop with f64 refinement
    (:func:`~jrlqp_tpu_torch.solver.fast.solve_refined`), ``"pallas"``
    the kernel path :func:`~jrlqp_tpu_torch.solver.fast.
    solve_refined_kernel` with ``fused_init`` (``False``, the JAX default:
    the torch init and K3; ``True``: K1). A shard on a CUDA device launches
    its kernels there or raises; another engine name raises. The shards run
    one after another from the calling thread. Returns ``(result,
    stats)``: the result in input order on the first shard's device, and
    :class:`BatchStats`. ``mesh`` defaults to :func:`make_mesh` over every
    CUDA device.
    """
    if engine not in ENGINES:
        raise ValueError(f"solve_sharded: unknown engine {engine!r}, "
                         f"expected one of {ENGINES}")
    if mesh is None:
        mesh = make_mesh(axis=axis)
    results = [_solve_shard(shard, opt, engine, fused_init)
               for shard in shard_batch(pbs, mesh) if shard.batch]
    dev0 = mesh.devices[0]
    res = GIResult(**{f.name: torch.cat([getattr(r, f.name).to(dev0)
                                         for r in results])
                      for f in dataclasses.fields(GIResult)})
    return res, _stats(res)
