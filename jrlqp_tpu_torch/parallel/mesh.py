"""Device-mesh sharding of QP batches.

Counterpart of :mod:`jrlqp_tpu.parallel.mesh` (mesh.py:30-142). The GI
method needs no communication between problems, so a batch is split along
its leading dimension into contiguous shards, each solved on its own
device by the chosen engine; the only reduction is the convergence
accounting of :class:`BatchStats`, a sum and a max over the shards and, when
``torch.distributed`` is initialized, one ``all_reduce(SUM)`` and one
``all_reduce(MAX)`` across the processes.

As the JAX package's ``shard_map`` program runs every shard at once, the
kernel engine's shards are solved at the same time: one host thread per
card (per shard on a CPU mesh), started for the solve, moves its shard to
its device, waits until every thread has issued its move, and runs the
engine there (a wait, a ctypes launch and most torch ops release the GIL),
on the caller's current stream of each card.
A card that the mesh names several times gets one thread, which solves its
shards one after another. The caller joins every thread, then gathers and
reduces. The engines "f64" and "refined" solve their shards one after
another in the caller's thread (``_THREADED_ENGINES``): threads made them
slower when both were Python loops that waited on the card at every pass.

A :class:`Mesh` is an ordered list of ``torch.device``s and an axis name.
:func:`make_mesh` takes the CUDA devices and raises where there are fewer
than asked; a mesh of CPU devices must be asked for by name
(``make_mesh(devices=[torch.device("cpu")] * 8)``), which is how the tests
run the shard and gather code without a card. A mesh may name one device
several times (four shards on ``cuda:0``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..problems import QPProblem
from ..solver.dense import solve_batch
from ..solver.fast import solve_refined, solve_refined_kernel
from ..solver.state import GIResult
from ..types import SUCCESS, SolverOptions
from ..utils import spans

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


def _split(pbs: QPProblem, size: int) -> list[QPProblem]:
    """The batch split along its leading dimension into ``size`` contiguous
    shards of near-equal size (the first ones one lane larger where it does
    not divide), where it lies."""
    parts = [torch.tensor_split(getattr(pbs, f.name), size)
             for f in dataclasses.fields(QPProblem)]
    return [QPProblem(**{f.name: parts[k][i] for k, f in
                         enumerate(dataclasses.fields(QPProblem))})
            for i in range(size)]


def _to(pb: QPProblem, dev: torch.device) -> QPProblem:
    return QPProblem(**{f.name: getattr(pb, f.name).to(dev)
                        for f in dataclasses.fields(QPProblem)})


def shard_batch(pbs: QPProblem, mesh: Mesh) -> list[QPProblem]:
    """The batch split along its leading dimension into ``mesh.size``
    contiguous shards of near-equal size (the first ones one lane larger
    where it does not divide), each moved to its device."""
    return [_to(part, dev)
            for part, dev in zip(_split(pbs, mesh.size), mesh.devices)]


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


# The engines whose shards run on a thread per card. "refined" and "f64"
# solve their shards one after another in the caller's thread: on four
# H100s a thread per card ran them 6.5x and 5.8x slower than one thread
# when each was a Python loop of masked passes (PERF.md §6); now the torch
# init and one launch of K11 or K10, they stay here until measured on
# threads (ROADMAP P5)
_THREADED_ENGINES = ("pallas",)


def _workers(devices) -> list[list[int]]:
    """The shards each worker solves, in order: one worker per CUDA card (a
    card the mesh names several times runs its shards one after another,
    as the card would queue them anyway), one per shard on the CPU (each
    entry a device of its own, as the JAX package's virtual CPU devices
    are)."""
    groups: dict = {}
    for i, d in enumerate(devices):
        key = (d.type, d.index) if d.type == "cuda" else (d.type, i)
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def _caller_streams(pbs: QPProblem, devices) -> list:
    """The calling thread's current stream of each card that the solve
    touches (the input's and the mesh's). A worker runs on them: its reads
    of the input and the caller's gather of its result are then ordered
    with the caller's work, as they are in the caller's own thread."""
    cards = [d for d in devices if d.type == "cuda"] + [
        getattr(pbs, f.name).device for f in dataclasses.fields(QPProblem)
        if getattr(pbs, f.name).is_cuda]
    streams = {}
    for d in cards:
        s = torch.cuda.current_stream(d)
        streams[s.device_index] = s
    return list(streams.values())


def _in_order(items, streams, ready, opt, engine, fused_init,
              parent=None) -> list:
    """One worker's shards on ``streams``: each moved to its device (in a
    span ``jrlqp.scatter``), then, once every worker has issued its moves
    (``ready``, a barrier of the workers, or None), each solved there, one
    after another, each in a span ``jrlqp.shard``: (result, error) of each.
    The moves come first so that no card's solve is queued ahead of a copy
    to another card on the stream of the card that holds the input. The
    spans are children of ``parent``, the caller's span."""
    moved, out = [], []
    with contextlib.ExitStack() as on:
        for s in streams:
            on.enter_context(torch.cuda.stream(s))
        with spans.span("jrlqp.scatter", items[0][1], parent):
            for part, dev in items:
                try:
                    moved.append((_to(part, dev), None))
                except Exception as e:  # raised in the caller, with others
                    moved.append((None, e))
        if ready is not None:
            ready.wait()
        for (pb, err), (_, dev) in zip(moved, items):
            if err is None:
                try:
                    with (torch.cuda.device(dev) if dev.type == "cuda"
                          else contextlib.nullcontext()), \
                            spans.span("jrlqp.shard", pb.G, parent):
                        out.append((_solve_shard(pb, opt, engine,
                                                 fused_init), None))
                    continue
                except Exception as e:
                    err = e
            out.append((None, err))
    return out


def _solve_shards(parts, devices, streams, opt, engine,
                  fused_init) -> list[GIResult]:
    """Every worker's shards moved, then solved at the same time, on a
    thread each started here and joined (in the caller where there is one
    worker, and for an engine outside _THREADED_ENGINES); once every worker
    has ended,
    the first shard's error (in shard order) is raised, with the others'
    noted on it."""
    workers = (_workers(devices) if engine in _THREADED_ENGINES
               else [list(range(len(parts)))])
    jobs = [[(parts[i], devices[i]) for i in idx] for idx in workers]
    done = [None] * len(jobs)
    ready = threading.Barrier(len(jobs)) if len(jobs) > 1 else None
    parent = spans.current()

    def run(w):
        done[w] = _in_order(jobs[w], streams, ready, opt, engine, fused_init,
                            parent)

    if len(jobs) == 1:
        run(0)
    else:
        threads = [threading.Thread(target=run, args=(w,),
                                    name=f"solve_sharded-{w}")
                   for w in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    outcomes = [None] * len(parts)
    for idx, outs in zip(workers, done):
        for i, out in zip(idx, outs):
            outcomes[i] = out
    errors = [(i, e) for i, (_, e) in enumerate(outcomes) if e is not None]
    if errors:
        first = errors[0][1]
        for i, e in errors[1:]:
            first.add_note(f"solve_sharded: shard {i} on {devices[i]} "
                           f"failed too: {e!r}")
        raise first
    return [r for r, _ in outcomes]


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
    with spans.sync("stats"):
        vals = vals.cpu()
    total, n_ok, max_it = (int(v) for v in vals)
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
    ``"refined"`` the f32 explicit-form loop (K11) with f64 refinement
    (:func:`~jrlqp_tpu_torch.solver.fast.solve_refined`), ``"pallas"``
    the kernel path :func:`~jrlqp_tpu_torch.solver.fast.
    solve_refined_kernel` with ``fused_init`` (``False``, the JAX default:
    the torch init and K3; ``True``: K1). A shard on a CUDA device launches
    its kernels there or raises; another engine name raises. The "pallas"
    engine's shards are solved at the same time, each card's (each CPU
    shard's) on a thread of its own, a card's several shards one after
    another; the "f64" and "refined" engines' shards one after another in
    this thread. Every shard's work is on this thread's current stream of its
    card. An error in any shard is raised here once every shard has
    ended. Each lane is what solving its shard alone gives.
    Returns ``(result, stats)``: the result in input order on the first
    shard's device, and :class:`BatchStats`. ``mesh`` defaults to
    :func:`make_mesh` over every CUDA device.
    """
    if engine not in ENGINES:
        raise ValueError(f"solve_sharded: unknown engine {engine!r}, "
                         f"expected one of {ENGINES}")
    if mesh is None:
        mesh = make_mesh(axis=axis)
    with spans.call("solve_sharded", pbs.G):
        shards = [(part, dev) for part, dev in
                  zip(_split(pbs, mesh.size), mesh.devices) if part.batch]
        devices = [d for _, d in shards]
        results = _solve_shards([p for p, _ in shards], devices,
                                _caller_streams(pbs, devices), opt, engine,
                                fused_init)
        dev0 = mesh.devices[0]
        with spans.span("jrlqp.gather", dev0):
            res = GIResult(**{f.name: torch.cat([getattr(r, f.name).to(dev0)
                                                 for r in results])
                              for f in dataclasses.fields(GIResult)})
            return res, _stats(res)
