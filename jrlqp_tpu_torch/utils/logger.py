"""Iteration tracing, batched: the port's counterpart of
:mod:`jrlqp_tpu.utils.logger` (the reference's Matlab-emitting Logger,
ref: include/jrl-qp/utils/Logger.h:18-166).

Traces come back as tensors: (B, T, ...) buffers with T = ``opt.max_iter``,
written at row ``it`` of each lane that advances in a pass, with a
(B, T) validity mask. The terminating pass (SUCCESS or INFEASIBLE found)
does not advance ``it`` and is not recorded; ``LogFlags.INIT`` writes row 0
before the loop (the first pass then overwrites it). Unset groups are
``None``. :func:`dump_matlab` renders one lane in the reference Logger's
``name(iter).var = [...]`` format.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from ..ops.cuda.gi_kernel import run_loop_compact
from ..problems import QPProblem
from ..solver import dense, fast
from ..solver.state import GIResult
from ..types import SolverOptions

__all__ = ["LogFlags", "IterationTrace", "solve_traced",
           "solve_fast_traced", "capture_kernel_trajectory", "dump_matlab"]


class LogFlags(enum.IntFlag):
    """(ref: enums.h:40-52; the values of ``jrlqp_tpu.utils.LogFlags``)."""

    NONE = 0
    ITERATION_BASIC_DETAILS = 1 << 0  # x, f, q, selected constraint
    ITERATION_ADVANCE_DETAILS = 1 << 1  # u (condensed multipliers)
    ACTIVE_SET = 1 << 2  # status vector per iteration
    ACTIVE_SET_DETAILS = 1 << 3  # activation order per iteration
    INIT = 1 << 4  # state right after init
    TERMINATION = 1 << 5  # final status (always cheap, kept in result)
    NO_ITER = 1 << 6  # reference's noIterationFlag (global data)
    ALL = (1 << 7) - 1


@dataclasses.dataclass(frozen=True)
class IterationTrace:
    """Per-lane, per-iteration records; rows where ``valid`` is False hold
    zeros."""

    valid: torch.Tensor                # (B, T) bool
    x: Optional[torch.Tensor]          # (B, T, n)
    f: Optional[torch.Tensor]          # (B, T)
    q: Optional[torch.Tensor]          # (B, T) int32
    sc_idx: Optional[torch.Tensor]     # (B, T) int32 selected constraint
    sc_status: Optional[torch.Tensor]  # (B, T) int32
    u: Optional[torch.Tensor]          # (B, T, n+1)
    status: Optional[torch.Tensor]     # (B, T, m+n) int8
    aorder: Optional[torch.Tensor]     # (B, T, n) int32


def _empty_trace(flags: LogFlags, B: int, T: int, n: int, m: int, dtype,
                 device) -> IterationTrace:
    basic = bool(flags & LogFlags.ITERATION_BASIC_DETAILS)
    i32 = torch.int32

    def z(on, *shape, dt=dtype):
        return torch.zeros((B, T, *shape), dtype=dt, device=device) \
            if on else None

    return IterationTrace(
        valid=torch.zeros((B, T), dtype=torch.bool, device=device),
        x=z(basic, n), f=z(basic), q=z(basic, dt=i32),
        sc_idx=z(basic, dt=i32), sc_status=z(basic, dt=i32),
        u=z(bool(flags & LogFlags.ITERATION_ADVANCE_DETAILS), n + 1),
        status=z(bool(flags & LogFlags.ACTIVE_SET), m + n, dt=torch.int8),
        aorder=z(bool(flags & LogFlags.ACTIVE_SET_DETAILS), n, dt=i32))


def _record(tr: IterationTrace, st, lanes, rows) -> None:
    """Write the state of ``lanes`` at ``rows`` of the trace, in place."""
    tr.valid[lanes, rows] = True
    for f in dataclasses.fields(tr):
        buf = getattr(tr, f.name)
        if f.name != "valid" and buf is not None:
            buf[lanes, rows] = getattr(st, f.name)[lanes].to(buf.dtype)


def _traced(state0, run, flags: LogFlags, opt: SolverOptions, n: int,
            m: int):
    """Run ``run(state0, on_pass)`` with a recorder; (final state, trace)."""
    B = state0.x.shape[0]
    T = opt.max_iter
    dev = state0.x.device
    trace = _empty_trace(flags, B, T, n, m, state0.x.dtype, dev)
    if flags & LogFlags.INIT:
        _record(trace, state0, torch.arange(B, device=dev),
                torch.zeros((B,), dtype=torch.long, device=dev))

    def on_pass(before, after):
        lanes = torch.nonzero(after.it != before.it)[:, 0]
        _record(trace, after, lanes,
                before.it[lanes].long().clamp(0, max(T - 1, 0)))

    return run(state0, on_pass), trace


def solve_traced(pbs: QPProblem, opt: SolverOptions = SolverOptions(),
                 flags: LogFlags = LogFlags.ITERATION_BASIC_DETAILS):
    """:func:`jrlqp_tpu_torch.solver.dense.solve_batch` with an
    :class:`IterationTrace` (logger.py:108-142): ``(result, trace)``."""
    state, trace = _traced(
        dense.init_state(pbs, opt),
        lambda s0, cb: dense.run_loop(pbs, s0, opt, on_pass=cb), flags, opt,
        pbs.n, pbs.m)
    return dense.finalize(pbs, state), trace


def solve_fast_traced(pbs: QPProblem, opt: SolverOptions = SolverOptions(),
                      flags: LogFlags = LogFlags.ITERATION_BASIC_DETAILS):
    """:func:`jrlqp_tpu_torch.solver.fast.solve_fast` with an
    :class:`IterationTrace` (logger.py:145-182): the explicit-operator
    engine shares the traced fields with the J/R engine, so the same buffers
    and :func:`dump_matlab` apply."""
    state, trace = _traced(
        fast._init_fast(pbs, opt),
        lambda s0, cb: fast._run_loop(pbs, s0, opt, on_pass=cb), flags, opt,
        pbs.n, pbs.m)
    return dense.finalize(pbs, state), trace


def capture_kernel_trajectory(pbs: QPProblem,
                              opt: SolverOptions = SolverOptions(),
                              n_iters: int = 16) -> dict:
    """Per-iteration states of the compact-slot kernel K9 (counterpart of
    ``capture_pallas_trajectory``, logger.py:185-217, at its default pack 1).
    The kernel runs its loop inside one launch, so intermediate states are
    not observable; this debug helper runs it again with the iteration cap
    set to 1..n_iters from the same f32 cold init and stacks the states
    reached: n_iters launches, O(n_iters^2) iterations, for inspecting one
    problem, not for production. Returns a dict of (n_iters, B, ...)
    tensors: x, u, q, it, term. A CPU batch runs K9's plain version."""
    _, pb32, opt32 = fast._f32(pbs, opt, pbs.G)
    state0 = fast._init_fast(pb32, opt32)
    keys = ("x", "u", "q", "it", "term")
    rows = {k: [] for k in keys}
    for cap in range(1, n_iters + 1):
        out = run_loop_compact(pb32, state0, cap)
        for k in keys:
            rows[k].append(out[k])
    return {k: torch.stack(v) for k, v in rows.items()}


def dump_matlab(name: str, trace: IterationTrace, res: GIResult,
                lane: int = 0) -> str:
    """Render one lane of a trace as a Matlab script, one
    ``name(iter).var = ...`` assignment per record (logger.py:220-245)."""
    out = []
    valid = trace.valid[lane].cpu().numpy()
    T = int(valid.sum())

    def mat(v):
        a = np.atleast_2d(np.asarray(v.cpu().numpy() if torch.is_tensor(v)
                                     else v, dtype=float))
        rows = ";".join(",".join(repr(float(x)) for x in row) for row in a)
        return f"[{rows}]"

    for i in range(T):
        for field in ("x", "f", "q", "sc_idx", "sc_status", "u", "status",
                      "aorder"):
            buf = getattr(trace, field)
            if buf is not None:
                out.append(f"{name}({i + 1}).{field} = {mat(buf[lane, i])};")
    out.append(f"{name}_final.x = {mat(res.x[lane])};")
    out.append(f"{name}_final.status = {int(res.status[lane])};")
    out.append(f"{name}_final.iterations = {int(res.iterations[lane])};")
    return "\n".join(out) + "\n"
