"""K10: the J/R engine's GI loop as one CUDA kernel, and its wrapper.

Counterpart of the loop that ``jrlqp_tpu/solver/dense.py:392-410``
(``run_loop``) compiles into one ``lax.while_loop``, with the masked
primitives of ``jrlqp_tpu/ops/linalg.py:95-141`` inside it. The JAX package
has no Pallas kernel here: XLA compiles the loop. The port's kernel,
``jr_loop_kernel`` in ``csrc/jr_kernel.cu``, runs it from a given
``GIState`` with one thread block per lane, each lane's iterations back to
back, in f64 (``jrlqp_jr_loop_f64``) and in f32 (``jrlqp_jr_loop_f32``, the
first stage of ``solve_mixed``). Its plain version is
:func:`jrlqp_tpu_torch.solver.dense.jr_loop_plain`, the masked passes of
:func:`~jrlqp_tpu_torch.solver.dense.gi_iteration` in a host loop;
:func:`jrlqp_tpu_torch.solver.dense.run_loop` chooses between the two by
the state's device.

:func:`jr_loop` launches the kernel on a CUDA state; it raises for another
dtype. The kernel's result is the plain version's lane for lane up to the
order of its sums: the same status, iterations and active set, x within
rounding.
"""
from __future__ import annotations

import torch

from ...problems import QPProblem
from ...solver.state import GIState
from ...types import SolverOptions
from ...utils import spans
from . import _build

__all__ = ["jr_loop", "jr_flops", "jr_bytes"]

_ENTRIES = {torch.float64: "jrlqp_jr_loop_f64",
            torch.float32: "jrlqp_jr_loop_f32"}


def jr_loop(pb: QPProblem, state: GIState, opt: SolverOptions) -> GIState:
    """Run the GI loop from the CUDA state ``state`` until no lane is
    RUNNING: one launch of K10, counted as ``launch.K10``."""
    B, n = state.x.shape
    m = state.status.shape[1] - n
    dt, dev = state.x.dtype, state.x.device
    entry = _ENTRIES.get(dt)
    if entry is None:
        raise TypeError(f"jr_loop: no kernel for {dt}")
    prob = (pb.C, pb.l, pb.u, pb.xl, pb.xu)
    for name, t in zip(("C", "l", "u", "xl", "xu"), prob):
        if t.device != dev or t.dtype != dt or t.shape[0] != B:
            raise ValueError(f"jr_loop: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dt} with batch {B} on {dev}")
    if pb.C.shape[1:] != (m, n):
        raise ValueError(f"jr_loop: C is {tuple(pb.C.shape)}, the state "
                         f"has n={n}, m={m}")
    if B == 0:
        return state
    i32 = torch.int32
    ins = (pb.C.transpose(1, 2).contiguous(), pb.l.contiguous(),
           pb.u.contiguous(), pb.xl.contiguous(), pb.xu.contiguous())
    x, f, J, R, u = (_build.own(t, dt) for t in (state.x, state.f, state.J,
                                                 state.R, state.u))
    status, aorder = (_build.own(state.status, i32),
                      _build.own(state.aorder, i32))
    scal = torch.stack([t.to(i32) for t in (
        state.q, state.it, state.term, state.skip1, state.sc_idx,
        state.sc_status)], dim=1)
    outs = (x, f, J, R, status, aorder, u, scal)
    lib = _build.library()
    # the runtime launches on the current device and sets the kernel's
    # shared-memory limit there: make it the tensors' card
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(
            *[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs],
            B, n, m, int(opt.max_iter), float(opt.big_bnd),
            float(opt.zero_z_threshold), stream)
    _build.check(code, entry)
    spans.count("launch.K10")
    q, it, term, skip1, sc_idx, sc_status = scal.t().contiguous()
    return GIState(x=x, f=f, J=J, R=R, status=status, aorder=aorder, u=u,
                   q=q, it=it, term=term, skip1=skip1.bool(), sc_idx=sc_idx,
                   sc_status=sc_status)


def jr_flops(it, q0, q_end, n: int, m: int) -> float:
    """FLOPs of K10's iterations at (n, m), summed over the lanes; ``it``,
    ``q0`` and ``q_end`` are (B,) tensors of each lane's iterations and its
    active count at the start and at the end. Each iteration is counted as
    an add at the lane's mean active count q = (q0 + q_end) / 2: the
    selection C x (2mn), d = J^T n+ (2n^2), z = J2 d2 (2n(n - q)), the
    triangular solve (q^2) and the Householder update J w and J - beta
    (J w) w^T (4n(n - q))."""
    it, q0, q_end = (v.double() for v in (it, q0, q_end))
    q = ((q0 + q_end) / 2).clamp(0, n)
    per_it = 2 * m * n + 2 * n * n + 6 * n * (n - q) + q * q
    return float((it * per_it).sum())


def jr_bytes(batch: int, n: int, m: int, itemsize: int) -> int:
    """Bytes K10 must move at (n, m): the problem (C, l, u, xl, xu) read
    once, and the state (x, f, J, R, u in the working type; status, aorder
    and six scalars in int32) read once and written once."""
    problem = itemsize * (m * n + 2 * m + 2 * n)
    state = itemsize * (2 * n * n + 2 * n + 2) + 4 * (m + 2 * n + 6)
    return batch * (problem + 2 * state)
