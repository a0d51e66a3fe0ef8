"""The structured fast solver, batched: a blocked factorization of G feeds
the explicit-operator GI engine (BlockGISolver analog).

Counterpart of the fast entry points of :mod:`jrlqp_tpu.structured.solver`
(solver.py:210-515). A cold solve computes H = G^-1 from the block chain,
O(nb s^3) for the factor and O(n^2 s) for the inverse instead of a dense
O(n^3) Cholesky, then runs the XLA engine's loop (``fast_iteration`` until
no lane is RUNNING) and the f64 refinement, whose products with G and the
active normals come from G's blocks and C's rows (:class:`_BlockProducts`):
only the loop's H and N* are read whole. ``backend`` picks how H is
made:

- ``"auto"``: the kernels K5 and K6, or K7 and K8 for an arrow
  (:mod:`jrlqp_tpu_torch.ops.cuda.block_llt`), one launch each for the
  whole batch: a CUDA batch runs the kernels or raises, a CPU batch runs
  their plain versions;
- ``"blocks"``: the composed per-block torch.linalg path of
  :mod:`.blocks` (the JAX package's ``backend="xla"``), only when asked for
  by name.

The GI loop is ``fast._run_loop`` in all three fast entry points: one
launch of the CUDA kernel K11 (``ops/cuda/fast_loop.py``) on a card, a
thread block per lane with H and N* in the lane's device-memory slab (at
IK sizes, n = 387, K1's K = [H | N*^T] does not fit a block's shared
memory), and its plain version on the CPU.

The J/R ``solve_structured`` (solver.py:60-207) runs the dense engine
(:mod:`jrlqp_tpu_torch.solver.dense`) from the blocked factorization, with
block-sparse selection and step hooks when C is a StructuredC.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch

from ..ops.cuda.block_llt import (
    block_arrow_llt,
    block_arrow_solve,
    identity_rhs,
    tri_block_llt,
    tri_block_solve,
)
from ..ops.cuda.struct_refine import struct_gmul, struct_update
from ..ops.linalg import tri_solve_masked
from ..problems import QPProblem
from ..solver import dense
from ..solver.fast import (
    WarmCarry,
    _bmv,
    _f32,
    _init_carry,
    _init_fast_from_ops,
    _refine_batch,
    _run_loop,
    _Slots,
    _validated,
)
from ..solver.state import GIResult, GIState, initial_state
from ..types import (
    LOWER_BOUND,
    NON_POS_HESSIAN,
    RUNNING,
    UPPER,
    UPPER_BOUND,
    SolverOptions,
)
from ..utils import spans
from .containers import GType, StructuredC, StructuredG

__all__ = ["solve_structured", "solve_structured_fast",
           "solve_structured_fast_batch", "solve_structured_fast_carry",
           "structured_qp_problem"]

BACKENDS = ("auto", "blocks")


def structured_qp_problem(
    sg: StructuredG,
    a: torch.Tensor,
    sc: Union[StructuredC, torch.Tensor],
    l: torch.Tensor,
    u: torch.Tensor,
    xl: Optional[torch.Tensor] = None,
    xu: Optional[torch.Tensor] = None,
) -> QPProblem:
    """The dense batched QPProblem of a structured batch (solver.py:40-57);
    ``sc`` is a StructuredC or a dense (B, m, n) C, missing variable
    bounds are -inf / +inf."""
    C = sc.to_dense() if isinstance(sc, StructuredC) else sc
    inf = torch.full_like(a, float("inf"))
    return QPProblem(G=sg.to_dense(), a=a, C=C, l=l, u=u,
                     xl=-inf if xl is None else xl,
                     xu=inf if xu is None else xu,
                     objcst=a.new_zeros((a.shape[0],)))


def structured_hooks(sc: StructuredC):
    """Block-sparse selection and step hooks for the J/R loop
    (solver.py:60-114; ref: BlockGISolver.cpp:117-118, StructuredJ.cpp:
    43-57): the selection computes C x by blocks, and since the selected
    normal is nonzero on one s-wide variable block only, d = J^T n+ reads
    those s rows of J. Returns ``(select_fn, step_fn)`` for
    :func:`jrlqp_tpu_torch.solver.dense.gi_iteration`."""
    nb, mc, s = sc.blocks.shape[1:]

    def select_fn(pb, x, status):
        return dense._select_violated(pb, x, status, cx=sc.transpose_mult(x))

    def step_fn(pb, J, R, q, idx, st):
        n, m = pb.n, pb.m
        dt, dev = J.dtype, J.device
        idx, st = idx.long(), st.long()
        sign = torch.where((st == UPPER) | (st == UPPER_BOUND), -1.0,
                           1.0).to(dt)
        is_bnd = st >= LOWER_BOUND
        # a general constraint: row idx % mc of block idx // mc
        gi = idx.clamp(0, m - 1)
        seg_g = sc.blocks[torch.arange(idx.shape[0], device=dev),
                          gi // mc, gi % mc]                     # (B, s)
        # a bound: one-hot at (idx - m) % s of block (idx - m) // s
        bi = (idx - m).clamp(0, n - 1)
        seg_b = (torch.arange(s, device=dev)[None, :]
                 == (bi % s)[:, None]).to(dt)
        blk = torch.where(is_bnd, bi // s, gi // mc)
        seg = sign[:, None] * torch.where(is_bnd[:, None], seg_b, seg_g)
        rows = blk[:, None] * s + torch.arange(s, device=dev)[None, :]
        Jrows = J.gather(1, rows[:, :, None].expand(-1, -1, n))  # (B, s, n)
        d = torch.einsum("bsn,bs->bn", Jrows, seg)
        nplus = torch.zeros((idx.shape[0], n), dtype=dt,
                            device=dev).scatter(1, rows, seg)
        k = torch.arange(n, device=dev)[None, :]
        z = dense._bmv(J, torch.where(k >= q.long()[:, None], d, 0.0))
        return nplus, d, z, tri_solve_masked(R, d, q)

    return select_fn, step_fn


def init_state_structured(sg: StructuredG, pb: QPProblem,
                          opt: SolverOptions, step_fn=None) -> GIState:
    """Cold J/R init from the blocked factorization (solver.py:117-177;
    ref: BlockGISolver::init_ :62-107): J = L^-T and x = -G^-1 a by block
    solves, posdef from every block's ``cholesky_ex`` ``info``, then the
    equality/fixed replay of the dense engine."""
    B, n = pb.a.shape
    dt, dev = pb.G.dtype, pb.G.device
    fac = sg.llt()
    posdef = fac.posdef
    eye = torch.eye(n, dtype=dt, device=dev)
    J = torch.where(posdef[:, None, None], fac.inverse_transpose(), eye)
    x = torch.where(posdef[:, None], -fac.solve(pb.a), 0.0)
    state = dataclasses.replace(
        initial_state(B, n, pb.m, dt, dev), x=x, f=0.5 * (pb.a * x).sum(1),
        J=J, term=torch.where(posdef, RUNNING, NON_POS_HESSIAN).to(
            torch.int32))
    return dense._replay_equalities(pb, state, opt.with_(validate=False),
                                    step_fn)


def solve_structured(
    sg: StructuredG,
    a: torch.Tensor,
    sc: Union[StructuredC, torch.Tensor],
    l: torch.Tensor,
    u: torch.Tensor,
    xl: Optional[torch.Tensor] = None,
    xu: Optional[torch.Tensor] = None,
    opt: SolverOptions = SolverOptions(),
) -> GIResult:
    """Batched structured J/R solve in the batch's dtype (solver.py:180-207;
    ref: BlockGISolver::solve :17-60): ``sg.diag`` is (B, nb, s, s), ``a``
    (B, n), ``l``/``u`` (B, m), ``sc`` a StructuredC or a dense (B, m, n) C.
    With a StructuredC every iteration uses :func:`structured_hooks`."""
    pb = structured_qp_problem(sg, a, sc, l, u, xl, xu)
    if isinstance(sc, StructuredC):
        select_fn, step_fn = structured_hooks(sc)
    else:
        select_fn = step_fn = None
    state = init_state_structured(sg, pb, opt, step_fn)
    state = dense.run_loop(pb, state, opt, select_fn, step_fn)
    return dense.finalize(pb, state)


def _structured_inverse_kernel_batch(diag, off, gtype):
    """(H = G^-1 (B, n, n), posdef (B,)) of f32 block chains through the
    kernels: the factorization (K5, or K7 for an arrow) and the solve on
    the identity (K6 or K8), one launch each (solver.py:210-248). The
    kernel clamps pivots at 1e-30 instead of making a NaN, so a non-SPD
    lane shows as a collapsed factor: posdef is min(diag L) > 1e-6
    max(diag L) over the whole factor."""
    B, nb, s, _ = diag.shape
    n = nb * s
    eye_b = identity_rhs(B, nb, s, dtype=diag.dtype, device=diag.device)
    if gtype == GType.TRI_BLOCK_DIAGONAL:
        Ld, Lo, Li = tri_block_llt(diag, off)
        H = tri_block_solve(Lo, Li, eye_b)
    else:
        up = gtype == GType.BLOCK_ARROW_UP
        Ld, Lo, Li = block_arrow_llt(diag, off, up=up)
        H = block_arrow_solve(Lo, Li, eye_b, up=up)
    d = torch.diagonal(Ld, dim1=-2, dim2=-1).reshape(B, n)
    posdef = d.amin(dim=1) > 1e-6 * d.amax(dim=1)
    return H.reshape(B, n, n), posdef


def _structured_inverse_blocks(sg32: StructuredG):
    """(H, posdef) through the composed per-block path: H = J0 J0^T with
    J0 = L^-T (solver.py:490-497); a non-SPD lane inverts I."""
    fac = sg32.llt()
    n = sg32.n
    eye = torch.eye(n, dtype=sg32.diag.dtype, device=sg32.diag.device)
    J0 = torch.where(fac.posdef[:, None, None], fac.inverse_transpose(), eye)
    return J0 @ J0.transpose(1, 2), fac.posdef


def _check_backend(backend):
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def _problems(sgs, a, scs, l, u, xl, xu, opt):
    """(pbs, pb32, opt32): the dense batch in its dtype and in f32, and the
    f32 loop's options, its assembly inside the span ``jrlqp.prepare``."""
    return _f32(lambda: structured_qp_problem(sgs, a, scs, l, u, xl, xu),
                opt, a)


def _solve_structured_states(sgs, a, scs, l, u, xl, xu, opt, backend):
    """The cold solve up to the end of the loop (solver.py:457-515):
    (pbs, pb32, opt32, final f32 states)."""
    _check_backend(backend)
    pbs, pb32, opt32 = _problems(sgs, a, scs, l, u, xl, xu, opt)
    n = sgs.n
    f32 = torch.float32
    with spans.span("jrlqp.factor", a):
        if backend == "auto":
            H, posdef = _structured_inverse_kernel_batch(
                sgs.diag.to(f32), sgs.off.to(f32), sgs.gtype)
            eye = torch.eye(n, dtype=f32, device=H.device)
            H = torch.where(posdef[:, None, None], H, eye)
        else:
            H, posdef = _structured_inverse_blocks(dataclasses.replace(
                sgs, diag=sgs.diag.to(f32), off=sgs.off.to(f32)))
    with spans.span("jrlqp.init", a):
        x = torch.where(posdef[:, None], -_bmv(H, pb32.a), 0.0)
        state0 = _init_fast_from_ops(pb32, H, x, posdef, opt32)
    return pbs, pb32, opt32, _run_loop(pb32, state0, opt32)


class _BlockProducts:
    """The refinement's products on the structure (``fast._refine``), for
    the structured entry points: G by its f64 blocks, the active normals by
    the rows of C as the caller passed it (a StructuredC or a dense (B, m,
    n) C), the tracked x, lam, G x, N^T x and N lam advanced by f64
    increments, and no (B, n, n) operand built or read: the correction
    reads only the loop's H and N*. Each step is two launches, K13 and K14
    (:mod:`jrlqp_tpu_torch.ops.cuda.struct_refine`), on a card. Counts
    ``refine.structured`` once per refinement."""

    def __init__(self, sg: StructuredG, sc: Union[StructuredC, torch.Tensor],
                 slots: _Slots):
        spans.count("refine.structured")
        f64 = torch.float64
        self.diag = sg.diag.to(f64).contiguous()
        self.off = sg.off.to(f64).contiguous()
        self.gtype = int(sg.gtype)
        B, n = slots.a64.shape
        if isinstance(sc, StructuredC):
            self.C = sc.blocks.to(f64).reshape(B, sc.m, sc.s).contiguous()
            self.mc = sc.mc
        else:
            self.C, self.mc = sc.to(f64).contiguous(), sc.shape[1]
        self.idx = slots.idxs.to(torch.int32)
        self.sgn, self.b = slots.sgn64.contiguous(), slots.b.contiguous()
        self.a = slots.a64.contiguous()
        self.state = tuple(torch.zeros((B, n), dtype=f64,
                                       device=slots.a64.device)
                           for _ in range(5))
        self.x, self.lam, self.y = self.state[:3]
        self.dy = None

    def start(self, x32, lam32):
        """Track from the loop's x and multipliers: the increments of x and
        lam from zero; the residuals (r1, r2) in f32."""
        _, self.dy = struct_gmul(self.diag, self.off, self.gtype, None,
                                 x32.contiguous(), None)
        return self.advance(x32.contiguous(), lam32)

    def correction(self, nstr2, dx, r1):
        """f32(G N*^T r2) - r1, and G dx in f64 for :meth:`advance`, in one
        pass over G's blocks."""
        t, self.dy = struct_gmul(self.diag, self.off, self.gtype, nstr2, dx,
                                 r1)
        return t

    def advance(self, dx, dlam):
        """The tracked quantities advanced by dx, dlam and G dx; the next
        residuals."""
        return struct_update(self.C, self.mc, self.idx, self.sgn, self.a,
                             self.b, dx, dlam, self.dy, self.state)


def _refine_structured(pbs, sgs, scs, states, ir_steps):
    """``ir_steps`` steps of f64 refinement of the loop's final states on
    the structure (:class:`_BlockProducts`)."""
    return _refine_batch(pbs, states, ir_steps,
                         products=functools.partial(_BlockProducts, sgs, scs))


def solve_structured_fast_batch(
    sgs: StructuredG,
    a: torch.Tensor,
    scs: Union[StructuredC, torch.Tensor],
    l: torch.Tensor,
    u: torch.Tensor,
    xl: Optional[torch.Tensor] = None,
    xu: Optional[torch.Tensor] = None,
    opt: SolverOptions = SolverOptions(),
    ir_steps: int = 3,
    backend: str = "auto",
) -> GIResult:
    """Batched structured solve (solver.py:335-365): ``sgs.diag`` is
    (B, nb, s, s), ``a`` (B, n), ``l``/``u`` (B, m), ``scs`` a StructuredC
    or a dense (B, m, n) C. H = G^-1 by the block kernels (one launch per
    stage for the whole batch), the GI loop in f32, then ``ir_steps`` steps
    of f64 refinement on the blocks of G and the rows of C. Runs on the
    batch's device."""
    with spans.call("solve_structured_fast_batch", a):
        pbs, _, _, states = _solve_structured_states(sgs, a, scs, l, u, xl,
                                                     xu, opt, backend)
        return _refine_structured(pbs, sgs, scs, states, ir_steps)


def solve_structured_fast_carry(
    sgs: StructuredG,
    a: torch.Tensor,
    scs: Union[StructuredC, torch.Tensor],
    l: torch.Tensor,
    u: torch.Tensor,
    carry: Optional[WarmCarry] = None,
    xl: Optional[torch.Tensor] = None,
    xu: Optional[torch.Tensor] = None,
    opt: SolverOptions = SolverOptions(),
    ir_steps: int = 3,
    backend: str = "auto",
) -> tuple[GIResult, WarmCarry]:
    """One step of a structured trajectory (sequential IK,
    solver.py:370-454); returns ``(result, carry)``. ``carry=None`` solves
    cold as :func:`solve_structured_fast_batch`. A carry from the previous
    step, whose G and C must be this step's (only a and the bounds drift),
    starts the loop from its operators: no factorization; on a card one
    launch of K12 for the carry init (``fast._init_carry``, which
    drops every negative multiplier, where the JAX init keeps those in
    [-1e-5, 0)) and one of K11, with no host read. With ``opt.validate`` a
    warm step also ends lanes with inconsistent data INCONSISTENT_INPUT."""
    with spans.call("solve_structured_fast_carry", a):
        if carry is None:
            pbs, _, _, states = _solve_structured_states(
                sgs, a, scs, l, u, xl, xu, opt, backend)
        else:
            _check_backend(backend)
            pbs, pb32, opt32 = _problems(sgs, a, scs, l, u, xl, xu, opt)
            with spans.span("jrlqp.init", a):
                state0 = _validated(pb32, _init_carry(
                    pb32, carry.H, carry.Ns, carry.status, carry.aorder,
                    carry.q), opt)
            states = _run_loop(pb32, state0, opt32)
        res = _refine_structured(pbs, sgs, scs, states, ir_steps)
        return res, WarmCarry(H=states.H, Ns=states.Ns, status=states.status,
                              aorder=states.aorder, q=states.q)


def solve_structured_fast(
    sg: StructuredG,
    a: torch.Tensor,
    sc: Union[StructuredC, torch.Tensor],
    l: torch.Tensor,
    u: torch.Tensor,
    xl: Optional[torch.Tensor] = None,
    xu: Optional[torch.Tensor] = None,
    opt: SolverOptions = SolverOptions(),
    ir_steps: int = 3,
    backend: str = "auto",
) -> GIResult:
    """One structured problem (solver.py:260-330): ``sg.diag`` is
    (nb, s, s), ``a`` (n,), ... The batch of one through
    :func:`solve_structured_fast_batch`; the result has no batch
    dimension."""
    def one(t):
        return None if t is None else t[None]

    sgs = dataclasses.replace(sg, diag=sg.diag[None], off=sg.off[None])
    scs = (StructuredC(blocks=sc.blocks[None]) if isinstance(sc, StructuredC)
           else sc[None])
    res = solve_structured_fast_batch(sgs, a[None], scs, l[None], u[None],
                                      one(xl), one(xu), opt, ir_steps,
                                      backend)
    return GIResult(**{f.name: getattr(res, f.name)[0]
                       for f in dataclasses.fields(GIResult)})
