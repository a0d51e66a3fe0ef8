"""Warm-started Goldfarb-Idnani solve, batched.

Counterpart of :mod:`jrlqp_tpu.solver.warm_start` (the reference's
experimental warm start, ref: src/experimental/GoldfarbIdnaniSolver.cpp:
66-488): the hint processing ``_process_initial_active_set``
(warm_start.py:45-115) and the hinted set's normals and bounds
``_active_normals_and_bounds`` (:118-144), which the explicit-operator warm
init uses too, and the J/R warm init on the dense engine: (J, R) from one
QR of L^-1 N (:147-169), the closed-form primal/dual point (:172-192), and
the one-at-a-time deactivation of hints with u < 0 (:195-249).

``torch.linalg.qr`` may choose other column signs than ``jnp.linalg.qr``;
x, u and f do not depend on them (a sign flip of a Q column flips the
matching row of R), J and R do.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.linalg import givens_remove, shift_left, tri_solve_masked
from ..problems import QPProblem
from ..types import (
    EQUALITY,
    FIXED,
    INACTIVE,
    LOWER,
    LOWER_BOUND,
    NON_POS_HESSIAN,
    OVERCONSTRAINED_PROBLEM,
    RUNNING,
    UPPER,
    UPPER_BOUND,
    SolverOptions,
)
from ..utils import spans
from .dense import (
    _bmtv,
    _bmv,
    _constraint_normal,
    _safe_cholesky,
    _selected_bound,
    _where_state,
    finalize,
    run_loop,
)
from .state import GIResult, GIState, initial_state

__all__ = ["solve_warm", "warm_init_state"]


def _process_initial_active_set(pb: QPProblem, as_hint: torch.Tensor,
                                opt: SolverOptions):
    """Decide each lane's initial active set (ref :306-390).

    ``as_hint`` is (B, m+n) ActivationStatus. Problem equalities (l == u,
    xl == xu) always activate; hints count only with ``opt.warm_start``
    and are dropped at infinite bounds. Bounds activate before general
    constraints; past n actives, inequalities are deactivated from the
    last activated back. Returns (status (B, m+n) int32, aorder (B, n)
    int32, q (B,) int32, overconstrained (B,) bool). The sorts are stable,
    as ``jnp.argsort`` is: the drop order and the activation order depend
    on it.
    """
    B, n = pb.a.shape
    m = pb.m
    mt = m + n
    big = opt.big_bnd
    dev = pb.G.device
    use_hint = bool(opt.warm_start)
    hint = as_hint.long()

    hb = hint[:, m:]
    hb_valid = use_hint & (((hb == LOWER_BOUND) & (pb.xl >= -big))
                           | ((hb == UPPER_BOUND) & (pb.xu <= big)))
    st_b = torch.where(pb.xl == pb.xu, FIXED,
                       torch.where(hb_valid, hb, INACTIVE))
    hc = hint[:, :m]
    hc_valid = use_hint & (((hc == LOWER) & (pb.l >= -big))
                           | ((hc == UPPER) & (pb.u <= big)))
    st_c = torch.where(pb.l == pb.u, EQUALITY,
                       torch.where(hc_valid, hc, INACTIVE))
    status = torch.cat([st_c, st_b], dim=1)

    # activation priority: bounds (0..n-1), then constraints (n..n+m-1)
    prio = torch.cat([n + torch.arange(m, device=dev),
                      torch.arange(n, device=dev)])[None, :]
    act = status != INACTIVE
    hard = act & ((status == EQUALITY) | (status == FIXED))
    over = hard.sum(dim=1) > n
    # overflow: drop removable actives, the last activated first
    excess = torch.clamp_min(act.sum(dim=1, keepdim=True) - n, 0)
    key = torch.where(act & ~hard, -prio, torch.iinfo(torch.int32).max)
    drop_order = torch.argsort(key, dim=1, stable=True)
    dropped = torch.arange(mt, device=dev)[None, :] < excess
    status = status.scatter(
        1, drop_order,
        torch.where(dropped, INACTIVE, status.gather(1, drop_order)))
    act = status != INACTIVE
    q = act.sum(dim=1)
    order = torch.argsort(torch.where(act, prio, mt + n + 1), dim=1,
                          stable=True)
    k = torch.arange(n, device=dev)[None, :]
    aorder = torch.where(k < q[:, None], order[:, :n], -1)
    return (status.to(torch.int32), aorder.to(torch.int32),
            q.to(torch.int32), over)


def _active_normals_and_bounds(pb: QPProblem, status, aorder, q):
    """N (B, n, n) with column k the signed normal of the k-th active
    constraint (zero beyond q) and b_act (B, n) the signed bounds:
    LOWER / EQUALITY -> l, UPPER -> -u, LOWER_BOUND / FIXED -> xl,
    UPPER_BOUND -> -xu (ref :392-427). A slot beyond q is 0 through a
    select, so an infinite bound of the row it points at cannot leak in."""
    m, n = pb.m, pb.n
    k = torch.arange(n, device=pb.G.device)[None, :]
    valid = k < q.long()[:, None]
    idxs = torch.where(valid, aorder.long(), 0)
    sts = status.long().gather(1, idxs.clamp(0, m + n - 1))
    N = torch.where(valid[:, :, None], _constraint_normal(pb, idxs, sts), 0.0)
    sign = torch.where((sts == UPPER) | (sts == UPPER_BOUND), -1.0, 1.0)
    b_act = torch.where(valid, sign * _selected_bound(pb, idxs, sts), 0.0)
    return N.transpose(1, 2), b_act


def _initialize_computation_data(pb: QPProblem, status, aorder, q):
    """J = L^-T Q and R from the QR of B = L^-1 N (warm_start.py:147-169),
    R identity beyond q; (J, R, b_act, posdef) with posdef from
    ``cholesky_ex``'s ``info``."""
    n = pb.n
    L, posdef = _safe_cholesky(pb.G)
    N, b_act = _active_normals_and_bounds(pb, status, aorder, q)
    Bm = torch.linalg.solve_triangular(L, N, upper=False)
    Q, R = torch.linalg.qr(Bm, mode="complete")
    k = torch.arange(n, device=pb.G.device)
    eye = torch.eye(n, dtype=pb.G.dtype, device=pb.G.device)
    R = torch.where((k[None, :] >= q.long()[:, None])[:, None, :], eye,
                    torch.triu(R))
    J0 = torch.linalg.solve_triangular(L.transpose(1, 2), eye.expand_as(L),
                                       upper=True)
    return J0 @ Q, R, b_act, posdef


def _initialize_primal_dual(pb: QPProblem, J, R, b_act, q):
    """The alpha/beta closed form (warm_start.py:172-192): alpha = J^T a,
    beta = R1^-T b_act, x = J1 beta - J2 alpha2, u = R1^-1 (alpha1 + beta),
    f = beta.(0.5 beta + alpha1) - 0.5 |alpha2|^2."""
    n = pb.n
    head = torch.arange(n, device=J.device)[None, :] < q.long()[:, None]
    alpha = _bmtv(J, pb.a)
    bh = torch.where(head, b_act, 0.0)
    beta = torch.linalg.solve_triangular(R.transpose(1, 2), bh[:, :, None],
                                         upper=False)[:, :, 0]
    beta = torch.where(head, beta, 0.0)
    alpha1 = torch.where(head, alpha, 0.0)
    alpha2 = torch.where(head, 0.0, alpha)
    x = _bmv(J, torch.where(head, beta, -alpha2))
    u_head = tri_solve_masked(R, alpha1 + beta, q)
    f = (beta * (0.5 * beta + alpha1)).sum(dim=1) \
        - 0.5 * (alpha2 * alpha2).sum(dim=1)
    return x, torch.cat([u_head, torch.zeros_like(u_head[:, :1])], dim=1), f


def warm_init_state(pb: QPProblem, as_hint, opt: SolverOptions) -> GIState:
    """Warm init of the J/R engine from (B, m+n) hints (warm_start.py:
    195-249): the hinted set, (J, R), the closed form, then while a lane is
    RUNNING the removal of its most negative hinted multiplier (u < -1e-14,
    lowest slot on ties), each followed by a new closed form and counted as
    an iteration."""
    B, n = pb.a.shape
    m = pb.m
    dev = pb.G.device
    status, aorder, q, over = _process_initial_active_set(pb, as_hint, opt)
    J, R, b_act, posdef = _initialize_computation_data(pb, status, aorder, q)
    x, u, f = _initialize_primal_dual(pb, J, R, b_act, q)
    term = torch.where(over, OVERCONSTRAINED_PROBLEM,
                       torch.where(posdef, RUNNING, NON_POS_HESSIAN))
    state = dataclasses.replace(
        initial_state(B, n, m, pb.G.dtype, dev), x=x, f=f, J=J, R=R,
        status=status, aorder=aorder, u=u, q=q, term=term.to(torch.int32))
    k = torch.arange(n, device=dev)[None, :]
    while True:
        valid = k < state.q.long()[:, None]
        idxs = torch.where(valid, state.aorder.long(), 0)
        sts = state.status.long().gather(1, idxs.clamp(0, m + n - 1))
        elig = valid & (sts != EQUALITY) & (sts != FIXED)
        vals = torch.where(elig, state.u[:, :n], 0.0)
        lmin = vals.argmin(dim=1)
        umin = vals.gather(1, lmin[:, None])[:, 0]
        active = (state.term == RUNNING) & (umin < -1e-14)
        with spans.sync("deactivate"):
            go = bool(active.any())
        if not go:
            return state
        q_old = state.q.long()
        J2, R2 = givens_remove(state.J, state.R, q_old,
                               torch.where(active, lmin, n))
        rem_idx = state.aorder.long().gather(1, lmin[:, None])
        status2 = state.status.scatter(1, rem_idx.clamp(0, m + n - 1),
                                       INACTIVE)
        last = k == (q_old - 1).clamp(0, n - 1)[:, None]
        aorder2 = torch.where(last, -1, shift_left(state.aorder, lmin,
                                                   q_old - 1))
        b_act2 = torch.where(last, 0.0, shift_left(b_act, lmin, q_old - 1))
        q2 = (q_old - 1).to(torch.int32)
        x2, u2, f2 = _initialize_primal_dual(pb, J2, R2, b_act2, q2)
        st2 = dataclasses.replace(
            state, x=x2, f=f2, J=J2, R=R2, status=status2,
            aorder=aorder2.to(torch.int32), u=u2, q=q2, it=state.it + 1)
        state = _where_state(active, st2, state)
        b_act = torch.where(active[:, None], b_act2, b_act)


def solve_warm(pbs: QPProblem, as_hints, opt: SolverOptions = SolverOptions()
               ) -> GIResult:
    """Warm-started J/R solve of a batch from (B, m+n) ActivationStatus
    hints, e.g. a previous result's ``active_set`` (counterpart of
    ``vmap(solve_warm)``, warm_start.py:252-266). Hints count only with
    ``opt.warm_start``."""
    return finalize(pbs, run_loop(pbs, warm_init_state(pbs, as_hints, opt),
                                  opt))
