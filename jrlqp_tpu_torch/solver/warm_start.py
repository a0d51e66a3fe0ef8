"""Warm-start hint processing, batched.

Counterpart of the two helpers of :mod:`jrlqp_tpu.solver.warm_start` that
the explicit-operator warm init uses: ``_process_initial_active_set``
(warm_start.py:45-115) and ``_active_normals_and_bounds`` (:118-144). The
J/R ``solve_warm`` waits for the dense engine.
"""
from __future__ import annotations

import torch

from ..problems import QPProblem
from ..types import (
    EQUALITY,
    FIXED,
    INACTIVE,
    LOWER,
    LOWER_BOUND,
    UPPER,
    UPPER_BOUND,
    SolverOptions,
)
from .fast import _constraint_normal, _selected_bound


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
