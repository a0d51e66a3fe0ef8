"""Batched KKT optimality checkers -- the port's acceptance oracle.

Counterpart of :mod:`jrlqp_tpu.testing.kkt`, written for a leading batch
dimension: ``x`` is (B, n), ``u`` is (B, m+n) in the external multiplier
convention (negative at active lower bounds, positive at active upper
bounds), and every function returns one value per lane.
"""
from __future__ import annotations

import torch

from ..problems import QPProblem

__all__ = [
    "check_kkt",
    "check_kkt_stationarity",
    "check_kkt_feasibility",
    "kkt_residual",
]

DEFAULT_TAU = 1e-6


def _bmv(A, v):
    return torch.einsum("bij,bj->bi", A, v)


def _lagrangian_grad(x, u, pb: QPProblem):
    m = pb.m
    return (_bmv(pb.G, x) + pb.a + torch.einsum("bji,bj->bi", pb.C, u[:, :m])
            + u[:, m:])


def _amax(t):
    return t.abs().amax(dim=1)


def _check_constraint(cx, bl, bu, u, tau_x, tau_u):
    li = cx - bl
    ui = cx - bu
    b1 = (li.abs() <= tau_x) & (u <= -tau_u)
    b2 = (li >= -tau_x) & (ui <= tau_x) & (u.abs() <= tau_u)
    b3 = (ui.abs() <= tau_x) & (u >= tau_u)
    return b1 | b2 | b3


def check_kkt_stationarity(x, u, pb: QPProblem, tau_d: float = DEFAULT_TAU):
    """|G x + a + C^T u_c + u_b|_inf <= tau_d (1 + |u|_inf), per lane."""
    tau_u = tau_d * (1 + _amax(u))
    return _amax(_lagrangian_grad(x, u, pb)) <= tau_u


def check_kkt_feasibility(x, u, pb: QPProblem, tau_p: float = DEFAULT_TAU,
                          tau_d: float = DEFAULT_TAU):
    """Per-constraint trichotomy with scaled tolerances, per lane."""
    m = pb.m
    tau_x = (tau_p * (1 + _amax(x)))[:, None]
    tau_u = (tau_d * (1 + _amax(u)))[:, None]
    cx = _bmv(pb.C, x)
    ok_c = _check_constraint(cx, pb.l, pb.u, u[:, :m], tau_x, tau_u)
    ok_b = _check_constraint(x, pb.xl, pb.xu, u[:, m:], tau_x, tau_u)
    return ok_c.all(dim=1) & ok_b.all(dim=1)


def check_kkt(x, u, pb: QPProblem, tau_p: float = DEFAULT_TAU,
              tau_d: float = DEFAULT_TAU):
    """Stationarity and feasibility, per lane."""
    return (check_kkt_stationarity(x, u, pb, tau_d)
            & check_kkt_feasibility(x, u, pb, tau_p, tau_d))


def kkt_residual(x, u, pb: QPProblem):
    """(B,) continuous scaled KKT residual: the max of the stationarity
    residual, the primal infeasibility and the complementarity gap (see
    ``jrlqp_tpu.testing.kkt.kkt_residual``)."""
    m = pb.m
    xs = 1 + _amax(x)
    us = 1 + _amax(u)
    r_stat = _amax(_lagrangian_grad(x, u, pb)) / us

    cx = _bmv(pb.C, x)
    viol_c = torch.maximum(pb.l - cx, cx - pb.u)
    viol_b = torch.maximum(pb.xl - x, x - pb.xu)
    r_feas = torch.maximum(viol_c.amax(dim=1), viol_b.amax(dim=1))
    r_feas = torch.clamp_min(r_feas, 0.0) / xs

    def comp(cv, bl, bu, ui):
        d = torch.where(ui < 0, (cv - bl).abs(), (cv - bu).abs())
        d = torch.where(torch.isfinite(d), d, torch.full_like(d, torch.inf))
        return ui.abs() * torch.clamp_max(d, 1.0)

    r_comp = torch.maximum(
        comp(cx, pb.l, pb.u, u[:, :m]).amax(dim=1),
        comp(x, pb.xl, pb.xu, u[:, m:]).amax(dim=1),
    ) / (us * xs)
    return torch.maximum(torch.maximum(r_stat, r_feas), r_comp)
