"""Specialized solver: min 0.5 |x - x0|^2  s.t.  c^T x >= bl, xl <= x <= xu,
batched over a leading dimension (``x0, c, xl, xu`` are (B, n), ``bl`` is
(B,) or a scalar).

Counterpart of :mod:`jrlqp_tpu.solver.box_single` (box_single.py:45-212).
:func:`solve_box` solves the QP exactly in closed form: with multiplier
lam >= 0 on c'x >= bl, stationarity pins x(lam) = clip(x0 + lam c, xl,
xu), and g(lam) = c'x(lam) is nondecreasing and piecewise linear with the
2n clamp entry and exit times as breakpoints. Each lane sorts its 2n+2
breakpoints, evaluates g at each and interpolates where g crosses bl: no
iteration and no factorization. :func:`solve_box_gi` is the literal
reference path, the closed-form clamp init followed by the J/R engine's
loop (:mod:`.dense`), kept as the differential oracle.

As in the JAX package (and the reference), the reported objective is
f = 0.5 |x - x0|^2, which differs from the canonical 0.5 x'Gx + a'x by
the constant 0.5 |x0|^2. The JAX package has no Pallas kernel here, so
this module is tensor code on the inputs' device.
"""
from __future__ import annotations

import dataclasses

import torch

from ..problems import QPProblem
from ..types import (
    INFEASIBLE,
    LOWER,
    LOWER_BOUND,
    SUCCESS,
    UPPER_BOUND,
    SolverOptions,
)
from .dense import finalize, run_loop
from .state import GIResult, GIState, initial_state

__all__ = ["solve_box", "solve_box_gi", "box_qp_problem", "box_init_state"]


def _lanes(bl, x0) -> torch.Tensor:
    """``bl`` as a (B,) tensor of x0's dtype and device."""
    return torch.as_tensor(bl, dtype=x0.dtype, device=x0.device).expand(
        x0.shape[0])


def box_qp_problem(x0, c, bl, xl, xu) -> QPProblem:
    """The equivalent batch of dense QPs (G = I, a = -x0, one row c) for
    oracle checks (box_single.py:45-58)."""
    B, n = x0.shape
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    return QPProblem(G=eye.expand(B, n, n).clone(), a=-x0, C=c[:, None, :],
                     l=_lanes(bl, x0)[:, None].clone(),
                     u=torch.full((B, 1), torch.inf, dtype=x0.dtype,
                                  device=x0.device),
                     xl=xl, xu=xu, objcst=0.5 * (x0 * x0).sum(dim=1))


def box_init_state(x0, c, bl, xl, xu) -> GIState:
    """Closed-form init (box_single.py:61-127): clamp x0 into [xl, xu];
    each clamped coordinate becomes an active bound with multiplier
    |x0_i - x_i|; J is a permutation (clamped coordinates in index order
    first, free coordinates in reverse order last), R a +/-1 diagonal."""
    B, n = x0.shape
    dt, dev = x0.dtype, x0.device
    i32 = torch.int32
    m = 1
    low = x0 < xl
    high = x0 > xu
    clamped = low | high
    x = torch.clamp(x0, xl, xu)

    csum = torch.cumsum(clamped.to(i32), dim=1)
    q = csum[:, -1]
    rank = csum - 1
    i_idx = torch.arange(n, device=dev).expand(B, n)
    q_before = csum - clamped.to(i32)
    # J columns: clamped i -> its rank; free i -> n - i + q_before_i - 1
    col = torch.where(clamped, rank, n - i_idx + q_before - 1).long()
    J = torch.zeros((B, n, n), dtype=dt, device=dev).scatter(
        2, col[:, :, None], 1.0)

    # the clamped coordinates' slots; every free one points at slot n - 1,
    # which only a free coordinate's neutral value reaches unless all n
    # are clamped
    slot = torch.where(clamped, rank, n - 1).long()
    k = torch.arange(n, device=dev)[None, :]
    on = k < q[:, None]
    sign = torch.where(clamped, torch.where(low, 1.0, -1.0), 1.0).to(dt)
    rdiag = torch.ones((B, n), dtype=dt, device=dev).scatter(1, slot, sign)
    R = torch.diag_embed(torch.where(on, rdiag, 1.0))

    dist = (x - x0).abs()
    u_head = torch.zeros((B, n), dtype=dt, device=dev).scatter_add(
        1, slot, torch.where(clamped, dist, 0.0))
    u = torch.cat([u_head, torch.zeros((B, 1), dtype=dt, device=dev)], dim=1)

    st_b = torch.where(low, LOWER_BOUND,
                       torch.where(high, UPPER_BOUND, 0)).to(i32)
    status = torch.cat([torch.zeros((B, m), dtype=i32, device=dev), st_b],
                       dim=1)
    ao = torch.zeros((B, n), dtype=i32, device=dev).scatter(
        1, slot, torch.where(clamped, m + i_idx, 0).to(i32))
    aorder = torch.where(on, ao, -1).to(i32)

    base = initial_state(B, n, m, dt, dev)
    return dataclasses.replace(
        base, x=x, f=0.5 * ((x - x0) ** 2).sum(dim=1), J=J, R=R,
        status=status, aorder=aorder, u=u, q=q.to(i32))


def solve_box_gi(x0, c, bl, xl, xu,
                 opt: SolverOptions = SolverOptions()) -> GIResult:
    """The GI-machinery variant (box_single.py:130-142): the closed-form
    clamp init, then the J/R engine's loop. The differential oracle of
    :func:`solve_box`."""
    pb = box_qp_problem(x0, c, bl, xl, xu)
    state = box_init_state(x0, c, _lanes(bl, x0), xl, xu)
    return finalize(pb, run_loop(pb, state, opt))


def solve_box(x0, c, bl, xl, xu,
              opt: SolverOptions = SolverOptions()) -> GIResult:
    """Exact closed-form solve of min 0.5|x-x0|^2 s.t. c'x >= bl,
    xl <= x <= xu on every lane (box_single.py:145-212). ``opt`` is
    accepted for symmetry and unused: the solve does not iterate.

    Returns the standard :class:`GIResult`; ``iterations`` is 1 where the
    general constraint is active, else 0.
    """
    dt = x0.dtype
    B, n = x0.shape
    bl = _lanes(bl, x0)
    fi = torch.finfo(dt)
    big = float(torch.sqrt(torch.tensor(fi.max, dtype=dt)) * 1e-3)

    # clamp entry/exit times of each coordinate along x(lam)
    nz = c != 0
    safe_c = torch.where(nz, c, 1.0)
    r_l = (xl - x0) / safe_c
    r_u = (xu - x0) / safe_c
    tin = torch.where(nz, torch.clamp(torch.minimum(r_l, r_u), 0.0, big), 0.0)
    tout = torch.where(nz, torch.clamp(torch.maximum(r_l, r_u), 0.0, big),
                       0.0)
    w2 = c * c

    # g(lam) at every breakpoint; sentinels at 0 and `big` bracket it
    ts = torch.sort(torch.cat([torch.zeros((B, 1), dtype=dt, device=x0.device),
                               tin, tout,
                               torch.full((B, 1), big, dtype=dt,
                                          device=x0.device)], dim=1),
                    dim=1, stable=True).values
    g0 = (c * torch.clamp(x0, xl, xu)).sum(dim=1)
    contrib = w2[:, None, :] * (torch.clamp(ts[:, :, None], tin[:, None, :],
                                            tout[:, None, :]) - tin[:, None, :])
    gs = g0[:, None] + contrib.sum(dim=2)                    # (B, 2n+2)

    # scaled feasibility tolerance: a bl exactly at the box's best corner
    # must not round to INFEASIBLE
    gscale = (1.0 + g0.abs() + bl.abs()
              + (w2 * torch.where(tout < big, tout - tin, 0.0)).sum(dim=1))
    tol = 1e3 * fi.eps * gscale
    feasible0 = g0 >= bl
    reachable = gs[:, -1] >= bl - tol
    bl_eff = torch.where(reachable, torch.minimum(bl, gs[:, -1]), bl)
    # the first breakpoint with g >= bl; interpolate the segment before it
    j = torch.clamp((gs >= bl_eff[:, None]).to(torch.int32).argmax(dim=1),
                    1, 2 * n + 1)[:, None]
    t_lo, t_hi = ts.gather(1, j - 1)[:, 0], ts.gather(1, j)[:, 0]
    g_lo, g_hi = gs.gather(1, j - 1)[:, 0], gs.gather(1, j)[:, 0]
    slope = (g_hi - g_lo) / torch.clamp_min(t_hi - t_lo, fi.tiny)
    lam = t_lo + (bl_eff - g_lo) / torch.clamp_min(slope, fi.tiny)
    lam = torch.where(feasible0 | ~reachable, 0.0, lam)

    y = x0 + lam[:, None] * c
    x = torch.clamp(y, xl, xu)
    # external multipliers: G x + a + C^T u_c + u_b = 0 with G = I,
    # a = -x0: u_c = -lam (active lower side), u_b = y - x
    i32 = torch.int32
    active = torch.cat([
        torch.where(lam > 0, LOWER, 0)[:, None],
        torch.where(y < xl, LOWER_BOUND, torch.where(y > xu, UPPER_BOUND, 0)),
    ], dim=1).to(i32)
    return GIResult(
        x=x,
        multipliers=torch.cat([-lam[:, None], y - x], dim=1),
        f=0.5 * ((x - x0) ** 2).sum(dim=1),
        iterations=(lam > 0).to(i32),
        status=torch.where(feasible0 | reachable, SUCCESS,
                           INFEASIBLE).to(i32),
        active_set=active,
    )
