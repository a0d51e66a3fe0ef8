"""The benchmark's own KKT arithmetic: a copy of
``jrlqp_tpu_torch.testing.kkt.kkt_residual`` on plain tensors.

``x`` is (B, n), ``u`` (B, m+n) in the external multiplier convention
(negative at active lower bounds, positive at active upper bounds); the
residual is one value per lane: the max of the stationarity residual, the
primal infeasibility and the complementarity gap, each scaled.
"""
from __future__ import annotations

import torch


def _bmv(A, v):
    return torch.einsum("bij,bj->bi", A, v)


def _amax(t):
    return t.abs().amax(dim=1)


def kkt_residual(x, u, G, a, C, l, up, xl, xu):
    """(B,) continuous scaled KKT residual of min 0.5 x'Gx + a'x s.t.
    l <= Cx <= up, xl <= x <= xu."""
    m = C.shape[1]
    xs = 1 + _amax(x)
    us = 1 + _amax(u)
    grad = _bmv(G, x) + a + torch.einsum("bji,bj->bi", C, u[:, :m]) + u[:, m:]
    r_stat = _amax(grad) / us

    cx = _bmv(C, x)
    viol_c = torch.maximum(l - cx, cx - up)
    viol_b = torch.maximum(xl - x, x - xu)
    r_feas = torch.maximum(viol_c.amax(dim=1), viol_b.amax(dim=1))
    r_feas = torch.clamp_min(r_feas, 0.0) / xs

    def comp(cv, bl, bu, ui):
        d = torch.where(ui < 0, (cv - bl).abs(), (cv - bu).abs())
        d = torch.where(torch.isfinite(d), d, torch.full_like(d, torch.inf))
        return ui.abs() * torch.clamp_max(d, 1.0)

    r_comp = torch.maximum(
        comp(cx, l, up, u[:, :m]).amax(dim=1),
        comp(x, xl, xu, u[:, m:]).amax(dim=1),
    ) / (us * xs)
    return torch.maximum(torch.maximum(r_stat, r_feas), r_comp)
