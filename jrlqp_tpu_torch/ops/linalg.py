"""Masked linear-algebra primitives of the J/R engine, batched.

Counterpart of :mod:`jrlqp_tpu.ops.linalg` with a leading batch dimension
and a per-lane active count ``q`` (and removal position ``l``). R keeps
identity padding on inactive columns, so a full triangular solve of a
head-masked right-hand side is the q-dimensional solve of the reference
(ref: src/GoldfarbIdnaniSolver.cpp:146, :221-256).
"""
from __future__ import annotations

import torch

__all__ = ["tri_solve_masked", "householder_add", "givens_remove",
           "shift_left"]


def _bmv(A, v):
    return torch.einsum("bij,bj->bi", A, v)


def tri_solve_masked(R: torch.Tensor, d: torch.Tensor, q: torch.Tensor
                     ) -> torch.Tensor:
    """r = R[:q, :q]^-1 d[:q] per lane, zero beyond q (linalg.py:35-48)."""
    n = d.shape[1]
    head = torch.arange(n, device=d.device)[None, :] < q.long()[:, None]
    dh = torch.where(head, d, 0.0)
    r = torch.linalg.solve_triangular(R, dh[:, :, None], upper=True)[:, :, 0]
    return torch.where(head, r, 0.0)


def householder_add(J: torch.Tensor, R: torch.Tensor, d: torch.Tensor,
                    q: torch.Tensor):
    """Add a constraint (linalg.py:51-82): one Householder reflector on the
    indices >= q zeroes d[q+1:], J <- J H, and column q of R takes the
    reflected d. Returns (J, R, dependent), ``dependent`` where the tail of
    d is numerically zero. A lane with q = n leaves R as it is, as the JAX
    scatter drops an out-of-range column."""
    n = d.shape[1]
    k = torch.arange(n, device=d.device)[None, :]
    qq = q.long()[:, None]
    v = torch.where(k >= qq, d, 0.0)
    norm = torch.sqrt((v * v).sum(dim=1))
    dq = d.gather(1, qq.clamp(0, n - 1))[:, 0]        # jnp.take(mode="clip")
    alpha = torch.where(dq >= 0, -norm, norm)
    w = v - alpha[:, None] * (k == qq)
    ww = (w * w).sum(dim=1)
    dependent = norm <= 1e-300
    beta = torch.where(ww > 0, 2.0 / torch.where(ww > 0, ww, 1.0), 0.0)
    Jw = _bmv(J, w)
    J_new = J - beta[:, None, None] * (Jw[:, :, None] * w[:, None, :])
    d_new = torch.where(k < qq, d, torch.where(k == qq, alpha[:, None], 0.0))
    R_new = torch.where((k == qq)[:, None, :], d_new[:, :, None], R)
    return J_new, R_new, dependent


def shift_left(vec: torch.Tensor, l: torch.Tensor, q: torch.Tensor
               ) -> torch.Tensor:
    """Delete element l from the first q+1 slots of each lane: out[i] =
    vec[i+1] for l <= i < q, vec[i] elsewhere (linalg.py:85-92)."""
    n = vec.shape[1]
    i = torch.arange(n, device=vec.device)[None, :]
    src = torch.where((i >= l.long()[:, None]) & (i < q.long()[:, None]),
                      i + 1, i)
    return vec.gather(1, src.clamp(0, n - 1))


def givens_remove(J: torch.Tensor, R: torch.Tensor, q_old: torch.Tensor,
                  l: torch.Tensor):
    """Remove the active constraint at position l of each lane
    (linalg.py:95-141): delete column l of R, restore the triangle by the
    sequential sweep of Givens rotations on row pairs (i, i+1) for
    l <= i < q_old - 1, apply each to J's columns, then re-impose zeros
    below the diagonal and identity columns from q_old - 1 on.

    The sweep is one masked rotation per row pair, all lanes at once. It
    runs only over the rows where some lane rotates: every other rotation
    is the identity (c = 1, s = 0) and leaves J and R exactly as they are.
    A lane with l >= q_old - 1 rotates nothing."""
    B, n, _ = R.shape
    dev = R.device
    q_new = q_old.long() - 1
    ll = l.long()
    cols = torch.arange(n, device=dev)[None, :]
    src = torch.where((cols >= ll[:, None]) & (cols < q_new[:, None]),
                      cols + 1, cols).clamp(0, n - 1)
    R = R.gather(2, src[:, None, :].expand(B, n, n))
    J = J.clone()
    rot = ll < q_new
    if bool(rot.any()):
        lo = int(ll[rot].min())
        hi = min(int(q_new[rot].max()), n - 1)
        for i in range(lo, hi):
            active = (i >= ll) & (i < q_new)
            a = R[:, i, i]
            b = R[:, i + 1, i]
            rad = torch.sqrt(a * a + b * b)
            rad_safe = torch.where(rad > 0, rad, 1.0)
            c = torch.where(active & (rad > 0), a / rad_safe, 1.0)[:, None]
            s = torch.where(active & (rad > 0), b / rad_safe, 0.0)[:, None]
            ri, ri1 = R[:, i].clone(), R[:, i + 1].clone()
            R[:, i] = c * ri + s * ri1
            R[:, i + 1] = -s * ri + c * ri1
            ji, ji1 = J[:, :, i].clone(), J[:, :, i + 1].clone()
            J[:, :, i] = c * ji + s * ji1
            J[:, :, i + 1] = -s * ji + c * ji1
    R = torch.triu(R)
    eye = torch.eye(n, dtype=R.dtype, device=dev)
    R = torch.where((cols >= q_new[:, None])[:, None, :], eye, R)
    return J, R
