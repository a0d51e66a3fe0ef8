"""Structured SPD factorizations, batched: block-tridiagonal and block-arrow
LLT composed from per-block torch.linalg operations.

Counterpart of :mod:`jrlqp_tpu.structured.blocks` (the composed per-block
path behind ``backend="xla"``), with a leading batch dimension on every
argument. It runs in any dtype and is the f64 oracle of the kernels K5-K8
(:mod:`jrlqp_tpu_torch.ops.cuda.block_llt`).

Shapes (B = batch, nb = number of blocks, s = block size):
- tri-block-diagonal: diag (B, nb, s, s); sub (B, nb-1, s, s) with sub[:, i]
  the block at row i+1, column i;
- block-arrow (down): diag (B, nb, s, s); side (B, nb-1, s, s) with
  side[:, i] the block at the last block row, column i. An up arrow
  (coupling in the first block row) is reduced to a down one by rolling
  block 0 to the end; the solves roll the rhs the same way.

``jnp.linalg.cholesky`` returns NaN on a non-SPD block, while
``torch.linalg.cholesky_ex`` leaves a finite partial factor. So each
factorization also returns ``ok`` (B,): True where every block's
``info == 0``.
"""
from __future__ import annotations

import torch

__all__ = [
    "tri_block_diag_llt",
    "tri_block_l_solve",
    "tri_block_lt_solve",
    "block_arrow_llt",
    "block_arrow_l_solve",
    "block_arrow_lt_solve",
    "tri_block_to_dense",
    "block_arrow_to_dense",
    "tri_block_matvec",
    "block_arrow_matvec",
]


def _chol(D):
    """(L, ok) of a batch of blocks (..., s, s); ok is info == 0."""
    L, info = torch.linalg.cholesky_ex(D)
    return L, info == 0


def _solve_lower(L, X, transpose=False):
    """L^-1 X (or L^-T X) for lower-triangular L, batched."""
    if transpose:
        return torch.linalg.solve_triangular(L.mT, X, upper=True)
    return torch.linalg.solve_triangular(L, X, upper=False)


def _with_cols(r):
    """(r with a trailing column axis, whether one was added)."""
    return (r[..., None], True) if r.dim() == 3 else (r, False)


def tri_block_diag_llt(diag: torch.Tensor, sub: torch.Tensor):
    """LLT of block-tridiagonal SPD matrices (blocks.py:59-83):
    L_i = chol(D_i - S'_{i-1} S'_{i-1}^T), S'_i = S_i L_i^-T. Returns
    (L_diag (B, nb, s, s), L_sub (B, nb-1, s, s), ok (B,))."""
    B, nb, s, _ = diag.shape
    M = torch.zeros_like(diag[:, 0])
    ok = torch.ones((B,), dtype=torch.bool, device=diag.device)
    Ls, Sps = [], []
    for i in range(nb):
        L, oki = _chol(diag[:, i] - M)
        ok = ok & oki
        Ls.append(L)
        if i < nb - 1:
            Sp = _solve_lower(L, sub[:, i].mT).mT
            Sps.append(Sp)
            M = Sp @ Sp.mT
    L_sub = torch.stack(Sps, 1) if Sps else diag.new_zeros((B, 0, s, s))
    return torch.stack(Ls, 1), L_sub, ok


def tri_block_l_solve(L_diag, L_sub, r):
    """y = L^-1 r by blockwise forward substitution (blocks.py:86-98);
    r is (B, nb, s) or (B, nb, s, k)."""
    r, vec = _with_cols(r)
    ys = []
    for i in range(L_diag.shape[1]):
        rhs = r[:, i] if i == 0 else r[:, i] - L_sub[:, i - 1] @ ys[-1]
        ys.append(_solve_lower(L_diag[:, i], rhs))
    y = torch.stack(ys, 1)
    return y[..., 0] if vec else y


def tri_block_lt_solve(L_diag, L_sub, r):
    """y = L^-T r by blockwise backward substitution (blocks.py:101-113)."""
    r, vec = _with_cols(r)
    nb = L_diag.shape[1]
    ys = [None] * nb
    for i in range(nb - 1, -1, -1):
        rhs = r[:, i] if i == nb - 1 else r[:, i] - L_sub[:, i].mT @ ys[i + 1]
        ys[i] = _solve_lower(L_diag[:, i], rhs, transpose=True)
    y = torch.stack(ys, 1)
    return y[..., 0] if vec else y


def block_arrow_llt(diag: torch.Tensor, side: torch.Tensor, up: bool = False):
    """LLT of block-arrow SPD matrices (blocks.py:116-144): the head blocks
    factor independently, B_i = S_i L_i^-T, and the Schur complement
    D_last - sum B_i B_i^T factors last. ``up`` rolls block 0 to the end
    first. Returns (L_diag, L_side, ok (B,))."""
    if up:
        diag = torch.roll(diag, -1, dims=1)
    Ls, ok_h = _chol(diag[:, :-1])
    Bs = _solve_lower(Ls, side.mT).mT
    L_last, ok_l = _chol(diag[:, -1] - (Bs @ Bs.mT).sum(1))
    return (torch.cat([Ls, L_last[:, None]], 1), Bs,
            ok_h.all(dim=1) & ok_l)


def block_arrow_l_solve(L_diag, L_side, r, up: bool = False):
    """y = L^-1 P r for the (rolled) arrow factor (blocks.py:147-160)."""
    r, vec = _with_cols(r)
    if up:
        r = torch.roll(r, -1, dims=1)
    y_head = _solve_lower(L_diag[:, :-1], r[:, :-1])
    acc = (L_side @ y_head).sum(1)
    y_last = _solve_lower(L_diag[:, -1], r[:, -1] - acc)
    y = torch.cat([y_head, y_last[:, None]], 1)
    return y[..., 0] if vec else y


def block_arrow_lt_solve(L_diag, L_side, r, up: bool = False):
    """y = P^T L^-T r (blocks.py:163-176)."""
    r, vec = _with_cols(r)
    y_last = _solve_lower(L_diag[:, -1], r[:, -1], transpose=True)
    y_head = _solve_lower(L_diag[:, :-1],
                          r[:, :-1] - L_side.mT @ y_last[:, None],
                          transpose=True)
    y = torch.cat([y_head, y_last[:, None]], 1)
    if up:
        y = torch.roll(y, 1, dims=1)
    return y[..., 0] if vec else y


def tri_block_matvec(diag, sub, x):
    """G x of a block-tridiagonal batch by its blocks, in their dtype; x is
    (B, nb, s) or (B, nb, s, k)."""
    x, vec = _with_cols(x)
    y = diag @ x
    y[:, 1:] += sub @ x[:, :-1]
    y[:, :-1] += sub.mT @ x[:, 1:]
    return y[..., 0] if vec else y


def block_arrow_matvec(diag, side, x, up: bool = False):
    """G x of a block-arrow batch by its blocks: coupling in the last block
    row, or in the first when ``up``; x is (B, nb, s) or (B, nb, s, k)."""
    x, vec = _with_cols(x)
    head, tip = ((slice(1, None), slice(0, 1)) if up
                 else (slice(0, -1), slice(-1, None)))
    y = diag @ x
    y[:, tip] += (side @ x[:, head]).sum(1, keepdim=True)
    y[:, head] += side.mT @ x[:, tip]
    return y[..., 0] if vec else y


def tri_block_to_dense(diag, sub):
    """The dense (B, n, n) matrix of a block-tridiagonal batch."""
    B, nb, s, _ = diag.shape
    M = diag.new_zeros((B, nb * s, nb * s))
    for i in range(nb):
        M[:, i * s:(i + 1) * s, i * s:(i + 1) * s] = diag[:, i]
    for i in range(nb - 1):
        M[:, (i + 1) * s:(i + 2) * s, i * s:(i + 1) * s] = sub[:, i]
        M[:, i * s:(i + 1) * s, (i + 1) * s:(i + 2) * s] = sub[:, i].mT
    return M


def block_arrow_to_dense(diag, side, up: bool = False):
    """The dense (B, n, n) matrix of a block-arrow batch: coupling in the
    last block row, or in the first when ``up``."""
    B, nb, s, _ = diag.shape
    M = diag.new_zeros((B, nb * s, nb * s))
    for i in range(nb):
        M[:, i * s:(i + 1) * s, i * s:(i + 1) * s] = diag[:, i]
    for i in range(nb - 1):
        if up:
            M[:, 0:s, (i + 1) * s:(i + 2) * s] = side[:, i]
            M[:, (i + 1) * s:(i + 2) * s, 0:s] = side[:, i].mT
        else:
            M[:, (nb - 1) * s:, i * s:(i + 1) * s] = side[:, i]
            M[:, i * s:(i + 1) * s, (nb - 1) * s:] = side[:, i].mT
    return M
