"""CPU references that take the block kernels' sums in the kernels' own
order, so a kernel's outputs can be held to them bit for bit.

Each reference runs f32 torch ops on the CPU, one rounding per op: a
product and a sum are separate tensors, so nothing is contracted into an
FMA that the kernel does not make, and an FMA that the kernel does make is
taken by :func:`fma32`, rounded once. The kernels:

- K2 (``csrc/block_llt.cuh`` ``chol_inv_block``): :func:`k2_order_exact`;
- K5 (``csrc/struct_llt.cu`` ``tri_llt_kernel``): :func:`k5_order_exact`;
- K7 (``arrow_llt_kernel``): :func:`k7_order_exact`.

K5's and K7's block products are one FMA chain per output, k ascending from
0: :func:`chain_nt`. A symmetric product ``P P^T`` is bitwise symmetric
(each output's chain runs over the same pair of rows, and an FMA does not
depend on the order of its two factors), which K5 and K7 use to compute it
on and below the diagonal only.

Imports torch only.
"""
from __future__ import annotations

import torch

__all__ = ["fma32", "k2_order_exact", "chain_nt", "k5_order_exact",
           "k7_order_exact"]


def fma32(a, b, c):
    """fma(a, b, c) of f32 tensors, rounded once to f32: a b + c in f64
    (the product is exact), with the error of that sum carried over when
    it lands on a tie of f32 rounding."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    inf = torch.full_like(r, float("inf"))
    toward = torch.nextafter(r, torch.where(s > r.double(), inf, -inf))
    tie = (s != r.double()) & (2 * s == r.double() + toward.double())
    fix = tie & (((toward.double() > s) & (e > 0))
                 | ((toward.double() < s) & (e < 0)))
    return torch.where(fix, toward, r)


def k2_order_exact(A):
    """(L, L^-1) of (B, s, s) f32 blocks on the CPU in K2's own order: the
    right-looking Cholesky with 1 / sqrt of the pivot clamped at 1e-30, each
    trailing entry updated as A - (A_ij isq)(A_jc isq) from the square
    block, then the row-wise inverse, each sum k ascending; every product
    and sum rounded apart (separate torch ops)."""
    A = A.detach().cpu().clone()
    B, s, _ = A.shape
    for j in range(s):
        piv = A[:, j, j]
        pc = torch.where(torch.isnan(piv), piv, torch.clamp_min(piv, 1e-30))
        # the square root correctly rounded, as CUDA's sqrtf (torch's
        # vectorized CPU sqrt is not): in f64, then to f32, which is exact
        isq = (1.0 / pc.double().sqrt().float())[:, None]
        li = A[:, j + 1:, j] * isq
        lc = A[:, j, j + 1:] * isq
        A[:, j + 1:, j + 1:] = (A[:, j + 1:, j + 1:]
                                - li[:, :, None] * lc[:, None, :])
        A[:, j:, j] = A[:, j:, j] * isq
    L = torch.tril(A)
    X = torch.zeros_like(L)
    cols = torch.arange(s)
    for i in range(s):
        acc = torch.zeros(B, s)
        for k in range(i):
            acc = torch.where(cols <= k, acc + L[:, i, k:k + 1] * X[:, k],
                              acc)
        v = ((cols == i).to(torch.float32) - acc) / L[:, i, i:i + 1]
        X[:, i] = torch.where(cols <= i, v, 0.0)
    return L, X


def chain_nt(P, Q, q_lower: bool = False):
    """Y[r][c] = sum over k of P[r][k] Q[c][k] for (B, s, s) f32 blocks, as
    one FMA chain per output from 0, k ascending; with ``q_lower`` the chain
    of Y[r][c] stops at k = c (Q lower triangular: no term of its zero half
    is added)."""
    P, Q = P.detach().cpu(), Q.detach().cpu()
    B, s, _ = P.shape
    cols = torch.arange(s)
    Y = torch.zeros(B, s, s)
    for k in range(s):
        t = fma32(P[:, :, k, None], Q[:, None, :, k], Y)
        Y = torch.where(cols >= k, t, Y) if q_lower else t
    return Y


def k5_order_exact(diag, off):
    """(L_diag, L_off, Linv_diag) of a tri-block-diagonal f32 batch, diag
    (B, nb, s, s) and off (B, nb-1, s, s), in K5's order: L_i, L_i^-1 =
    K2 of D_i - M_{i-1} (D_0 as it is), S'_i = chain_nt(S_i, L_i^-1,
    q_lower) and M_i = chain_nt(S'_i, S'_i), the subtraction one f32 op."""
    diag, off = diag.detach().cpu(), off.detach().cpu()
    B, nb, s, _ = diag.shape
    Ls, Lis, Sps = [], [], []
    a = diag[:, 0]
    for i in range(nb):
        L, X = k2_order_exact(a)
        Ls.append(L)
        Lis.append(X)
        if i < nb - 1:
            Sp = chain_nt(off[:, i], X, q_lower=True)
            Sps.append(Sp)
            a = diag[:, i + 1] - chain_nt(Sp, Sp)
    Lo = torch.stack(Sps, 1) if Sps else diag.new_zeros((B, 0, s, s))
    return torch.stack(Ls, 1), Lo, torch.stack(Lis, 1)


def k7_order_exact(diag, side, up: bool = False):
    """(L_diag, L_side, Linv_diag) of a block-arrow f32 batch in K7's order:
    each head's L_i, L_i^-1 = K2 of D_i, B_i = chain_nt(S_i, L_i^-1,
    q_lower), acc = (((0 + P_0) + P_1) + ...) with P_i = chain_nt(B_i, B_i)
    (each + one f32 op, heads in order), and the last block K2 of
    D_last - acc. An up arrow is factored in the rolled block order
    (diag block (i + 1) % nb as block i)."""
    diag, side = diag.detach().cpu(), side.detach().cpu()
    if up:
        diag = torch.roll(diag, -1, dims=1)
    B, nb, s, _ = diag.shape
    Ls, Lis, Bs = [], [], []
    acc = torch.zeros(B, s, s)
    for i in range(nb - 1):
        L, X = k2_order_exact(diag[:, i])
        Bi = chain_nt(side[:, i], X, q_lower=True)
        Ls.append(L)
        Lis.append(X)
        Bs.append(Bi)
        acc = acc + chain_nt(Bi, Bi)
    L, X = k2_order_exact(diag[:, -1] - acc)
    Ls.append(L)
    Lis.append(X)
    Lo = torch.stack(Bs, 1) if Bs else diag.new_zeros((B, 0, s, s))
    return torch.stack(Ls, 1), Lo, torch.stack(Lis, 1)
