"""Random matrix generators for problem synthesis.

A numpy copy of :mod:`jrlqp_tpu.testing.random_matrices`: the same
``np.random.Generator`` gives the same arrays bit for bit. Host-side (numpy)
re-implementation of the reference generators
(ref: include/jrl-qp/test/randomMatrices.h:62-215). Matrix *distributions*
match the reference (Haar-orthogonal, fixed-rank with variance correction,
rank-coupled pairs); the construction uses numpy QR instead of the
reference's Householder accumulation -- same distribution, simpler code.
"""
from __future__ import annotations

import numpy as np

__all__ = ["rand_ortho", "randn_rank", "rand_dependent"]


def rand_ortho(rng: np.random.Generator, size: int, special: bool = False) -> np.ndarray:
    """Haar-distributed orthogonal matrix (ref: randomMatrices.h:62-127).

    QR of a Gaussian matrix with R-diagonal sign correction gives the Haar
    measure on O(size); ``special`` forces det = +1 (SO(size)).
    """
    if size == 0:
        return np.zeros((0, 0))
    A = rng.standard_normal((size, size))
    Q, R = np.linalg.qr(A)
    d = np.sign(np.diag(R))
    d[d == 0] = 1.0
    Q = Q * d[None, :]
    if special and np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


def randn_rank(rng: np.random.Generator, rows: int, cols: int, rank: int = -1) -> np.ndarray:
    """Random matrix of prescribed rank whose entries are empirically
    ~ N(0, 1) (ref: randomMatrices.h:149-178 incl. the sqrt(3*rows*cols/rank)
    variance correction)."""
    p = min(rows, cols)
    if rank < 0:
        rank = p
    assert rank <= p, "Invalid rank"
    if rank == 0:
        return np.zeros((rows, cols))
    if rank == p:
        return rng.standard_normal((rows, cols))
    s = np.zeros(p)
    s[:rank] = rng.uniform(-1.0, 1.0, rank) * np.sqrt(3.0 * rows * cols / rank)
    if rows <= cols:
        M = np.zeros((rows, cols))
        M[:, :rows] = rand_ortho(rng, rows) * s[None, :]
        return M @ rand_ortho(rng, cols)
    else:
        M = np.zeros((rows, cols))
        M[:cols, :] = s[:, None] * rand_ortho(rng, cols)
        return rand_ortho(rng, rows) @ M


def rand_dependent(rng: np.random.Generator, cols: int, rows_a: int, rank_a: int,
                   rows_b: int, rank_b: int, rank_ab: int):
    """Two matrices A (rows_a x cols, rank rank_a) and B (rows_b x cols,
    rank rank_b) with rank([A; B]) == rank_ab
    (ref: randomMatrices.h:189-215)."""
    assert rank_a <= rows_a and rank_a <= cols
    assert rank_b <= rows_b and rank_b <= cols
    assert rank_ab >= rank_a and rank_ab >= rank_b
    assert rank_ab <= rank_a + rank_b and rank_ab <= cols
    M = randn_rank(rng, rank_a + rank_b, cols, rank_ab)
    if rank_a == rows_a:
        A = M[:rank_a]
    else:
        A = rand_ortho(rng, rows_a)[:, :rank_a] @ M[:rank_a]
    if rank_b == rows_b:
        B = M[rank_a:]
    else:
        B = rand_ortho(rng, rows_b)[:, :rank_b] @ M[rank_a:]
    return A, B
