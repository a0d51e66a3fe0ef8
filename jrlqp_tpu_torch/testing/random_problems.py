"""Random QP/least-squares problem generator with known solution and
multipliers.

A numpy copy of :mod:`jrlqp_tpu.testing.random_problems`: the same
``np.random.Generator`` gives the same problem bit for bit.

Host-side (numpy) re-implementation of the reference generator
(ref: include/jrl-qp/test/randomProblems.h:16-146,
src/test/randomProblems.cpp:15-265). Problems are *constructed from a chosen
solution and multipliers*, so tests can assert both KKT satisfaction and
exact recovery of x / lambda. The construction follows the reference's six
steps: rank-controlled [A; C_act] with null-space multipliers, sign fixing,
weakly-active rows as combinations of strong rows, bound offsets from
multiplier signs, and a final Fisher-Yates shuffle.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .random_matrices import rand_dependent, rand_ortho, randn_rank

__all__ = ["ProblemCharacteristics", "RandomLeastSquare", "random_problem"]


@dataclasses.dataclass
class ProblemCharacteristics:
    """Mirror of ref randomProblems.h:16-116 (fluent setters included)."""

    n_var: int
    n_obj: int
    n_eq: int = 0
    n_ineq: int = 0
    rank_obj: int = -1  # -1 -> full
    n_shared_rank: int = 0
    n_strong_act_ineq: int = 0
    n_weak_act_ineq: int = 0
    n_strong_act_bounds: int = 0
    n_weak_act_bounds: int = 0
    bounds: bool = False
    double_sided_ineq: bool = False
    strictly_feasible: bool = False

    def __post_init__(self):
        if self.rank_obj < 0:
            self.rank_obj = self.n_obj

    def check(self):
        assert self.n_var >= self.n_obj >= 0
        assert self.n_var >= self.n_eq >= 0
        assert self.n_strong_act_ineq + self.n_weak_act_ineq <= self.n_ineq
        if self.bounds:
            assert self.n_strong_act_bounds + self.n_weak_act_bounds <= self.n_var
        else:
            assert self.n_strong_act_bounds == 0 and self.n_weak_act_bounds == 0
        assert self.n_eq + self.n_strong_act_ineq + self.n_strong_act_bounds <= self.n_var
        assert self.rank_obj <= self.n_obj
        assert self.n_shared_rank <= self.rank_obj

    # fluent setters matching the reference API
    def nEq(self, v):  # noqa: N802
        return dataclasses.replace(self, n_eq=v)

    def nIneq(self, v):  # noqa: N802
        return dataclasses.replace(self, n_ineq=v)

    def nStrongActIneq(self, v):  # noqa: N802
        return dataclasses.replace(self, n_strong_act_ineq=v)

    def nWeakActIneq(self, v):  # noqa: N802
        return dataclasses.replace(self, n_weak_act_ineq=v)

    def nStrongActBounds(self, v):  # noqa: N802
        return dataclasses.replace(self, n_strong_act_bounds=v)

    def nWeakActBounds(self, v):  # noqa: N802
        return dataclasses.replace(self, n_weak_act_bounds=v)

    def set_bounds(self, v=True):
        return dataclasses.replace(self, bounds=v)

    def doubleSidedIneq(self, v=True):  # noqa: N802
        return dataclasses.replace(self, double_sided_ineq=v)

    def strictlyFeasible(self, v=True):  # noqa: N802
        return dataclasses.replace(self, strictly_feasible=v)


@dataclasses.dataclass
class RandomLeastSquare:
    """min 0.5 |Ax-b|^2 s.t. Ex=f, l <= Cx <= u, xl <= x <= xu with known
    optimum (ref: randomProblems.h RandomLeastSquare)."""

    A: np.ndarray
    b: np.ndarray
    E: np.ndarray
    f: np.ndarray
    C: np.ndarray
    l: np.ndarray
    u: np.ndarray
    xl: np.ndarray
    xu: np.ndarray
    x: np.ndarray
    lambda_eq: np.ndarray
    lambda_ineq: np.ndarray
    lambda_bnd: np.ndarray
    bounds: bool

    def to_qp_arrays(self):
        """G = A^T A, a = -A^T b; equalities prepended to C with l == u
        (ref: problems.h:110-115). Returns dict of numpy arrays."""
        G = self.A.T @ self.A
        a = -self.A.T @ self.b
        C = np.vstack([self.E, self.C])
        l = np.concatenate([self.f, self.l])
        u = np.concatenate([self.f, self.u])
        n = self.A.shape[1]
        if self.bounds:
            xl, xu = self.xl, self.xu
        else:
            xl = np.full(n, -np.inf)
            xu = np.full(n, np.inf)
        objcst = 0.5 * float(self.b @ self.b)
        return dict(G=G, a=a, C=C, l=l, u=u, xl=xl, xu=xu, objcst=objcst)


def random_problem(characs: ProblemCharacteristics,
                   rng: np.random.Generator | None = None) -> RandomLeastSquare:
    """Reference construction (ref: src/test/randomProblems.cpp:15-251)."""
    if rng is None:
        rng = np.random.default_rng()
    characs.check()
    nVar = characs.n_var
    nObj = characs.n_obj
    nEq = characs.n_eq
    nIneq = characs.n_ineq
    rankObj = characs.rank_obj
    nSharedRank = characs.n_shared_rank
    nStrongActIneq = characs.n_strong_act_ineq
    nWeakActIneq = characs.n_weak_act_ineq
    nStrongActBounds = characs.n_strong_act_bounds
    nWeakActBounds = characs.n_weak_act_bounds
    bounds = characs.bounds
    doubleSided = characs.double_sided_ineq
    strictly = characs.strictly_feasible

    nstrong = nEq + nStrongActIneq + nStrongActBounds  # <= nVar
    nBounds = nVar if bounds else 0
    colsTot = nObj + nstrong

    # --- step 1: A, strongly-active constraint matrix Ca, and a vector
    # [u; v] in the null space of [A^T Ca^T] (the reduced multipliers) ---
    if nObj == 0:
        A = np.zeros((0, nVar))
        Ca = randn_rank(rng, nstrong, nVar)
        reduced = np.zeros(colsTot)
    elif nstrong == 0:
        A = randn_rank(rng, nObj, nVar, rankObj)
        Ca = np.zeros((0, nVar))
        reduced = np.zeros(colsTot)
    elif colsTot > nVar:
        rankTot = min(rankObj + nstrong - nSharedRank, nVar)
        A, Ca = rand_dependent(rng, nVar, nObj, rankObj, nstrong, nstrong, rankTot)
        if nStrongActBounds > 0:
            Ca[-nStrongActBounds:] = 0.0
            Ca[-nStrongActBounds:, :nStrongActBounds] = np.eye(nStrongActBounds)
        # More columns than nVar: pick a null-space combination through a
        # rank-revealing QR (ref :52-68), done here with SVD for simplicity.
        M = np.hstack([A.T, Ca.T])  # (nVar, colsTot)
        # null space of M (as an operator on multipliers): M @ reduced = 0
        _, s, Vt = np.linalg.svd(M)
        null_dim = colsTot - int(np.sum(s > s.max() * max(M.shape) * 1e-12)) if s.size else colsTot
        assert null_dim > 0
        N = Vt[colsTot - null_dim:].T  # (colsTot, null_dim)
        reduced = N @ rng.uniform(-1.0, 1.0, null_dim)
    else:
        rankTot = rankObj + nstrong - nSharedRank
        if rankTot == nVar:
            rankTot = nVar - 1  # keep a nontrivial null space (ref :73-74)
        A, Ca = rand_dependent(rng, nVar, nObj, rankObj, nstrong, nstrong, rankTot)
        if nStrongActBounds > 0:
            Ca[-nStrongActBounds:] = 0.0
            Ca[-nStrongActBounds:, :nStrongActBounds] = np.eye(nStrongActBounds)
        # reduced multipliers must satisfy [A; Ca]^T reduced = 0
        # (ref :78-84 takes the trailing columns of M's Q factor).
        M = np.vstack([A, Ca])  # (colsTot, nVar)
        U, s, _ = np.linalg.svd(M, full_matrices=True)
        rank = int(np.sum(s > (s.max() * max(M.shape) * 1e-12))) if s.size else 0
        N2 = U[:, rank:]  # (colsTot, colsTot-rank): null space of M^T
        if N2.shape[1] > 0:
            reduced = N2 @ rng.uniform(-1.0, 1.0, N2.shape[1])
        else:
            reduced = np.zeros(colsTot)

    # --- step 2: fix multiplier signs for single-sided inequalities
    # (ref :89-102) ---
    if not doubleSided and nStrongActIneq > 0:
        mult = reduced[nObj + nEq : nObj + nEq + nStrongActIneq]
        Ci = Ca[nEq : nEq + nStrongActIneq]
        neg = mult < 0
        mult[neg] = -mult[neg]
        Ci[neg] = -Ci[neg]

    # --- step 3: populate problem data (ref :104-124) ---
    pb_x = rng.uniform(-1.0, 1.0, nVar)
    E = Ca[:nEq].copy()
    lambdaEq = reduced[nObj : nObj + nEq].copy()
    C = np.zeros((nIneq, nVar))
    l = np.full(nIneq, -np.inf)
    u = np.zeros(nIneq)
    lambdaIneq = np.zeros(nIneq)
    C[:nStrongActIneq] = Ca[nEq : nEq + nStrongActIneq]
    lambdaIneq[:nStrongActIneq] = reduced[nObj + nEq : nObj + nEq + nStrongActIneq]
    xl = np.zeros(nBounds)
    xu = np.zeros(nBounds)
    lambdaBnd = np.zeros(nBounds)
    if nStrongActBounds > 0:
        lambdaBnd[:nStrongActBounds] = reduced[colsTot - nStrongActBounds:]

    # --- step 4: weakly active and inactive inequality rows (ref :126-157) ---
    if nWeakActIneq > 0:
        if nWeakActIneq <= nstrong:
            Q1 = rand_ortho(rng, nstrong)[:nWeakActIneq]
        else:
            Q1 = rand_ortho(rng, nWeakActIneq)[:, :nstrong]
        if strictly:
            mult = reduced[nObj:]
            Cw = (np.abs(Q1) * np.sign(mult)[None, :]) @ Ca
        else:
            Cw = Q1 @ Ca
        C[nStrongActIneq : nStrongActIneq + nWeakActIneq] = Cw
    nInact = nIneq - nStrongActIneq - nWeakActIneq
    if nInact > 0:
        C[nIneq - nInact :] = randn_rank(rng, nInact, nVar)

    # --- step 5: choose solution-consistent right-hand sides (ref :159-223) ---
    b = A @ pb_x - reduced[:nObj]
    f = E @ pb_x
    u[:] = C @ pb_x
    if doubleSided:
        l[:] = C @ pb_x
        rl = np.abs(rng.uniform(-1.0, 1.0, nIneq))
        ru = np.abs(rng.uniform(-1.0, 1.0, nIneq))
        for i in range(nStrongActIneq):
            if lambdaIneq[i] > 0:
                l[i] -= rl[i]
            else:
                u[i] += ru[i]
        # Weakly active rows: activate at the upper or lower side with a
        # 50-50 choice (ref :180-191 flips the row sign; keeping the row and
        # loosening the opposite side is equivalent and keeps l <= u valid).
        for i in range(nStrongActIneq, nStrongActIneq + nWeakActIneq):
            if rl[i] > ru[i]:
                l[i] -= rl[i]  # active at the upper bound
            else:
                u[i] += ru[i]  # active at the lower bound
        if nInact > 0:
            l[-nInact:] -= rl[-nInact:]
            u[-nInact:] += ru[-nInact:]
    else:
        if nInact > 0:
            u[-nInact:] += np.abs(rng.uniform(-1.0, 1.0, nInact))
    if bounds:
        r = rng.uniform(-1.0, 1.0, nVar)
        xl[:] = pb_x
        xu[:] = pb_x
        for i in range(nStrongActBounds):
            if lambdaBnd[i] > 0:
                xl[i] -= abs(r[i])
            else:
                xu[i] += abs(r[i])
        for i in range(nStrongActBounds, nStrongActBounds + nWeakActBounds):
            if r[i] > 0:
                xl[i] -= r[i]
            else:
                xu[i] -= r[i]
        nInactB = nVar - nStrongActBounds - nWeakActBounds
        if nInactB > 0:
            xl[-nInactB:] -= np.abs(rng.uniform(-1.0, 1.0, nInactB))
            xu[-nInactB:] += np.abs(rng.uniform(-1.0, 1.0, nInactB))

    # --- step 6: Fisher-Yates shuffles of rows then columns (ref :225-248) ---
    for i in range(nIneq - 1, 0, -1):
        j = int(rng.integers(0, i + 1))
        C[[i, j]] = C[[j, i]]
        u[[i, j]] = u[[j, i]]
        lambdaIneq[[i, j]] = lambdaIneq[[j, i]]
        if doubleSided:
            l[[i, j]] = l[[j, i]]
    if bounds:
        for i in range(nVar - 1, 0, -1):
            j = int(rng.integers(0, i + 1))
            A[:, [i, j]] = A[:, [j, i]]
            C[:, [i, j]] = C[:, [j, i]]
            E[:, [i, j]] = E[:, [j, i]]
            xl[[i, j]] = xl[[j, i]]
            xu[[i, j]] = xu[[j, i]]
            lambdaBnd[[i, j]] = lambdaBnd[[j, i]]
            pb_x[[i, j]] = pb_x[[j, i]]

    return RandomLeastSquare(
        A=A, b=b, E=E, f=f, C=C, l=l, u=u, xl=xl, xu=xu, x=pb_x,
        lambda_eq=lambdaEq, lambda_ineq=lambdaIneq, lambda_bnd=lambdaBnd,
        bounds=bounds,
    )
