"""The plain reference: a sequential numpy Goldfarb-Idnani solver.

A frozen copy of ``jrlqp_tpu_torch/reference_impl.solve_np`` (itself the
port of the JAX package's executable spec, the reference's Matlab
prototypes): dual active set on J = L^-T and R, one Householder reflector
per add, Givens rotations per removal, one lane at a time with dynamic
shapes. Two changes: the most-violated scan is one numpy argmin over the
inactive rows (the same choice: the first row of the least slack, general
rows before bounds, only below zero), and ``dtype`` runs the whole solve in
float32 for the control. It imports numpy alone, nothing of the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# TerminationStatus / ActivationStatus values of the solver family
SUCCESS, INFEASIBLE, MAX_ITER_REACHED = 0, 3, 4
NON_POS_HESSIAN, LINEAR_DEPENDENCY_DETECTED = 2, 5
LOWER, UPPER, EQUALITY = 1, 2, 3
LOWER_BOUND, UPPER_BOUND, FIXED = 4, 5, 6
BIG = float("inf")  # the copy's 1e100, which float32 cannot hold


@dataclasses.dataclass
class Answer:
    x: np.ndarray
    multipliers: np.ndarray  # (m+n,), external convention
    iterations: int
    status: int


def solve(G, a, C, l, u, xl, xu, max_iter=1000, dtype=np.float64) -> Answer:
    """Solve min 0.5 x'Gx + a'x s.t. l <= Cx <= u, xl <= x <= xu."""
    G, a, C, l, u, xl, xu = (np.array(v, dtype=dtype)
                             for v in (G, a, C, l, u, xl, xu))
    n, m = len(a), C.shape[0]
    active: list = []      # (idx, status) in activation order
    ustar: list = []       # their multipliers
    status = np.zeros(m + n, dtype=int)

    def finish(x, code, it):
        mult = np.zeros(m + n)
        for (idx, s_), uk in zip(active, ustar):
            mult[idx] = uk if s_ in (UPPER, UPPER_BOUND) else -uk
        return Answer(x=np.asarray(x, dtype=np.float64), multipliers=mult,
                      iterations=it, status=int(code))

    def normal(idx, st):
        sign = -1.0 if st in (UPPER, UPPER_BOUND) else 1.0
        if st >= LOWER_BOUND:
            e = np.zeros(n, dtype=dtype)
            e[idx - m] = 1.0
            return sign * e
        return sign * C[idx]

    def bound(idx, st):
        if st >= LOWER_BOUND:
            i = idx - m
            return xu[i] if st == UPPER_BOUND else xl[i]
        return u[idx] if st == UPPER else l[idx]

    try:
        L = np.linalg.cholesky(G)
    except np.linalg.LinAlgError:
        return finish(np.zeros(n), NON_POS_HESSIAN, 0)
    J = np.linalg.solve(L, np.eye(n, dtype=dtype)).T
    R = np.zeros((n, 0), dtype=dtype)
    x = -np.linalg.solve(G, a)

    def step(idx, stc):
        npv = normal(idx, stc)
        d = J.T @ npv
        q = len(active)
        z = J[:, q:] @ d[q:]
        r = np.linalg.solve(R[:q, :q], d[:q]) if q else d[:0].copy()
        return npv, d, z, r

    def add(d, idx, stc):
        nonlocal J, R
        q = len(active)
        v = d.copy()
        v[:q] = 0.0
        nv = np.linalg.norm(v)
        if nv <= 1e-300:
            return False
        alpha = -nv if d[q] >= 0 else nv
        w = v.copy()
        w[q] -= alpha
        ww = w @ w
        if ww > 0:
            J = J - (2.0 / ww) * np.outer(J @ w, w)
        col = np.zeros(n, dtype=dtype)
        col[:q] = d[:q]
        col[q] = alpha
        R = np.column_stack([R, col])
        active.append((idx, stc))
        status[idx] = stc
        return True

    def remove(pos):
        nonlocal J, R
        idx, _ = active.pop(pos)
        status[idx] = 0
        R = np.delete(R, pos, axis=1)
        for i in range(pos, R.shape[1]):
            aa, bb = R[i, i], R[i + 1, i]
            rad = np.hypot(aa, bb)
            if rad == 0:
                continue
            c, s = aa / rad, bb / rad
            rot = np.array([[c, s], [-s, c]], dtype=dtype)
            R[[i, i + 1], :] = rot @ R[[i, i + 1], :]
            J[:, [i, i + 1]] = J[:, [i, i + 1]] @ rot.T
        del ustar[pos]

    # equalities and fixed variables first, by a full step each
    eq = [(i, EQUALITY) for i in range(m) if l[i] == u[i]]
    eq += [(m + i, FIXED) for i in range(n) if xl[i] == xu[i]]
    for idx, stc in eq:
        npv, d, z, r = step(idx, stc)
        nz = npv @ z
        t = (bound(idx, stc) - npv @ x) / nz if np.linalg.norm(z) > 1e-14 \
            else 0.0
        x = x + t * z
        for k in range(len(active)):
            ustar[k] -= t * r[k]
        ustar.append(t)
        if not add(d, idx, stc):
            return finish(x, LINEAR_DEPENDENCY_DETECTED, 0)
    if len(active) > n:
        return finish(x, LINEAR_DEPENDENCY_DETECTED, 0)

    sel = None
    u_cand = 0.0
    for it in range(1, max_iter + 1):
        if sel is None:
            cx = C @ x
            sl = np.concatenate([cx - l, x - xl])
            su = np.concatenate([u - cx, xu - x])
            v = np.where(status != 0, np.inf, np.minimum(sl, su))
            i = int(np.argmin(v))
            if not v[i] < 0:
                return finish(x, SUCCESS, it)
            lower = sl[i] <= su[i]
            sel = (i, (LOWER if lower else UPPER) if i < m
                   else (LOWER_BOUND if lower else UPPER_BOUND))
            u_cand = 0.0

        idx, stc = sel
        npv, d, z, r = step(idx, stc)
        t1, lpos = BIG, -1
        for k in range(len(active)):
            if active[k][1] in (EQUALITY, FIXED) or r[k] <= 0:
                continue
            tk = ustar[k] / r[k]
            if tk < t1:
                t1, lpos = tk, k
        sign = -1.0 if stc in (UPPER, UPPER_BOUND) else 1.0
        nz = npv @ z
        t2 = ((sign * bound(idx, stc) - npv @ x) / nz
              if np.linalg.norm(z) > 1e-14 else BIG)
        t = min(t1, t2)
        if t >= BIG:
            return finish(x, INFEASIBLE, it)
        if t2 >= BIG:           # dual step only
            for k in range(len(active)):
                ustar[k] -= t * r[k]
            u_cand += t
            remove(lpos)
            continue
        x = x + t * z
        for k in range(len(active)):
            ustar[k] -= t * r[k]
        u_cand += t
        if t == t2:             # full step: the candidate becomes active
            if not add(d, idx, stc):
                return finish(x, LINEAR_DEPENDENCY_DETECTED, it)
            ustar.append(u_cand)
            sel = None
        else:                   # partial step: drop the blocking row
            remove(lpos)
    return finish(x, MAX_ITER_REACHED, max_iter)


def solve_lanes(qp: dict, lanes, max_iter=1000, dtype=np.float64) -> list:
    """:func:`solve` on lanes ``lanes`` of a numpy batch ``qp`` (the keys of
    ``gen.QP``)."""
    keys = ("G", "a", "C", "l", "u", "xl", "xu")
    return [solve(*(qp[k][i] for k in keys), max_iter=max_iter, dtype=dtype)
            for i in lanes]
