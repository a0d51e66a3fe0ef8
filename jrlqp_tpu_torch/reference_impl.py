"""Sequential numpy Goldfarb-Idnani solver -- the executable spec.

Plays the role of the reference's Matlab prototypes (ref: matlab/
DualQPSolver.m + GoldfarbIdaniQP.m, SURVEY.md #37): a direct, dynamically
shaped, sequential implementation of the same dual active-set iteration
(ref: src/DualSolver.cpp:91-168 and the notes/DualQP derivation), written
independently of the fixed-shape JAX solver. Differential tests run both on
the same problems and require matching solutions/multipliers -- two
implementations of the same math cross-checking each other, like the
reference's structured-vs-dense tests.

Not a performance path: numpy, Python loops, dynamic shapes. The port's
own copy of :mod:`jrlqp_tpu.reference_impl` (the same numpy code, so the
same problems give the same bits), on the port's :mod:`.types`; nothing on a
card path calls it.

Conventions identical to :mod:`jrlqp_tpu_torch.solver.dense`:
- constraints one per row of C; bounds appended after general constraints
  in the (m+n,) status/multiplier vectors;
- internal multipliers u >= 0 against signed normals (UPPER negated);
- external multipliers negative at lower/equality activations, positive at
  upper (ref: DualSolver.cpp:38-69).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .types import (
    EQUALITY,
    FIXED,
    INFEASIBLE,
    LINEAR_DEPENDENCY_DETECTED,
    LOWER,
    LOWER_BOUND,
    MAX_ITER_REACHED,
    NON_POS_HESSIAN,
    SUCCESS,
    UPPER,
    UPPER_BOUND,
)

__all__ = ["solve_np", "NpResult"]

BIG = 1e100


@dataclasses.dataclass
class NpResult:
    x: np.ndarray
    multipliers: np.ndarray  # (m+n,), external convention
    f: float
    iterations: int
    status: int
    active_set: np.ndarray  # (m+n,) int status vector


def _tri_solve_upper(R, b):
    return np.linalg.solve(R, b) if R.size else b.copy()


class _State:
    def __init__(self, G, a, C, l, u, xl, xu):
        self.n = len(a)
        self.m = C.shape[0]
        self.G, self.a, self.C = G, a, C
        self.l, self.u, self.xl, self.xu = l, u, xl, xu
        self.active: list[tuple[int, int]] = []  # (idx, status) in activation order
        self.ustar: list[float] = []  # condensed multipliers, activation order
        self.status = np.zeros(self.m + self.n, dtype=int)
        self.it = 0

    @property
    def q(self):
        return len(self.active)

    def normal(self, idx, st):
        """Signed constraint normal (ref: ConstraintNormal.h:81-102)."""
        sign = -1.0 if st in (UPPER, UPPER_BOUND) else 1.0
        if st >= LOWER_BOUND:
            e = np.zeros(self.n)
            e[idx - self.m] = 1.0
            return sign * e
        return sign * self.C[idx]

    def bound(self, idx, st):
        if st >= LOWER_BOUND:
            i = idx - self.m
            return self.xu[i] if st == UPPER_BOUND else self.xl[i]
        return self.u[idx] if st == UPPER else self.l[idx]


def solve_np(G, a, C, l, u, xl=None, xu=None, max_iter=500):
    """Solve min 0.5 x'Gx + a'x s.t. l <= Cx <= u, xl <= x <= xu."""
    G = np.array(G, dtype=float)
    a = np.asarray(a, dtype=float)
    C = np.asarray(C, dtype=float).reshape(-1, len(a))
    l = np.asarray(l, dtype=float)
    u = np.asarray(u, dtype=float)
    n = len(a)
    m = C.shape[0]
    if xl is None:
        xl = np.full(n, -np.inf)
    if xu is None:
        xu = np.full(n, np.inf)
    xl = np.asarray(xl, dtype=float)
    xu = np.asarray(xu, dtype=float)

    st = _State(G, a, C, l, u, xl, xu)

    # --- init (ref: GoldfarbIdnaniSolver.cpp:56-82) ---
    try:
        L = np.linalg.cholesky(G)
    except np.linalg.LinAlgError:
        return NpResult(np.zeros(n), np.zeros(m + n), 0.0, 0, NON_POS_HESSIAN,
                        st.status.copy())
    J = np.linalg.solve(L, np.eye(n)).T  # J = L^{-T}
    R = np.zeros((n, 0))
    x = -np.linalg.solve(G, a)
    f = 0.5 * a @ x

    def compute_step(idx, stc):
        npv = st.normal(idx, stc)
        d = J.T @ npv
        q = st.q
        z = J[:, q:] @ d[q:]
        r = _tri_solve_upper(R[:q, :q], d[:q])
        return npv, d, z, r

    def add_constraint(d, idx, stc):
        """Householder zeroing of d[q+1:]; J <- J H; R gains a column
        (ref: addConstraint_ :221-237, implemented with one reflector)."""
        nonlocal J, R
        q = st.q
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
        newcol = np.zeros(n)
        newcol[:q] = d[:q]
        newcol[q] = alpha
        R = np.column_stack([R, newcol])
        st.active.append((idx, stc))
        st.status[idx] = stc
        return True

    def remove_constraint(pos):
        """Delete column pos of R, restore triangularity with Givens applied
        to J on the right (ref: removeConstraint_ :239-256)."""
        nonlocal J, R
        idx, _ = st.active.pop(pos)
        st.status[idx] = 0
        R = np.delete(R, pos, axis=1)
        for i in range(pos, R.shape[1]):
            aa, bb = R[i, i], R[i + 1, i]
            rad = np.hypot(aa, bb)
            if rad == 0:
                continue
            c, s = aa / rad, bb / rad
            rot = np.array([[c, s], [-s, c]])
            R[[i, i + 1], :] = rot @ R[[i, i + 1], :]
            J[:, [i, i + 1]] = J[:, [i, i + 1]] @ rot.T
        del st.ustar[pos]

    def add_initial(idx, stc):
        """Full step onto an equality/fixed constraint
        (ref: addInitialConstraint :295-338)."""
        nonlocal x, f
        npv, d, z, r = compute_step(idx, stc)
        b = st.bound(idx, stc)
        nz = npv @ z
        t = (b - npv @ x) / nz if np.linalg.norm(z) > 1e-14 else 0.0
        x = x + t * z
        f = f + t * nz * (0.5 * t)
        for k in range(st.q):
            st.ustar[k] -= t * r[k]
        st.ustar.append(t)
        return add_constraint(d, idx, stc)

    # auto-activate equalities and fixed variables (ref: initActiveSet)
    for i in range(m):
        if l[i] == u[i]:
            if not add_initial(i, EQUALITY):
                return _finalize(st, x, f, LINEAR_DEPENDENCY_DETECTED)
    for i in range(n):
        if xl[i] == xu[i]:
            if not add_initial(m + i, FIXED):
                return _finalize(st, x, f, LINEAR_DEPENDENCY_DETECTED)
    if st.q > n:
        return _finalize(st, x, f, LINEAR_DEPENDENCY_DETECTED)

    # --- main loop (ref: DualSolver.cpp:103-166) ---
    sel = None
    u_cand = 0.0
    for st.it in range(1, max_iter + 1):
        if sel is None:
            # step 1: most-violated scan, constraints then bounds
            best = 0.0
            sel = None
            cx = C @ x if m else np.zeros(0)
            for i in range(m):
                if st.status[i] != 0:
                    continue
                sl_ = cx[i] - l[i]
                su_ = u[i] - cx[i]
                v, s_ = (sl_, LOWER) if sl_ <= su_ else (su_, UPPER)
                if v < best:
                    best, sel = v, (i, s_)
            for i in range(n):
                if st.status[m + i] != 0:
                    continue
                sl_ = x[i] - xl[i]
                su_ = xu[i] - x[i]
                v, s_ = (sl_, LOWER_BOUND) if sl_ <= su_ else (su_, UPPER_BOUND)
                if v < best:
                    best, sel = v, (m + i, s_)
            if sel is None:
                return _finalize(st, x, f, SUCCESS, it=st.it)
            u_cand = 0.0

        idx, stc = sel
        npv, d, z, r = compute_step(idx, stc)

        # step 2b: step lengths
        t1, lpos = BIG, -1
        for k in range(st.q):
            ai, as_ = st.active[k]
            if as_ in (EQUALITY, FIXED) or r[k] <= 0:
                continue
            tk = st.ustar[k] / r[k]
            if tk < t1:
                t1, lpos = tk, k
        sign = -1.0 if stc in (UPPER, UPPER_BOUND) else 1.0
        b = st.bound(idx, stc)
        nz = npv @ z
        t2 = (sign * b - npv @ x) / nz if np.linalg.norm(z) > 1e-14 else BIG
        t = min(t1, t2)
        if t >= BIG:
            return _finalize(st, x, f, INFEASIBLE, it=st.it)

        if t2 >= BIG:  # dual-only step
            for k in range(st.q):
                st.ustar[k] -= t * r[k]
            u_cand += t
            remove_constraint(lpos)
            continue  # keep candidate, skip selection

        # primal step
        x = x + t * z
        f = f + t * nz * (0.5 * t + u_cand)
        for k in range(st.q):
            st.ustar[k] -= t * r[k]
        u_cand += t
        if t == t2:  # full step: activate candidate
            if not add_constraint(d, idx, stc):
                return _finalize(st, x, f, LINEAR_DEPENDENCY_DETECTED, it=st.it)
            st.ustar.append(u_cand)
            sel = None
        else:  # partial step: drop blocking constraint, keep candidate
            remove_constraint(lpos)

    return _finalize(st, x, f, MAX_ITER_REACHED, it=max_iter)


def _finalize(st, x, f, code, it=0):
    mult = np.zeros(st.m + st.n)
    for (idx, s_), uk in zip(st.active, st.ustar):
        mult[idx] = uk if s_ in (UPPER, UPPER_BOUND) else -uk
    return NpResult(
        x=x, multipliers=mult, f=float(f), iterations=it, status=int(code),
        active_set=st.status.copy(),
    )
