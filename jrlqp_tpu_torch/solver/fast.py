"""Throughput GI engine: the f32 kernels plus f64 iterative refinement.

Counterpart of :mod:`jrlqp_tpu.solver.fast` on six paths:

- the main path ``solve_refined_kernel`` (``solve_refined_pallas(...,
  fused_init=True)``): the whole f32 solve in the fused kernel K1; with
  ``fused_init=False`` (the JAX default) the torch cold init, then the
  loop in K3;
- the hint warm start ``solve_refined_warm_kernel``
  (``solve_refined_warm_pallas``): the warm init here in batched torch
  (hint processing, M = N^T G^-1 N by Cholesky, the closed form, the u < 0
  deactivations), then the loop in K3;
- the trajectory carry ``solve_refined_kernel_carry``
  (``solve_refined_pallas_carry``): a cold K1 step, then K4 steps that
  start from the previous step's operators;
- the compact-slot path ``solve_refined_kernel_compact``
  (``solve_refined_pallas(..., pack=1)``): the torch cold init, then the
  loop in K9;
- the rescue ``solve_refined_kernel_rescued``
  (``solve_refined_pallas_rescued``): the torch cold init and K3, then the
  f64 J/R engine (:mod:`.dense`) for the lanes that fail.
- the compacted solve ``solve_refined_kernel_compacted``
  (``solve_refined_pallas_compacted``): the torch cold init and K3 to a
  reduced cap, then K3 again on the lanes that hit it.

The kernels (:mod:`jrlqp_tpu_torch.ops.cuda.gi_kernel`) produce the
explicit operators H = G^-1 (I - N N*) and N*; a few steps of
mixed-precision refinement on the final active set then take the KKT
residual to <= 1e-8:

    r1 = N lam - G x - a,  r2 = b - N^T x           (f64)
    dx = H r1 + N*^T r2,   dlam = N* (G N*^T r2 - r1)  (f32 operators)

The refinement is the native-f64 branch of ``_refine_batch``
(fast.py:397-548): the GPU has f64, so the double-single emulation and the
one-hot gathers of the TPU branch become plain f64 products,
``torch.gather`` and ``scatter_add``.

The XLA engine is here too, batched: compact slots that shift on removal,
not the kernels' hole-based slots. Its cold inits (``_init_fast``,
``_init_fast_from_ops``) serve the warm init's fallback and the structured
layer; ``_init_fast_from_carry`` starts its loop from a carried operator
(the plain version of K12, ``ops/cuda/carry_init.py``, which runs it on a
card in one launch).
Its loop, which the JAX package compiles into one ``lax.while_loop`` of
``fast_iteration`` (fast.py:349, :911), is the GI loop of the structured
path, whose n is too large for K1-K9's shared memory, of the engine
``solve_refined`` and of ``solve_fast`` / ``solve_fast_warm`` (no
refinement, the problems' dtype). ``_run_loop`` runs it as one launch of
the CUDA kernel K11 on a card (``ops/cuda/fast_loop.py``,
``csrc/fast_loop.cu``: a thread block per lane, its iterations back to
back). Its plain version :func:`fast_loop_plain`, which the tracer's
hooked loop also runs, is :func:`fast_iteration` on every lane in a host
loop while any lane is RUNNING.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops.cuda.gi_kernel import (
    prepare_warm,
    prepare_warm_carry,
    run_loop,
    run_loop_compact,
    run_loop_fused,
    run_loop_fused_carry,
    warm_step,
)
from ..problems import QPProblem
from ..types import (
    EQUALITY,
    FIXED,
    INCONSISTENT_INPUT,
    INFEASIBLE,
    LINEAR_DEPENDENCY_DETECTED,
    LOWER_BOUND,
    MAX_ITER_REACHED,
    NON_POS_HESSIAN,
    OVERCONSTRAINED_PROBLEM,
    RUNNING,
    SUCCESS,
    UPPER,
    UPPER_BOUND,
    SolverOptions,
)
from ..testing.kkt import kkt_residual
from ..utils import spans
from ..validation import inconsistent_mask
from .dense import (
    _bmtv,
    _bmv,
    _constraint_normal,
    _dot,
    _safe_cholesky,
    _select_violated,
    _selected_bound,
    _where_state,
    finalize,
)
from .state import GIResult

__all__ = ["FastState", "WarmCarry", "solve_refined_kernel",
           "solve_refined_warm_kernel", "solve_refined_kernel_carry",
           "solve_refined_kernel_compact", "solve_refined_kernel_compacted",
           "solve_refined_kernel_rescued",
           "fast_iteration", "fast_loop_plain", "solve_refined",
           "solve_fast", "solve_fast_warm"]


@dataclasses.dataclass(frozen=True)
class FastState:
    """Batched final state of the f32 loop (``jrlqp_tpu.solver.fast.
    FastState`` with a leading batch dimension)."""

    x: torch.Tensor        # (B, n)
    f: torch.Tensor        # (B,)
    H: torch.Tensor        # (B, n, n) reduced inverse Hessian
    Ns: torch.Tensor       # (B, n, n) row k = N* row of active slot k
    status: torch.Tensor   # (B, m+n) int32
    aorder: torch.Tensor   # (B, n) int32, -1 marks a free slot
    u: torch.Tensor        # (B, n+1) multipliers by slot
    q: torch.Tensor        # (B,) int32
    it: torch.Tensor       # (B,) int32
    term: torch.Tensor     # (B,) int32
    skip1: torch.Tensor    # (B,) bool
    sc_idx: torch.Tensor   # (B,) int32
    sc_status: torch.Tensor  # (B,) int32
    hscale: torch.Tensor   # (B,) trace(G^-1) at init


def _state_from_kernel_out(out: dict, B: int) -> FastState:
    """Batched FastState from the fused kernel's output dict (fast.py:752)."""
    u = out["u"]
    return FastState(
        x=out["x"],
        f=torch.zeros((B,), dtype=torch.float32, device=u.device),
        H=out["H"],
        Ns=out["Ns"],
        status=out["status"],
        aorder=out["aorder"],
        u=torch.cat([u, torch.zeros_like(u[:, :1])], dim=1),
        q=out["q"],
        it=out["it"],
        term=out["term"],
        skip1=out["skip1"].bool(),
        sc_idx=out["sc_idx"],
        sc_status=out["sc_status"],
        hscale=out["hscale"],
    )


def _validated(pb: QPProblem, st: FastState, opt: SolverOptions
               ) -> FastState:
    """With ``opt.validate``, INCONSISTENT_INPUT on lanes whose data is
    inconsistent."""
    if not opt.validate:
        return st
    return dataclasses.replace(st, term=torch.where(
        inconsistent_mask(pb), INCONSISTENT_INPUT, st.term).to(torch.int32))


def _refine_batch(pbs: QPProblem, st: FastState, ir_steps: int,
                  products=None) -> GIResult:
    """:func:`_refine` in a span ``jrlqp.refine``. ``products(slots)``
    makes the refinement's products from its :class:`_Slots`; by default
    :class:`_DenseProducts` on ``pbs``'s G and C (``functools.partial(
    _DenseProducts, pbs, exact=True)`` recomputes them in f64 at every
    step)."""
    with spans.span("jrlqp.refine", pbs.a):
        return _refine(pbs, st, ir_steps, products or functools.partial(
            _DenseProducts, pbs))


@dataclasses.dataclass(frozen=True)
class _Slots:
    """The active slots of a final state, slot-major (n of them): slot k
    holds the constraint ``idxs[k]`` (0 at a free slot) with the sign
    ``sgn64[k]`` (-1 UPPER-active, 1 otherwise, 0 at a free slot), a bound
    row where ``is_b``, and the signed bound ``b[k]``; ``a64`` is the
    problem's linear term. Its signed normal is sgn_k C[idx_k] for a
    general row and sgn_k e_(idx_k - m) for a bound: N^T v gathers [C v, v]
    at the slots, and N lam = C^T mu_c + mu_b scatters each multiplier alone
    into its row, so both are exact given C v and C^T mu_c."""

    valid: torch.Tensor
    idxs: torch.Tensor
    sgn64: torch.Tensor
    is_b: torch.Tensor
    b: torch.Tensor
    a64: torch.Tensor
    m: int

    def t(self, cv, v):
        """N^T v from C v (B, m) and v (B, n)."""
        return self.sgn64 * torch.cat([cv, v], dim=1).gather(1, self.idxs)

    def split(self, lam):
        """(mu_c (B, m), mu_b (B, n)) with N lam = C^T mu_c + mu_b."""
        B, n = lam.shape
        signed = self.sgn64 * lam
        cidx = self.idxs.clamp(0, max(self.m - 1, 0))
        at_c = torch.where(self.is_b, self.m, cidx)
        at_b = torch.where(self.is_b, (self.idxs - self.m).clamp(0, n - 1),
                           n)
        mu_c = torch.zeros((B, self.m + 1), dtype=signed.dtype,
                           device=lam.device).scatter_add(1, at_c, signed)
        mu_b = torch.zeros((B, n + 1), dtype=signed.dtype,
                           device=lam.device).scatter_add(1, at_b, signed)
        return mu_c[:, :self.m], mu_b[:, :n]

    def rows(self, C):
        """N^T as a (B, n, n) tensor in C's dtype: row k is slot k's
        normal."""
        B, n = self.idxs.shape
        if self.m > 0:
            cidx = self.idxs.clamp(0, self.m - 1)
            Crows = C.gather(1, cidx[:, :, None].expand(-1, -1, n))
        else:
            Crows = torch.zeros((B, n, n), dtype=C.dtype, device=C.device)
        e_b = torch.nn.functional.one_hot(
            (self.idxs - self.m).clamp(0, n - 1), n).to(C.dtype)
        return self.sgn64.to(C.dtype)[:, :, None] * torch.where(
            self.is_b[:, :, None], e_b, Crows)


class _DenseProducts:
    """The refinement's products on the dense G and C of the problem, those
    of every dense caller. It tracks x, lam and, in f64, y = G x, ntx =
    N^T x and w = N lam: computed once from f64 copies of G and C, then
    advanced by the f32 increments of each step through f32 copies of G
    and of the active normals (the JAX ``_refine_batch``, fast.py:397-548);
    with ``exact`` computed anew in f64 after every step instead (its
    ``_refine``, fast.py:569-617). The correction's G N*^T r2 is an f32
    product either way."""

    def __init__(self, pbs: QPProblem, slots: _Slots, exact: bool = False):
        f32, f64 = torch.float32, torch.float64
        self.sl, self.exact, self.C = slots, exact, pbs.C
        self.G64, self.C64 = pbs.G.to(f64), pbs.C.to(f64)
        self.G32 = pbs.G.to(f32)

    def start(self, x32, lam32):
        """Track from the loop's x and multipliers; the residuals (r1, r2)
        in f32."""
        self.x, self.lam = x32.to(torch.float64), lam32.to(torch.float64)
        self._products()
        return self._residuals()

    def correction(self, nstr2, dx, r1):
        """G N*^T r2 - r1 in f32, the vector N* takes for dlam."""
        return _bmv(self.G32, nstr2) - r1

    def advance(self, dx, dlam):
        """x += dx, lam += dlam at the active slots; the next residuals."""
        f64 = torch.float64
        self.x = self.x + dx.to(f64)
        self.lam = torch.where(self.sl.valid, self.lam + dlam.to(f64), 0.0)
        if self.exact:
            self._products()
        else:
            self.y = self.y + _bmv(self.G32, dx).to(f64)
            self.ntx = self.ntx + _bmv(self._nt32, dx).to(f64)
            self.w = self.w + _bmtv(self._nt32, dlam).to(f64)
        return self._residuals()

    def _products(self):
        mu_c, mu_b = self.sl.split(self.lam)
        self.y = _bmv(self.G64, self.x)
        self.ntx = self.sl.t(_bmv(self.C64, self.x), self.x)
        self.w = _bmtv(self.C64, mu_c) + mu_b

    def _residuals(self):
        """(r1, r2) at the tracked x and lam, also kept as ``residuals``."""
        r1 = self.w - self.y - self.sl.a64                   # stationarity
        r2 = torch.where(self.sl.valid, self.sl.b - self.ntx, 0.0)
        self.residuals = (r1.to(torch.float32),              # active feas.
                          r2.to(torch.float32))
        return self.residuals

    @functools.cached_property
    def _nt32(self):
        return self.sl.rows(self.C.to(torch.float32))


def _refine(pbs: QPProblem, st: FastState, ir_steps: int,
            products) -> GIResult:
    """Batched mixed-precision iterative refinement in native f64.

    ``ir_steps`` steps of the residuals r1 = N lam - G x - a and r2 = b -
    N^T x in f64, then the correction through the loop's f32 operators:

        dx = H r1 + N*^T r2,   dlam = N* (G N*^T r2 - r1)

    ``products(slots)`` keeps x, lam and the products G x, N^T x and N lam
    (``start``, ``correction``, ``advance``, then its ``x``, ``lam`` and
    ``y``): :class:`_DenseProducts` on the dense G and C, or the structured
    entry points' operator on G's blocks and C's rows.

    Slot validity is ``aorder >= 0``: the fused kernel frees a slot by
    zeroing it, so active slots may have holes."""
    B, n = pbs.a.shape
    m = pbs.C.shape[1]
    f64, f32 = torch.float64, torch.float32
    valid = st.aorder >= 0                                   # (B, n)
    idxs = torch.where(valid, st.aorder, 0).long()           # (B, n)
    stat = torch.where(valid, st.status.long().gather(1, idxs), 0)
    upperish = (stat == UPPER) | (stat == UPPER_BOUND)
    sgn64 = torch.where(upperish, -1.0, 1.0).to(f64) * valid

    # per-slot signed bounds: general rows use l/u, bound rows xl/xu
    def clamp(v):
        return torch.nan_to_num(v, posinf=1e30, neginf=-1e30).clamp(-1e30,
                                                                     1e30)

    lo_all = clamp(torch.cat([pbs.l, pbs.xl], dim=1).to(f64))
    up_all = clamp(torch.cat([pbs.u, pbs.xu], dim=1).to(f64))
    b_sel = torch.where(upperish, up_all.gather(1, idxs),
                        lo_all.gather(1, idxs))
    b = sgn64 * b_sel * valid                                # (B, n) signed
    a64 = pbs.a.to(f64)
    ops = products(_Slots(valid, idxs, sgn64, stat >= LOWER_BOUND, b, a64,
                          m))

    H32, Ns32 = st.H, st.Ns
    lam32 = torch.where(valid, st.u[:, :n], 0.0).to(f32)
    r1, r2 = ops.start(st.x, lam32)
    for _ in range(ir_steps):
        nstr2 = _bmtv(Ns32, r2)                              # N*^T r2
        dx = _bmv(H32, r1) + nstr2
        dlam = _bmv(Ns32, ops.correction(nstr2, dx, r1))
        r1, r2 = ops.advance(dx, dlam)
    x, lam, y = ops.x, ops.lam, ops.y

    # multipliers in the external sign convention (UPPER-active positive)
    sign_out = torch.where(upperish, 1.0, -1.0).to(f64)
    vals = torch.where(valid, sign_out * lam, 0.0)
    multipliers = torch.zeros((B, m + n), dtype=f64,
                              device=x.device).scatter_add(1, idxs, vals)
    f = 0.5 * (x * y).sum(dim=1) + (a64 * x).sum(dim=1)
    return GIResult(x=x, multipliers=multipliers, f=f, iterations=st.it,
                    status=st.term, active_set=st.status)


def _outer(a, b):
    return a[:, :, None] * b[:, None, :]


# Relative threshold on delta = n+^T H n+ for declaring the candidate
# dependent on the active set, times hscale |n+|^2 (fast.py:96-108).
def _dep_eps(dtype):
    return 2e-12 if dtype == torch.float64 else 2e-7


def _apply_add(state: FastState, nplus, z, r, idx, st) -> FastState:
    """Rank-one add update in compact slots (fast.py:111-130): slot q
    takes the constraint ``idx`` with status ``st``."""
    B, n = state.x.shape
    k = torch.arange(n, device=z.device)[None, :]
    q = state.q.long()
    delta = _dot(nplus, z)
    hscale = torch.clamp_min(state.hscale, 1e-30)
    dependent = delta <= _dep_eps(z.dtype) * hscale * _dot(nplus, nplus)
    dsafe = torch.where(dependent, 1.0, delta)
    zn = z / dsafe[:, None]
    at_q = k == q.clamp(0, n - 1)[:, None]
    Ns = state.Ns - _outer(torch.where(k < q[:, None], r, 0.0), zn)
    return dataclasses.replace(
        state, H=state.H - _outer(z, zn),
        Ns=torch.where(at_q[:, :, None], zn[:, None, :], Ns),
        status=state.status.scatter(1, idx.long()[:, None],
                                    st.to(torch.int32)[:, None]),
        aorder=torch.where(at_q, idx.to(torch.int32)[:, None],
                           state.aorder),
        q=(q + 1).to(torch.int32),
        term=torch.where(dependent, LINEAR_DEPENDENCY_DETECTED,
                         state.term).to(torch.int32))


def _apply_remove(pb: QPProblem, state: FastState, l, u_new) -> FastState:
    """Rank-one remove update of slot ``l``, then the rows after it shift
    up (fast.py:133-164)."""
    B, n = state.x.shape
    dev = state.x.device
    k = torch.arange(n, device=dev)[None, :]
    kq = torch.arange(n + 1, device=dev)[None, :]
    q_old = state.q.long()[:, None]
    q_new = q_old - 1
    l = l.long()[:, None]
    lc = l.clamp(0, n - 1)
    nl = state.Ns.gather(1, lc[:, :, None].expand(-1, 1, n))[:, 0]  # N* row
    w = _bmv(state.Ns, _bmv(pb.G, nl))   # w_j = (M^-1)_jl
    wl = w.gather(1, lc)
    wl_safe = torch.where(wl.abs() > 0, wl, 1.0)
    H = state.H + _outer(nl, nl / wl_safe)
    wmask = torch.where((k < q_old) & (k != l), w, 0.0)
    Ns = state.Ns - _outer(wmask / wl_safe, nl)
    # delete row l (shift rows l+1..q_old-1 up), zero the freed row
    src = torch.where((k >= l) & (k < q_new), k + 1, k).clamp(0, n - 1)
    Ns = Ns.gather(1, src[:, :, None].expand(-1, -1, n))
    Ns = torch.where((k >= q_new)[:, :, None], 0.0, Ns)
    rem_idx = state.aorder.long().gather(1, lc).clamp(
        0, state.status.shape[1] - 1)
    aorder = state.aorder.gather(1, src)
    aorder = torch.where(k == q_new.clamp(0, n - 1), -1, aorder)
    usrc = torch.where((kq >= l) & (kq < q_old), kq + 1, kq).clamp(0, n)
    u = u_new.gather(1, usrc)
    u = torch.where(kq == q_old.clamp(0, n), 0.0, u)
    return dataclasses.replace(
        state, H=H, Ns=Ns, status=state.status.scatter(1, rem_idx, 0),
        aorder=aorder.to(torch.int32), u=u,
        q=q_new[:, 0].to(torch.int32))


def _inverse_cholesky(A):
    """(L^-T L^-1 = A^-1, ok) per lane from ``torch.linalg.cholesky_ex``:
    ok is ``info == 0``, not a finite diagonal, since torch leaves a
    partial, finite factor on failure; a failed lane inverts I."""
    L, ok = _safe_cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(A)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.transpose(1, 2) @ Linv, ok


def _init_fast(pb: QPProblem, opt: SolverOptions) -> FastState:
    """Cold init: H = G^-1, x = -G^-1 a, then the equality/fixed replay
    (fast.py:249-262)."""
    H, posdef = _inverse_cholesky(pb.G)
    return _init_fast_from_ops(pb, H, -_bmv(H, pb.a), posdef, opt)


def _init_fast_from_ops(pb: QPProblem, H, x, posdef, opt: SolverOptions
                        ) -> FastState:
    """Cold init from given operators H = G^-1 and x = -G^-1 a
    (fast.py:265-328): equalities (l == u) and fixed variables (xl == xu)
    are activated in ascending index order by rank-one adds, until a lane
    stops RUNNING; more of them than n ends OVERCONSTRAINED_PROBLEM."""
    B, n = pb.a.shape
    m = pb.m
    mt = m + n
    dt, dev, i32 = pb.G.dtype, pb.G.device, torch.int32
    state = FastState(
        x=x, f=0.5 * _dot(pb.a, x), H=H,
        Ns=torch.zeros((B, n, n), dtype=dt, device=dev),
        status=torch.zeros((B, mt), dtype=i32, device=dev),
        aorder=torch.full((B, n), -1, dtype=i32, device=dev),
        u=torch.zeros((B, n + 1), dtype=dt, device=dev),
        q=torch.zeros((B,), dtype=i32, device=dev),
        it=torch.zeros((B,), dtype=i32, device=dev),
        term=torch.where(posdef, RUNNING, NON_POS_HESSIAN).to(i32),
        skip1=torch.zeros((B,), dtype=torch.bool, device=dev),
        sc_idx=torch.full((B,), -1, dtype=i32, device=dev),
        sc_status=torch.zeros((B,), dtype=i32, device=dev),
        hscale=torch.diagonal(H, dim1=1, dim2=2).sum(dim=1))

    eqmask = torch.cat([pb.l == pb.u, pb.xl == pb.xu], dim=1)
    ar = torch.arange(mt, device=dev)[None, :]
    perm = torch.argsort(torch.where(eqmask, ar, mt + ar), dim=1,
                         stable=True)
    neq = eqmask.sum(dim=1)
    kq = torch.arange(n + 1, device=dev)[None, :]
    kk = torch.zeros((B,), dtype=torch.long, device=dev)
    while True:
        active = (kk < neq) & (state.term == RUNNING)
        with spans.sync("replay"):
            go = bool(active.any())
        if not go:
            break
        idx = perm.gather(1, kk.clamp(0, mt - 1)[:, None])[:, 0]
        stc = torch.where(idx < m, EQUALITY, FIXED)
        nplus = _constraint_normal(pb, idx, stc)
        z = _bmv(state.H, nplus)
        r = _bmv(state.Ns, nplus)
        nz = _dot(nplus, z)
        nz_safe = torch.where(nz != 0, nz, 1.0)
        t = torch.where(_dot(z, z) > 0,
                        (_selected_bound(pb, idx, stc) - _dot(nplus, state.x))
                        / nz_safe, 0.0)
        q = state.q.long()[:, None]
        r_ext = torch.cat([torch.where(kq[:, :n] < q, r, 0.0),
                           torch.zeros_like(r[:, :1])], dim=1)
        u = state.u - t[:, None] * r_ext
        u = u + torch.where(kq == q.clamp(0, n), t[:, None], 0.0)
        st = dataclasses.replace(state, x=state.x + t[:, None] * z,
                                 f=state.f + t * nz * 0.5 * t, u=u)
        state = _where_state(active, _apply_add(st, nplus, z, r, idx, stc),
                             state)
        kk = torch.where(active, kk + 1, kk)
    term = torch.where((neq > n) & (state.term == RUNNING),
                       OVERCONSTRAINED_PROBLEM, state.term)
    return _validated(pb, dataclasses.replace(state, term=term.to(i32)), opt)


def _init_fast_warm(pb: QPProblem, as_hint, opt: SolverOptions
                    ) -> FastState:
    """Warm init of the explicit-operator engine from (B, m+n) activation
    hints (fast.py:778-848): the hinted set's normals N and signed bounds
    b_act, then

        M  = N^T G^-1 N  (identity beyond q), by one Cholesky
        N* = M^-1 N^T G^-1,     H = G^-1 - (G^-1 N) N*
        u  = M^-1 b + N* a,     x = N*^T b - H a

    and the one-at-a-time deactivation of wrongly hinted constraints with
    u < 0. A lane whose M has no Cholesky factor (a rank-deficient hinted
    set) falls back to the cold init. hscale is trace(G^-1)."""
    from .warm_start import (
        _active_normals_and_bounds,
        _process_initial_active_set,
    )

    B, n = pb.a.shape
    dev = pb.G.device
    status, aorder, q, over = _process_initial_active_set(pb, as_hint, opt)
    N, b_act = _active_normals_and_bounds(pb, status, aorder, q)
    k = torch.arange(n, device=dev)
    ql = q.long()[:, None]
    Ginv, posdef = _inverse_cholesky(pb.G)
    W = Ginv @ N                                  # cols 0..q-1 = G^-1 n_k
    M = N.transpose(1, 2) @ W
    pad = (k[None, :, None] >= ql[:, :, None]) | (k[None, None, :]
                                                   >= ql[:, :, None])
    eye = torch.eye(n, dtype=M.dtype, device=dev)
    Minv, indep = _inverse_cholesky(torch.where(pad, eye, M))
    Ns = Minv @ W.transpose(1, 2)
    Ns = torch.where((k[None, :] >= ql)[:, :, None], 0.0, Ns)
    H = Ginv - W @ Ns
    u_head = _bmv(Minv, b_act) + _bmv(Ns, pb.a)
    u_head = torch.where(k[None, :] < ql, u_head, 0.0)
    x = _bmtv(Ns, b_act) - _bmv(H, pb.a)
    i32 = torch.int32
    zeros = torch.zeros((B,), dtype=i32, device=dev)
    state = FastState(
        x=x, f=0.5 * _dot(x, _bmv(pb.G, x)) + _dot(pb.a, x), H=H, Ns=Ns,
        status=status, aorder=aorder,
        u=torch.cat([u_head, torch.zeros_like(u_head[:, :1])], dim=1),
        q=q, it=zeros,
        term=torch.where(over, OVERCONSTRAINED_PROBLEM,
                         torch.where(posdef, RUNNING, NON_POS_HESSIAN)
                         ).to(i32),
        skip1=torch.zeros((B,), dtype=torch.bool, device=dev),
        sc_idx=zeros - 1, sc_status=zeros,
        hscale=torch.diagonal(Ginv, dim1=1, dim2=2).sum(dim=1))
    with spans.sync("warm_indep"):
        all_indep = bool(indep.all())
    if not all_indep:
        state = _where_state(indep, state, _init_fast(pb, opt))
    utol = -1e-14 if pb.G.dtype == torch.float64 else -1e-5
    return _deactivate_negative_u(pb, _validated(pb, state, opt), b_act,
                                  utol)


# The carry init drops every slot whose multiplier is negative, as K4 does
# for the dense carry: a multiplier kept in [-1e-5, 0), the hint init's
# band in f32, ends with the wrong sign after the f64 refinement, a
# complementarity residual that no refinement step removes. A dropped
# constraint that the answer needs is violated at the init's x, and the
# loop adds it back with a multiplier >= 0.
_CARRY_UTOL = 0.0


def _deactivate_negative_u(pb: QPProblem, state: FastState, b_act, utol
                           ) -> FastState:
    """Deactivate constraints with u < ``utol`` one at a time, the most
    negative first (lowest slot on ties), while the lane is RUNNING
    (fast.py:851-895): a remove update, then the closed form on the
    reduced set, each counted as an iteration. ``b_act`` are the signed
    bounds of the slots."""
    B, n = pb.a.shape
    m = pb.m
    k = torch.arange(n, device=pb.G.device)[None, :]
    b = b_act
    while True:
        q = state.q.long()[:, None]
        valid = k < q
        idxs = torch.where(valid, state.aorder.long(), 0)
        sts = state.status.long().gather(1, idxs.clamp(0, m + n - 1))
        elig = valid & (sts != EQUALITY) & (sts != FIXED)
        vals = torch.where(elig, state.u[:, :n], 0.0)
        lmin = vals.argmin(dim=1)
        umin = vals.gather(1, lmin[:, None])[:, 0]
        active = (state.term == RUNNING) & (umin < utol)
        with spans.sync("deactivate"):
            go = bool(active.any())
        if not go:
            return state
        st2 = _apply_remove(pb, state, lmin, state.u)
        q2 = st2.q.long()[:, None]
        src = torch.where((k >= lmin[:, None]) & (k < q2), k + 1, k)
        b2 = torch.where(k >= q2, 0.0, b.gather(1, src.clamp(0, n - 1)))
        # closed form on the reduced set (M^-1 = N* G N*^T)
        nb = _bmtv(st2.Ns, b2)
        x2 = nb - _bmv(st2.H, pb.a)
        u2 = torch.where(k < q2, _bmv(st2.Ns, pb.a + _bmv(pb.G, nb)), 0.0)
        st2 = dataclasses.replace(
            st2, x=x2, f=0.5 * _dot(x2, _bmv(pb.G, x2)) + _dot(pb.a, x2),
            u=torch.cat([u2, torch.zeros_like(u2[:, :1])], dim=1),
            it=state.it + 1)
        state = _where_state(active, st2, state)
        b = torch.where(active[:, None], b2, b)


def _init_fast_from_carry(pb: QPProblem, H, Ns, status, aorder, q
                          ) -> FastState:
    """Warm init from a previous solve's operators (fast.py:971-1009), for
    a batch that shares that solve's G and C. The carried slots are
    compacted first (a stable sort, holes last), then the closed form for
    the new a and bounds through the carried operators

        x = N*^T b_act - H a,   u = N* (G x + a)   (active slots)

    with hscale = trace(H), and the one-at-a-time deactivation of slots
    with u < 0: every negative multiplier, where the JAX init keeps those
    in [-1e-5, 0) (``_CARRY_UTOL``). The plain version of K12
    (``ops/cuda/carry_init.py``), which runs it on a card in one launch."""
    from .warm_start import _active_normals_and_bounds

    B, n = pb.a.shape
    dev = pb.G.device
    k = torch.arange(n, device=dev)[None, :]
    order = torch.argsort(torch.where(aorder >= 0, k, n + k), dim=1,
                          stable=True)
    aorder = aorder.gather(1, order)
    Ns = Ns.gather(1, order[:, :, None].expand(-1, -1, n))
    _, b_act = _active_normals_and_bounds(pb, status, aorder, q)
    x = _bmtv(Ns, b_act) - _bmv(H, pb.a)
    u = torch.where(k < q.long()[:, None],
                    _bmv(Ns, pb.a + _bmv(pb.G, x)), 0.0)
    i32 = torch.int32
    zeros = torch.zeros((B,), dtype=i32, device=dev)
    state = FastState(
        x=x, f=0.5 * _dot(x, _bmv(pb.G, x)) + _dot(pb.a, x), H=H, Ns=Ns,
        status=status, aorder=aorder,
        u=torch.cat([u, torch.zeros_like(u[:, :1])], dim=1),
        q=q, it=zeros, term=zeros + RUNNING,
        skip1=torch.zeros((B,), dtype=torch.bool, device=dev),
        sc_idx=zeros - 1, sc_status=zeros,
        hscale=torch.diagonal(H, dim1=1, dim2=2).sum(dim=1))
    return _deactivate_negative_u(pb, state, b_act, _CARRY_UTOL)


def fast_iteration(pb: QPProblem, state: FastState, opt: SolverOptions
                   ) -> FastState:
    """One explicit-form GI pass on every RUNNING lane (fast.py:167-246);
    other lanes are returned unchanged. Select the most violated
    constraint (not after a partial step, which keeps its candidate), take
    the step, then add the candidate (full step) or remove the blocking
    slot (partial step). A lane with nothing violated ends SUCCESS, one
    without a step INFEASIBLE."""
    B, n = state.x.shape
    m = pb.m
    dt, dev = state.x.dtype, state.x.device
    big = torch.tensor(opt.big_bnd, dtype=dt, device=dev)
    k = torch.arange(n, device=dev)[None, :]
    kq = torch.arange(n + 1, device=dev)[None, :]
    q = state.q.long()[:, None]
    at_q = kq == q.clamp(0, n)

    sel_idx, sel_st, viol = _select_violated(pb, state.x, state.status)
    do_select = ~state.skip1
    success = do_select & (viol >= 0)
    sc_idx = torch.where(do_select, sel_idx, state.sc_idx)
    sc_st = torch.where(do_select, sel_st, state.sc_status)
    u0 = torch.where(do_select[:, None] & at_q, 0.0, state.u)

    nplus = _constraint_normal(pb, sc_idx, sc_st)
    z = _bmv(state.H, nplus)
    r = _bmv(state.Ns, nplus)            # rows >= q of N* are zero

    # step lengths: t1 over the removable active slots, t2 the full step
    valid = k < q
    idxs = torch.where(valid, state.aorder.long(), 0)
    stat_k = state.status.long().gather(1, idxs.clamp(0, m + n - 1))
    eligible = (valid & (stat_k != EQUALITY) & (stat_k != FIXED) & (r > 0))
    tks = torch.where(eligible, u0[:, :n] / torch.where(eligible, r, 1.0),
                      big)
    l = tks.argmin(dim=1)
    t1 = torch.minimum(tks.gather(1, l[:, None])[:, 0], big)
    nz = _dot(nplus, z)
    sign = torch.where((sc_st == UPPER) | (sc_st == UPPER_BOUND), -1.0,
                       1.0).to(dt)
    b = _selected_bound(pb, sc_idx, sc_st)
    # scale-aware zero-z test, relative to the init-time hscale
    zthr = opt.zero_z_threshold * (state.hscale.clamp_min(1e-30) / n)
    t2 = torch.where(_dot(z, z) > zthr * zthr * _dot(nplus, nplus),
                     (sign * b - _dot(nplus, state.x))
                     / torch.where(nz != 0, nz, 1.0), big)
    t = torch.minimum(t1, t2)
    infeasible = t >= big
    dual_step = (t2 >= big) & ~infeasible
    full_step = ~infeasible & ~dual_step & (t2 <= t1)

    uq = u0.gather(1, q.clamp(0, n))[:, 0]
    r_ext = torch.cat([torch.where(valid, r, 0.0),
                       torch.zeros_like(r[:, :1])], dim=1)
    u_stepped = (u0 - t[:, None] * r_ext
                 + torch.where(at_q, t[:, None], 0.0))
    primal = ~infeasible & ~dual_step
    st2 = dataclasses.replace(
        state, sc_idx=sc_idx, sc_status=sc_st, u=u_stepped,
        x=torch.where(primal[:, None], state.x + t[:, None] * z, state.x),
        f=torch.where(primal, state.f + t * nz * (0.5 * t + uq), state.f))

    def stepped(st):
        return dataclasses.replace(st, it=state.it + 1,
                                   skip1=~full_step & ~infeasible)

    running = state.term == RUNNING
    go = running & ~(success | infeasible)
    # a lane that stops keeps its state, with the new term and candidate
    held = dataclasses.replace(
        state,
        term=torch.where(running & success, SUCCESS, torch.where(
            running & infeasible, INFEASIBLE, state.term)).to(torch.int32),
        sc_idx=torch.where(running, sc_idx, state.sc_idx),
        sc_status=torch.where(running, sc_st, state.sc_status))
    added = stepped(_apply_add(st2, nplus, z, r, sc_idx, sc_st))
    removed = stepped(_apply_remove(pb, st2, l, u_stepped))
    return _where_state(go & full_step, added,
                        _where_state(go & ~full_step, removed, held))


def fast_loop_plain(pb: QPProblem, state: FastState, opt: SolverOptions,
                    on_pass=None) -> FastState:
    """:func:`fast_iteration` until no lane is RUNNING: the XLA engine's
    while loop (fast.py:342-351) over the batch, one masked pass per
    iteration and a host sync after each. A lane that reaches
    ``opt.max_iter`` while RUNNING ends MAX_ITER_REACHED there, so it
    stops where its own loop would. Without a hook it is the plain PyTorch
    version of K11 (``ops/cuda/fast_loop.py``); ``on_pass(before, after)``,
    if given, sees every pass (the tracer records with it)."""
    while True:
        capped = (state.term == RUNNING) & (state.it >= opt.max_iter)
        state = dataclasses.replace(state, term=torch.where(
            capped, MAX_ITER_REACHED, state.term).to(torch.int32))
        with spans.sync("pass"):
            go = bool((state.term == RUNNING).any())
        if not go:
            return state
        nxt = fast_iteration(pb, state, opt)
        if on_pass is not None:
            on_pass(state, nxt)
        state = nxt


def _run_loop(pb: QPProblem, state: FastState, opt: SolverOptions,
              on_pass=None) -> FastState:
    """Run the explicit-form GI loop from ``state`` until no lane is
    RUNNING (fast.py:342-351). Without a hook it is one launch of K11 on a
    CUDA state (``ops/cuda/fast_loop.fast_loop``), each lane's iterations
    back to back, and :func:`fast_loop_plain` on a CPU one; ``on_pass``
    (the tracer) runs :func:`fast_loop_plain` with it. In a span
    ``jrlqp.loop``."""
    with spans.span("jrlqp.loop", state.x):
        if on_pass is None:
            # imported here: fast_loop imports this module
            from ..ops.cuda.fast_loop import fast_loop

            return fast_loop(pb, state, opt)
        return fast_loop_plain(pb, state, opt, on_pass)


def _run_fast(pb: QPProblem, opt: SolverOptions) -> FastState:
    with spans.span("jrlqp.init", pb.G):
        state0 = _init_fast(pb, opt)
    return _run_loop(pb, state0, opt)


def solve_fast(pbs: QPProblem, opt: SolverOptions = SolverOptions()
               ) -> GIResult:
    """Explicit-form GI solve of a batch in the problems' dtype (counterpart
    of ``vmap(solve_fast)``, fast.py:365-370): the torch cold init, then
    the loop (:func:`_run_loop`: one K11 launch on a card), no
    refinement."""
    return finalize(pbs, _run_fast(pbs, opt))


def solve_fast_warm(pbs: QPProblem, as_hints,
                    opt: SolverOptions = SolverOptions()) -> GIResult:
    """Warm-started explicit-form solve from (B, m+n) activation hints in
    the problems' dtype (counterpart of ``vmap(solve_fast_warm)``,
    fast.py:898-915). Hints count only with ``opt.warm_start``."""
    with spans.span("jrlqp.init", pbs.G):
        state0 = _init_fast_warm(pbs, as_hints, opt)
    return finalize(pbs, _run_loop(pbs, state0, opt))


def solve_refined(pbs: QPProblem, opt: SolverOptions = SolverOptions(),
                  ir_steps: int = 3) -> GIResult:
    """The dense engine, batched: the f32 cold init (Cholesky of G), the
    f32 explicit-form loop (:func:`_run_loop`: one K11 launch on a card),
    then ``ir_steps`` steps of f64 refinement (counterpart of
    ``vmap(jrlqp_tpu.solver.fast.solve_refined)``, fast.py:620-635)."""
    with spans.call("solve_refined", pbs.G):
        with spans.span("jrlqp.prepare"):
            pb32 = pbs.with_dtype(torch.float32)
        opt32 = opt.with_(dtype=torch.float32, zero_z_threshold=1e-6)
        return _refine_batch(pbs, _run_fast(pb32, opt32), ir_steps,
                             functools.partial(_DenseProducts, pbs,
                                               exact=True))


def solve_refined_kernel(pbs: QPProblem, opt: SolverOptions = SolverOptions(),
                         ir_steps: int = 3, fused_init: bool = True
                         ) -> GIResult:
    """Batched f32 GI in a kernel, then ``ir_steps`` steps of f64
    refinement (counterpart of ``solve_refined_pallas(pbs, opt, ir_steps,
    fused_init=fused_init)``).

    ``fused_init=True`` (the main path) runs the whole solve, cold init
    included, in the fused kernel K1; ``False`` (the JAX package's default)
    runs the cold init in torch (``_init_fast``) and the loop in K3. Runs
    on the problem's device: a CUDA batch goes through the CUDA kernel, a
    CPU batch through its plain PyTorch version. With ``opt.validate``
    lanes with inconsistent data end INCONSISTENT_INPUT on both branches.
    """
    with spans.call("solve_refined_kernel", pbs.G):
        if not fused_init:
            return _solve_refined_from_init(pbs, opt, ir_steps, run_loop)
        return _solve_refined(pbs, opt, ir_steps, run_loop_fused)


def _solve_refined(pbs: QPProblem, opt: SolverOptions, ir_steps: int,
                   run_loop) -> GIResult:
    """:func:`solve_refined_kernel` with the f32 loop ``run_loop(pb32,
    max_iter)`` given: the kernel's wrapper, or its plain version for a
    comparison on the card."""
    with spans.span("jrlqp.prepare", pbs.G):
        pb32 = pbs.with_dtype(torch.float32)
    out = run_loop(pb32, opt.max_iter)
    with spans.span("jrlqp.remap", pbs.G):
        st = _validated(pb32, _state_from_kernel_out(out, pbs.batch), opt)
    return _refine_batch(pbs, st, ir_steps)


def _solve_refined_from_init(pbs: QPProblem, opt: SolverOptions,
                             ir_steps: int, run) -> GIResult:
    """The f32 cold init in torch (``_init_fast``, which applies
    ``opt.validate``), the loop ``run(pb32, state0, max_iter)`` -- K3's or
    K9's wrapper, or a plain version -- then ``ir_steps`` steps of f64
    refinement: the body of ``solve_refined_pallas(..., fused_init=False)``
    (fast.py:638-671)."""
    with spans.span("jrlqp.prepare", pbs.G):
        pb32 = pbs.with_dtype(torch.float32)
    opt32 = opt.with_(dtype=torch.float32, zero_z_threshold=1e-6)
    with spans.span("jrlqp.init", pbs.G):
        state0 = _init_fast(pb32, opt32)
    out = run(pb32, state0, opt.max_iter)
    with spans.span("jrlqp.remap", pbs.G):
        st = _state_from_kernel_out(out, pbs.batch)
    return _refine_batch(pbs, st, ir_steps)


def solve_refined_kernel_compact(pbs: QPProblem,
                                 opt: SolverOptions = SolverOptions(),
                                 ir_steps: int = 3) -> GIResult:
    """Batched f32 GI with compact slots: the torch cold init, the loop in
    the kernel K9, then ``ir_steps`` steps of f64 refinement (counterpart
    of ``solve_refined_pallas(pbs, opt, ir_steps, pack=1)``, whose fused
    init falls back to the XLA init at pack 1, fast.py:725-734). A CPU
    batch runs K9's plain version."""
    with spans.call("solve_refined_kernel_compact", pbs.G):
        return _solve_refined_from_init(pbs, opt, ir_steps, run_loop_compact)


def _lanes(st: FastState, idx: torch.Tensor) -> FastState:
    """The lanes ``idx`` of a batched state."""
    return FastState(**{f.name: getattr(st, f.name)[idx]
                        for f in dataclasses.fields(FastState)})


def solve_refined_kernel_compacted(pbs: QPProblem,
                                   opt: SolverOptions = SolverOptions(),
                                   ir_steps: int = 3,
                                   phase1_frac: float = 0.45) -> GIResult:
    """Two-phase kernel solve with mid-solve compaction (counterpart of
    ``solve_refined_pallas_compacted``, fast.py:1119-1168).

    Phase 1 is the torch cold init and the loop in K3 up to the cap
    ``max(1, min(int(max_iter * phase1_frac), max_iter))``. The lanes that
    end it MAX_ITER_REACHED are gathered with their whole kernel state
    (K = [H | N*^T], x, u, status, aorder, q, the pending candidate skip1 /
    sc_idx / sc_status and the init-time hscale), and phase 2 runs K3
    again on those lanes alone, RUNNING, with the full budget; they are
    scattered back and the batch is refined ``ir_steps`` times. K3
    rebuilds a pending candidate's normal at entry, so every lane ends as
    in one launch of ``solve_refined_kernel(..., fused_init=False)``: the
    same status and iterations. The sub-batch is exactly the unfinished
    lanes: the JAX package's power-of-two padding only bounds its
    compiles. A CUDA batch runs K3, a CPU batch its plain version."""
    with spans.call("solve_refined_kernel_compacted", pbs.G):
        return _solve_compacted(pbs, opt, ir_steps, phase1_frac)


def _solve_compacted(pbs: QPProblem, opt: SolverOptions, ir_steps: int,
                     phase1_frac: float) -> GIResult:
    phase1 = max(1, min(int(opt.max_iter * phase1_frac), opt.max_iter))
    with spans.span("jrlqp.prepare", pbs.G):
        pb32 = pbs.with_dtype(torch.float32)
    opt32 = opt.with_(dtype=torch.float32, zero_z_threshold=1e-6)
    with spans.span("jrlqp.init", pbs.G):
        state0 = _init_fast(pb32, opt32)
    out = run_loop(pb32, state0, phase1)
    with spans.span("jrlqp.remap", pbs.G):
        st = _state_from_kernel_out(out, pbs.batch)
    with spans.sync("compact"):
        idx = torch.nonzero(st.term == MAX_ITER_REACHED)[:, 0]
    if phase1 < opt.max_iter and idx.numel():
        with spans.span("jrlqp.prepare", pbs.G):
            sub = _lanes(st, idx)
            sub = dataclasses.replace(sub, term=torch.full_like(sub.term,
                                                                RUNNING))
            pb_sub = pb32._map(lambda t: t[idx])
        out = run_loop(pb_sub, sub, opt.max_iter)
        with spans.span("jrlqp.remap", pbs.G):
            fin = _state_from_kernel_out(out, idx.numel())
            merged = {}
            for f in dataclasses.fields(FastState):
                full = getattr(st, f.name).clone()
                full[idx] = getattr(fin, f.name)
                merged[f.name] = full
            st = FastState(**merged)
    return _refine_batch(pbs, st, ir_steps)


def _batch_kkt(pbs: QPProblem, x, multipliers) -> torch.Tensor:
    """(B,) KKT residuals (fast.py:1171-1175)."""
    return kkt_residual(x, multipliers, pbs)


def _rescue_subbatch(pbs: QPProblem, opt: SolverOptions) -> GIResult:
    """The f64 J/R solve of a sub-batch (fast.py:1082-1087)."""
    from .dense import solve_batch

    return solve_batch(pbs.with_dtype(torch.float64), opt)


def solve_refined_kernel_rescued(pbs: QPProblem,
                                 opt: SolverOptions = SolverOptions(),
                                 ir_steps: int = 3, kkt_tol: float = 1e-8
                                 ) -> GIResult:
    """The f32 kernel path plus the f64 rescue of failed lanes (counterpart
    of ``solve_refined_pallas_rescued``, fast.py:1178-1224). The first
    stage is the JAX default's: the torch cold init, the loop in K3, the
    refinement. Lanes with a status other than SUCCESS or a KKT residual
    above ``kkt_tol`` are then solved again in f64 by the J/R engine
    (:func:`jrlqp_tpu_torch.solver.dense.solve_batch`) and scattered back,
    their iterations added to the first stage's. Exactly the failed lanes
    are gathered: the JAX package's power-of-two bucket only bounds its
    compiles, and no lane's result depends on it. A batch with no failed
    lane comes back as the first stage left it."""
    with spans.call("solve_refined_kernel_rescued", pbs.G):
        return _solve_rescued(pbs, opt, ir_steps, kkt_tol)


def _solve_rescued(pbs: QPProblem, opt: SolverOptions, ir_steps: int,
                   kkt_tol: float) -> GIResult:
    res = _solve_refined_from_init(pbs, opt, ir_steps, run_loop)
    resid = _batch_kkt(pbs, res.x, res.multipliers)
    with spans.sync("rescue"):
        bad = torch.nonzero((resid > kkt_tol) | (res.status != SUCCESS))[:, 0]
    if bad.numel() == 0:
        return res
    sub = _rescue_subbatch(pbs._map(lambda t: t[bad]), opt)

    def upd(full, part):
        out = full.clone()
        out[bad] = part.to(full.dtype)
        return out

    return GIResult(
        x=upd(res.x, sub.x), multipliers=upd(res.multipliers, sub.multipliers),
        f=upd(res.f, sub.f),
        iterations=upd(res.iterations, res.iterations[bad] + sub.iterations),
        status=upd(res.status, sub.status),
        active_set=upd(res.active_set, sub.active_set))


def solve_refined_warm_kernel(pbs: QPProblem, as_hints,
                              opt: SolverOptions = SolverOptions(),
                              ir_steps: int = 3) -> GIResult:
    """Batched warm-started solve from (B, m+n) activation hints, e.g. the
    previous control step's ``active_set`` (counterpart of
    ``solve_refined_warm_pallas``). Hints count only with
    ``opt.warm_start``. The f32 warm init runs here in torch, the loop in
    the kernel K3 (a CPU batch: its plain version), then ``ir_steps`` steps
    of f64 refinement."""
    with spans.call("solve_refined_warm_kernel", pbs.G):
        with spans.span("jrlqp.prepare"):
            pb32 = pbs.with_dtype(torch.float32)
        opt32 = opt.with_(dtype=torch.float32, zero_z_threshold=1e-6)
        with spans.span("jrlqp.init"):
            state0 = _init_fast_warm(pb32, as_hints, opt32)
        out = run_loop(pb32, state0, opt.max_iter)
        with spans.span("jrlqp.remap"):
            st = _state_from_kernel_out(out, pbs.batch)
        return _refine_batch(pbs, st, ir_steps)


@dataclasses.dataclass(frozen=True)
class WarmCarry:
    """Solver state carried between the solves of a control-loop
    trajectory (``jrlqp_tpu.solver.fast.WarmCarry``). When consecutive
    problems share G and C and only a and the bounds drift, the previous
    solve's operators are exactly the warm operators, so a warm step does
    no factorization at all. Slots may hold holes (aorder == -1).

    A carry that :func:`solve_refined_kernel_carry` returns also holds
    ``raw``: the kernels' own tensors in the layout K4 reads -- the padded
    f32 G and C^T of the trajectory's first step, which the carry's
    contract says do not change (590 MB at batch 16384, n = 50, m = 100;
    re-casting and re-padding them cost more than the kernel itself on an
    H100, PERF.md section 6), and the last kernel's K = [H | N*^T], status
    and aorder outputs -- so the next step pads only a and the bounds. H
    and Ns are then views of that K, and status and aorder its index remap,
    in the library's index space. A step from a carry with ``raw`` reads
    ``raw``, ``q``, ``first`` and ``reset`` and nothing else: ``H``,
    ``Ns``, ``status`` and ``aorder`` are then its read-only picture (of
    the step's end, before any reset). To
    step from edited or replaced fields, pass them with ``raw=None``
    (``dataclasses.replace(carry, status=..., raw=None)``): a carry of the
    five plain tensors alone is packed into the kernel's layout by its
    step and gives the same result."""

    H: torch.Tensor       # (B, n, n) f32 reduced inverse operator
    Ns: torch.Tensor      # (B, n, n) f32 N* row of each slot
    status: torch.Tensor  # (B, m+n) int32 ActivationStatus
    aorder: torch.Tensor  # (B, n) int32 constraint of each slot, -1 free
    q: torch.Tensor       # (B,) int32 active count
    # (G, Ct, K, status, aorder) in the kernels' padded layout, or None
    raw: tuple | None = dataclasses.field(default=None, repr=False,
                                          compare=False)
    # the cold step's K, status, aorder and q in the kernels' layout, and
    # (B,) int32 flags of the lanes that start the next step from it
    first: tuple | None = dataclasses.field(default=None, repr=False,
                                            compare=False)
    reset: torch.Tensor | None = dataclasses.field(default=None, repr=False,
                                                   compare=False)


# A lane whose refinement left a residual above this starts the next step
# from the cold step's state: see solve_refined_kernel_carry
RESET_TOL = 1e-10


def _spoiled(residuals) -> torch.Tensor:
    """(B,) int32 flags of the lanes whose refinement left a residual
    (r1 or r2, the largest entry) above RESET_TOL."""
    r1, r2 = (torch.linalg.vector_norm(r, float("inf"), dim=1)
              for r in residuals)
    return (torch.maximum(r1, r2) > RESET_TOL).to(torch.int32)


def solve_refined_kernel_carry(pbs: QPProblem, carry: WarmCarry | None = None,
                               opt: SolverOptions = SolverOptions(),
                               ir_steps: int = 3
                               ) -> tuple[GIResult, WarmCarry]:
    """Batched solve of one step of a trajectory of related QPs
    (counterpart of ``solve_refined_pallas_carry``); returns ``(result,
    carry)``. ``carry=None`` solves cold in K1; a carry from the previous
    step, whose G and C must be this step's, starts K4 from its operators:
    of the new problem it reads only a and the bounds when the carry holds
    the kernels' layout (see :class:`WarmCarry`). A CPU batch runs the
    kernels' plain versions. With ``opt.validate`` the cold step ends
    lanes with inconsistent data INCONSISTENT_INPUT (the warm step, like
    the JAX one, does not check).

    A warm step updates the carried f32 operators by rank-one steps and
    never forms them anew, so their rounding grows along the trajectory,
    and a step through an ill-conditioned active set (a nearly dependent
    vertex) can spoil a lane's at once; such lanes then miss, or answer
    less exactly, at their later steps, in ever more lanes. So each lane
    whose refinement left a residual above RESET_TOL starts the next step
    from the cold step's state (K4 reads it in place of its own), whose
    operators K1 formed. The JAX carry does not. At the 16,384 problems of
    n = 50, m = 100 of the benchmark cell ``dense50-track`` on an H100,
    the share of lanes that miss rose from 4e-4 to 1e-2 over 4,000 steps
    without the resets."""
    with spans.call("solve_refined_kernel_carry", pbs.G):
        if carry is None:
            with spans.span("jrlqp.prepare"):
                pb32 = pbs.with_dtype(torch.float32)
            out, raw = run_loop_fused_carry(pb32, opt.max_iter)
            with spans.span("jrlqp.remap"):
                st = _validated(pb32, _state_from_kernel_out(out, pbs.batch),
                                opt)
        else:
            with spans.span("jrlqp.prepare"):
                if carry.raw is None:
                    inputs, (n, m) = prepare_warm(
                        pbs.with_dtype(torch.float32), carry.H, carry.Ns,
                        carry.status, carry.aorder, carry.q)
                else:
                    inputs, (n, m) = prepare_warm_carry(
                        pbs, carry.raw, carry.q, carry.reset, carry.first)
            out, raw = warm_step(inputs, n, m, opt.max_iter)
            with spans.span("jrlqp.remap"):
                st = _state_from_kernel_out(out, pbs.batch)
        made = []

        def products(slots):
            made.append(_DenseProducts(pbs, slots))
            return made[-1]

        res = _refine_batch(pbs, st, ir_steps, products)
        with spans.span("jrlqp.refine", pbs.a):
            reset = _spoiled(made[0].residuals)
        first = (carry.first if carry is not None and carry.first is not None
                 else raw[2:] + (out["q"],))
        return (res, WarmCarry(H=out["H"], Ns=out["Ns"], status=out["status"],
                               aorder=out["aorder"], q=out["q"], raw=raw,
                               first=first, reset=reset))
