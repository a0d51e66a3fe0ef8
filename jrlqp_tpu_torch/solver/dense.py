"""Dense Goldfarb-Idnani dual active-set solver (the J/R engine), batched.

Counterpart of :mod:`jrlqp_tpu.solver.dense` (the reference's
DualSolver.cpp:91-168 with the dense hooks of GoldfarbIdnaniSolver.cpp:
56-338). The H100 runs f64 natively, so this is the port's ``solve`` and
``solve_batch`` and the f64 rescue of lanes the f32 kernels fail.

The loop (:func:`run_loop`), which the JAX package compiles into one
``lax.while_loop``, is one launch of the CUDA kernel K10 on a card
(``ops/cuda/jr_kernel.py``, ``csrc/jr_kernel.cu``): a thread block per
lane, its iterations back to back. Its plain version
(:func:`jr_loop_plain`) and the hooked loop of the structured solver and
the tracer run masked passes: :func:`gi_iteration` computes the selection
and the step for all lanes, the Householder add for all lanes and the
Givens removal over the rows where some lane removes, then selects per
lane, as ``vmap`` of the JAX function does, in a host loop while any lane
is RUNNING. A lane that reaches ``opt.max_iter`` ends MAX_ITER_REACHED
there.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.cuda.jr_kernel import jr_loop
from ..ops.linalg import (
    givens_remove,
    householder_add,
    shift_left,
    tri_solve_masked,
)
from ..problems import QPProblem
from ..types import (
    EQUALITY,
    FIXED,
    INACTIVE,
    INCONSISTENT_INPUT,
    INFEASIBLE,
    LINEAR_DEPENDENCY_DETECTED,
    LOWER,
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
from ..utils import spans
from ..validation import inconsistent_mask
from .state import GIResult, GIState, initial_state

__all__ = ["solve", "solve_batch", "init_state", "gi_iteration", "run_loop",
           "jr_loop_plain", "finalize"]


def _bmv(A, v):
    return torch.einsum("bij,bj->bi", A, v)


def _bmtv(A, v):
    """A^T v per lane."""
    return torch.einsum("bji,bj->bi", A, v)


def _dot(a, b):
    return (a * b).sum(dim=1)


def _on_card(t: torch.Tensor, name: str) -> bool:
    """True for a tensor on a card, where ``name``'s kernel runs; False for
    one on the CPU, where its plain version runs; raises for another
    device."""
    dev = t.device
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    return dev.type == "cuda"


def _where_state(mask, a, b):
    """Per lane: ``a`` where ``mask`` (B,), else ``b`` (same dataclass)."""
    def sel(x, y):
        return torch.where(mask.view(-1, *([1] * (x.dim() - 1))), x, y)

    return type(a)(**{f.name: sel(getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})


def _select_violated(pb: QPProblem, x, status, cx=None):
    """The most violated inactive constraint of each lane (dense.py:56-84):
    (index into [0, m+n), its ActivationStatus, the violation), which is
    negative iff a constraint is violated. ``argmin`` takes the first
    minimum: general constraints before bounds, ties to the lowest index,
    which is the reference's scan order. ``cx`` lets a structured caller
    supply C x computed blockwise."""
    m = pb.m
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    if cx is None:
        cx = _bmv(pb.C, x)
    sl, su = cx - pb.l, pb.u - cx
    cand_c = torch.where(status[:, :m] != INACTIVE, inf, torch.minimum(sl, su))
    st_c = torch.where(sl <= su, LOWER, UPPER)
    slb, sub = x - pb.xl, pb.xu - x
    cand_b = torch.where(status[:, m:] != INACTIVE, inf,
                         torch.minimum(slb, sub))
    st_b = torch.where(slb <= sub, LOWER_BOUND, UPPER_BOUND)
    cand = torch.cat([cand_c, cand_b], dim=1)
    p = cand.argmin(dim=1, keepdim=True)
    sts = torch.cat([st_c, st_b], dim=1).gather(1, p)
    return (p[:, 0].to(torch.int32), sts[:, 0].to(torch.int32),
            cand.gather(1, p)[:, 0])


def _constraint_normal(pb: QPProblem, idx, st):
    """Signed normals n+ = sign (e_{idx-m} | C[idx]) of constraints ``idx``
    with statuses ``st`` (dense.py:87-101); UPPER / UPPER_BOUND negate.
    ``idx`` and ``st`` are (B,) or (B, k); the result adds a last axis n."""
    m, n = pb.m, pb.n
    shape = idx.shape
    idx = idx.long().reshape(shape[0], -1)
    st = st.long().reshape(shape[0], -1)
    dt = pb.C.dtype
    sign = torch.where((st == UPPER) | (st == UPPER_BOUND), -1.0, 1.0).to(dt)
    if m > 0:
        crow = pb.C.gather(
            1, idx.clamp(0, m - 1)[:, :, None].expand(-1, -1, n))
    else:
        crow = torch.zeros(idx.shape + (n,), dtype=dt, device=idx.device)
    e = (torch.arange(n, device=idx.device)
         == (idx - m).clamp(0, n - 1)[:, :, None]).to(dt)
    out = sign[:, :, None] * torch.where((st >= LOWER_BOUND)[:, :, None], e,
                                         crow)
    return out.reshape(*shape, n)


def _selected_bound(pb: QPProblem, idx, st):
    """The unsigned bound b of constraints ``idx`` with statuses ``st``
    (dense.py:104-115); ``idx`` and ``st`` are (B,) or (B, k)."""
    m, n = pb.m, pb.n
    shape = idx.shape
    idx = idx.long().reshape(shape[0], -1)
    st = st.long().reshape(shape[0], -1)
    if m > 0:
        ci = idx.clamp(0, m - 1)
        b_gen = torch.where(st == UPPER, pb.u.gather(1, ci),
                            pb.l.gather(1, ci))
    else:
        b_gen = torch.zeros(idx.shape, dtype=pb.G.dtype, device=idx.device)
    bi = (idx - m).clamp(0, n - 1)
    b_bnd = torch.where(st == UPPER_BOUND, pb.xu.gather(1, bi),
                        pb.xl.gather(1, bi))
    return torch.where(st >= LOWER_BOUND, b_bnd, b_gen).reshape(shape)


def _compute_step(pb: QPProblem, J, R, q, idx, st):
    """Step 2a (dense.py:118-126): d = J^T n+, z = J2 d2, r = R^-1 d1."""
    n = pb.n
    nplus = _constraint_normal(pb, idx, st)
    d = _bmtv(J, nplus)
    k = torch.arange(n, device=d.device)[None, :]
    z = _bmv(J, torch.where(k >= q.long()[:, None], d, 0.0))
    return nplus, d, z, tri_solve_masked(R, d, q)


def _step_length(pb: QPProblem, state: GIState, opt: SolverOptions, nplus,
                 z, r, u):
    """Step 2b (dense.py:129-159): the blocking dual step t1 with the active
    position l achieving it, and the full primal step t2."""
    n = pb.n
    dev = z.device
    big = torch.tensor(opt.big_bnd, dtype=z.dtype, device=dev)
    k = torch.arange(n, device=dev)[None, :]
    valid = k < state.q.long()[:, None]
    idxs = torch.where(valid, state.aorder.long(), 0)
    stat_k = state.status.long().gather(
        1, idxs.clamp(0, state.status.shape[1] - 1))
    eligible = valid & (stat_k != EQUALITY) & (stat_k != FIXED) & (r > 0)
    tks = torch.where(eligible, u[:, :n] / torch.where(eligible, r, 1.0), big)
    l = tks.argmin(dim=1)
    t1 = torch.minimum(tks.gather(1, l[:, None])[:, 0], big)
    znorm = torch.linalg.vector_norm(z, dim=1)
    nz = _dot(nplus, z)
    nx = _dot(nplus, state.x)
    sign = torch.where((state.sc_status == UPPER)
                       | (state.sc_status == UPPER_BOUND), -1.0, 1.0).to(z.dtype)
    b = _selected_bound(pb, state.sc_idx, state.sc_status)
    nz_safe = torch.where(nz != 0, nz, 1.0)
    t2 = torch.where(znorm > opt.zero_z_threshold, (sign * b - nx) / nz_safe,
                     big)
    return t1, t2, l, nz


def _expand_multipliers(state, m: int) -> torch.Tensor:
    """Condensed, activation-ordered u -> the full signed external
    multipliers (dense.py:162-173): negative at lower and equality
    activations, positive at upper ones. Slots are compact (k < q)."""
    B, n = state.aorder.shape
    k = torch.arange(n, device=state.u.device)[None, :]
    valid = k < state.q.long()[:, None]
    idxs = torch.where(valid, state.aorder.long(), 0)
    stat_k = state.status.long().gather(1, idxs.clamp(0, m + n - 1))
    sign = torch.where((stat_k == UPPER) | (stat_k == UPPER_BOUND), 1.0, -1.0)
    vals = torch.where(valid, sign * state.u[:, :n], 0.0).to(state.u.dtype)
    return torch.zeros((B, m + n), dtype=state.u.dtype,
                       device=state.u.device).scatter_add(1, idxs, vals)


def _stepped_u(u, q, r, t):
    """u - t [r (slots < q); 0] with t added at slot q."""
    n = r.shape[1]
    kq = torch.arange(n + 1, device=u.device)[None, :]
    qq = q.long()[:, None]
    r_ext = torch.cat([torch.where(kq[:, :n] < qq, r, 0.0),
                       torch.zeros_like(r[:, :1])], dim=1)
    u = u - t[:, None] * r_ext
    return torch.where(kq == qq.clamp(0, n), u + t[:, None], u)


def _apply_add(state: GIState, d, idx, st) -> GIState:
    """Activate constraint (idx, st) at slot q and update (J, R) with a
    Householder reflector (dense.py:176-187)."""
    n = state.x.shape[1]
    J, R, dependent = householder_add(state.J, state.R, d, state.q)
    k = torch.arange(n, device=d.device)[None, :]
    return dataclasses.replace(
        state, J=J, R=R,
        status=state.status.scatter(1, idx.long()[:, None],
                                    st.to(torch.int32)[:, None]),
        aorder=torch.where(k == state.q.long()[:, None],
                           idx.to(torch.int32)[:, None], state.aorder),
        q=state.q + 1,
        term=torch.where(dependent, LINEAR_DEPENDENCY_DETECTED,
                         state.term).to(torch.int32))


def _apply_remove(state: GIState, l, u_new) -> GIState:
    """Deactivate active position l (dense.py:190-206); ``u_new`` is the
    stepped multiplier vector before the shift. A lane with l = n leaves
    (J, R) unrotated (the caller discards such lanes)."""
    B, n = state.x.shape
    q_old = state.q.long()
    J, R = givens_remove(state.J, state.R, q_old, l)
    rem_idx = state.aorder.long().gather(1, l.long().clamp(0, n - 1)[:, None])
    status = state.status.scatter(
        1, rem_idx.clamp(0, state.status.shape[1] - 1), INACTIVE)
    k = torch.arange(n, device=J.device)[None, :]
    aorder = shift_left(state.aorder, l, q_old - 1)
    aorder = torch.where(k == (q_old - 1).clamp(0, n - 1)[:, None], -1,
                         aorder)
    u = shift_left(u_new, l, q_old)
    kq = torch.arange(n + 1, device=J.device)[None, :]
    u = torch.where(kq == q_old.clamp(0, n)[:, None], 0.0, u)
    return dataclasses.replace(state, J=J, R=R, status=status,
                               aorder=aorder.to(torch.int32), u=u,
                               q=(q_old - 1).to(torch.int32))


def gi_iteration(pb: QPProblem, state: GIState, opt: SolverOptions,
                 select_fn=None, step_fn=None) -> GIState:
    """One pass of the GI dual iteration on every lane (dense.py:213-294):
    selection (unless a partial step is in progress), the step, then the
    full step (activate), the partial step (deactivate and keep the
    candidate) or the dual-only step (deactivate). SUCCESS and INFEASIBLE
    end a lane before any update; lanes that are not RUNNING pass through.

    ``select_fn(pb, x, status)`` and ``step_fn(pb, J, R, q, idx, st)``
    override the selection and step hooks; the structured solver passes
    block-sparse ones. The Givens sweep runs only for the lanes that
    remove."""
    n = pb.n
    big = opt.big_bnd
    select = select_fn or _select_violated
    step = step_fn or _compute_step
    kq = torch.arange(n + 1, device=state.x.device)[None, :]
    qc = state.q.long().clamp(0, n)[:, None]

    sel_idx, sel_st, viol = select(pb, state.x, state.status)
    do_select = ~state.skip1
    success = do_select & ~(viol < 0)
    sc_idx = torch.where(do_select, sel_idx, state.sc_idx)
    sc_st = torch.where(do_select, sel_st, state.sc_status)
    u = torch.where(do_select[:, None] & (kq == qc), 0.0, state.u)
    st1 = dataclasses.replace(state, u=u, sc_idx=sc_idx, sc_status=sc_st)

    nplus, d, z, r = step(pb, st1.J, st1.R, st1.q, sc_idx, sc_st)
    t1, t2, l, nz = _step_length(pb, st1, opt, nplus, z, r, u)
    t = torch.minimum(t1, t2)
    infeasible = t >= big
    dual_step = (t2 >= big) & ~infeasible
    full_step = ~infeasible & ~dual_step & (t2 <= t1)
    partial = ~infeasible & ~dual_step & ~full_step

    uq = u.gather(1, qc)[:, 0]
    u_stepped = _stepped_u(u, st1.q, r, t)
    primal = full_step | partial
    st2 = dataclasses.replace(
        st1, u=u_stepped,
        x=torch.where(primal[:, None], st1.x + t[:, None] * z, st1.x),
        f=torch.where(primal, st1.f + t * nz * (0.5 * t + uq), st1.f))

    running = state.term == RUNNING
    stop = success | infeasible
    removing = running & ~stop & (dual_step | partial)
    added = _apply_add(st2, d, sc_idx, sc_st)
    removed = _apply_remove(st2, torch.where(removing, l, n), u_stepped)
    nxt = _where_state(full_step, added,
                       _where_state(dual_step | partial, removed, st2))
    out = dataclasses.replace(nxt, it=state.it + 1,
                              skip1=dual_step | partial)
    stopped = dataclasses.replace(
        state, term=torch.where(success, SUCCESS, INFEASIBLE).to(torch.int32),
        sc_idx=sc_idx, sc_status=sc_st)
    out = _where_state(stop, stopped, out)
    return _where_state(running, out, state)


def _add_initial_constraint(pb: QPProblem, state: GIState, idx, st,
                            opt: SolverOptions, step_fn=None) -> GIState:
    """Replay of addInitialConstraint (dense.py:297-323): the full step
    onto an equality or fixed variable, then its activation."""
    qc = state.q.long().clamp(0, pb.n)[:, None]
    kq = torch.arange(pb.n + 1, device=state.x.device)[None, :]
    u = torch.where(kq == qc, 0.0, state.u)
    step = step_fn or _compute_step
    nplus, d, z, r = step(pb, state.J, state.R, state.q, idx, st)
    znorm = torch.linalg.vector_norm(z, dim=1)
    nz = _dot(nplus, z)
    nx = _dot(nplus, state.x)
    b = _selected_bound(pb, idx, st)      # EQUALITY -> l, FIXED -> xl
    nz_safe = torch.where(nz != 0, nz, 1.0)
    t = torch.where(znorm > opt.zero_z_threshold, (b - nx) / nz_safe, 0.0)
    uq = u.gather(1, qc)[:, 0]
    st2 = dataclasses.replace(
        state, x=state.x + t[:, None] * z, f=state.f + t * nz * (0.5 * t + uq),
        u=_stepped_u(u, state.q, r, t))
    return _apply_add(st2, d, idx, st)


def _replay_equalities(pb: QPProblem, state: GIState, opt: SolverOptions,
                       step_fn=None) -> GIState:
    """Auto-activation of equalities (l == u) and fixed variables
    (xl == xu) in ascending index order while a lane is RUNNING
    (dense.py:356-389); more of them than n ends OVERCONSTRAINED_PROBLEM.
    ``opt.validate`` ends lanes with inconsistent data INCONSISTENT_INPUT."""
    B, n = pb.a.shape
    m = pb.m
    mt = m + n
    dev = pb.G.device
    eqmask = torch.cat([pb.l == pb.u, pb.xl == pb.xu], dim=1)
    ar = torch.arange(mt, device=dev)[None, :]
    # stable, as jnp.argsort: the replay order is ascending index
    perm = torch.argsort(torch.where(eqmask, ar, mt + ar), dim=1, stable=True)
    neq = eqmask.sum(dim=1)
    kk = torch.zeros((B,), dtype=torch.long, device=dev)
    while True:
        active = (kk < neq) & (state.term == RUNNING)
        with spans.sync("replay"):
            go = bool(active.any())
        if not go:
            break
        idx = perm.gather(1, kk.clamp(0, mt - 1)[:, None])[:, 0]
        st = torch.where(idx < m, EQUALITY, FIXED)
        state = _where_state(active, _add_initial_constraint(
            pb, state, idx, st, opt, step_fn), state)
        kk = torch.where(active, kk + 1, kk)
    term = torch.where((neq > n) & (state.term == RUNNING),
                       OVERCONSTRAINED_PROBLEM, state.term)
    if opt.validate:
        term = torch.where(inconsistent_mask(pb), INCONSISTENT_INPUT, term)
    return dataclasses.replace(state, term=term.to(torch.int32))


def _safe_cholesky(G):
    """(L with I on non-SPD lanes, posdef) from ``torch.linalg.cholesky_ex``:
    posdef is ``info == 0``, since torch leaves a finite partial factor
    where ``jnp.linalg.cholesky`` gives NaN."""
    n = G.shape[-1]
    L, info = torch.linalg.cholesky_ex(G)
    posdef = info == 0
    eye = torch.eye(n, dtype=G.dtype, device=G.device).expand_as(G)
    return torch.where(posdef[:, None, None], L, eye), posdef


def init_state(pb: QPProblem, opt: SolverOptions) -> GIState:
    """Cold init (dense.py:326-389): Cholesky of G, J = L^-T,
    x = -G^-1 a, then the equality/fixed replay."""
    B, n = pb.a.shape
    dt, dev = pb.G.dtype, pb.G.device
    L, posdef = _safe_cholesky(pb.G)
    eye = torch.eye(n, dtype=dt, device=dev).expand_as(L)
    Lt = L.transpose(1, 2)
    J = torch.linalg.solve_triangular(Lt, eye, upper=True)
    y = torch.linalg.solve_triangular(L, pb.a[:, :, None], upper=False)
    x = -torch.linalg.solve_triangular(Lt, y, upper=True)[:, :, 0]
    base = initial_state(B, n, pb.m, dt, dev)
    state = dataclasses.replace(
        base, x=x, f=0.5 * _dot(pb.a, x), J=J,
        term=torch.where(posdef, RUNNING, NON_POS_HESSIAN).to(torch.int32))
    return _replay_equalities(pb, state, opt)


def jr_loop_plain(pb: QPProblem, state: GIState, opt: SolverOptions,
                  select_fn=None, step_fn=None, on_pass=None) -> GIState:
    """:func:`gi_iteration` until no lane is RUNNING (dense.py:392-410), one
    masked pass over the batch per iteration and a host sync after each. A
    lane that reaches ``opt.max_iter`` while RUNNING ends MAX_ITER_REACHED
    there, so it stops where its own loop would. Without hooks it is the
    plain PyTorch version of K10 (``ops/cuda/jr_kernel.py``);
    ``on_pass(before, after)``, if given, sees every pass (the tracer
    records with it)."""
    while True:
        capped = (state.term == RUNNING) & (state.it >= opt.max_iter)
        state = dataclasses.replace(state, term=torch.where(
            capped, MAX_ITER_REACHED, state.term).to(torch.int32))
        with spans.sync("pass"):
            go = bool((state.term == RUNNING).any())
        if not go:
            return state
        nxt = gi_iteration(pb, state, opt, select_fn, step_fn)
        if on_pass is not None:
            on_pass(state, nxt)
        state = nxt


def run_loop(pb: QPProblem, state: GIState, opt: SolverOptions,
             select_fn=None, step_fn=None, on_pass=None) -> GIState:
    """Run the GI loop from ``state`` until no lane is RUNNING
    (dense.py:392-410). Without hooks it is one launch of K10 on a CUDA
    state (``ops/cuda/jr_kernel.jr_loop``), each lane's iterations back to
    back, and :func:`jr_loop_plain` on a CPU one. ``select_fn`` and
    ``step_fn`` (the structured solver's block-sparse hooks) or
    ``on_pass`` (the tracer) run :func:`jr_loop_plain` with them. In a
    span ``jrlqp.loop``."""
    with spans.span("jrlqp.loop", state.x):
        if (select_fn is None and step_fn is None and on_pass is None
                and _on_card(state.x, "jr_loop")):
            return jr_loop(pb, state, opt)
        return jr_loop_plain(pb, state, opt, select_fn, step_fn, on_pass)


def finalize(pb: QPProblem, state: GIState) -> GIResult:
    """The result of a compact-slot state: a J/R ``GIState`` or the
    explicit-form ``fast.FastState`` (dense.py:413-421, fast.py:354-362)."""
    return GIResult(x=state.x, multipliers=_expand_multipliers(state, pb.m),
                    f=state.f, iterations=state.it, status=state.term,
                    active_set=state.status)


def solve_batch(pbs: QPProblem, opt: SolverOptions = SolverOptions()
                ) -> GIResult:
    """Solve a batch of QPs with the dense Goldfarb-Idnani dual active-set
    method in the problems' dtype (counterpart of ``vmap`` of
    ``jrlqp_tpu.solve``, dense.py:443-446). Runs on the problems' device:
    the torch init, then one launch of K10 on a card (:func:`run_loop`)."""
    with spans.call("solve_batch", pbs.G):
        with spans.span("jrlqp.init"):
            state0 = init_state(pbs, opt)
        state = run_loop(pbs, state0, opt)
        with spans.span("jrlqp.remap"):
            return finalize(pbs, state)


def solve(pb: QPProblem, opt: SolverOptions = SolverOptions()) -> GIResult:
    """:func:`solve_batch` under the JAX package's name for one problem
    (dense.py:430-440); the port's problems are always batched."""
    return solve_batch(pb, opt)
