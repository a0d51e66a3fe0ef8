"""Where K11 (``ops/cuda/fast_loop.py``) and its plain version
``fast.fast_loop_plain`` part on a lane, and how near a tie the deciding
test was there: the first parting iteration, found by bisecting the
iteration cap of each such lane, and the margins of the tests that
pick the next iteration's branch at the last state both share, and
whether both sides' final outcomes are sound together.
:func:`against_plain` runs both versions and gathers all of it; the card
tests and ``chip_smoke.py`` hold K11 with it."""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..solver import fast
from ..types import (
    EQUALITY,
    FIXED,
    INFEASIBLE,
    LINEAR_DEPENDENCY_DETECTED,
    MAX_ITER_REACHED,
    NON_POS_HESSIAN,
    SUCCESS,
    UPPER,
    UPPER_BOUND,
)

__all__ = ["same_lanes", "margins", "near_ties", "outcomes",
           "first_partings", "against_plain"]


def same_lanes(a: fast.FastState, b: fast.FastState) -> torch.Tensor:
    """(B,) lanes whose status, iterations, active count and active set are
    equal in two final states."""
    return ((a.term == b.term) & (a.it == b.it) & (a.q == b.q)
            & (a.status == b.status).all(dim=1))


def margins(pb, state: fast.FastState, opt) -> dict:
    """The deciding quantities of the next iteration of a one-lane
    ``state``, from the plain version's own functions: its active count q
    (at q = n, H is zero in exact arithmetic and z = H n+ is rounding
    noise, so the zero-z test reads noise), the selection's
    violation (>= 0 is SUCCESS) and its relative gap to the next most
    violated row, the steps t1 and t2 with their relative gap (a full step
    where t2 <= t1) and t1's gap to the next slot's step (its argmin), the
    zero-z test's ratio |z|^2 /
    (zthr^2 |n+|^2) (a primal step where > 1) and the dependence test's
    ratio delta / (dep_eps hscale |n+|^2) (a dependent add where <= 1)."""
    n = pb.n
    sel_idx, sel_st, viol = fast._select_violated(pb, state.x, state.status)
    skip = state.skip1
    idx = torch.where(skip, state.sc_idx, sel_idx)
    st = torch.where(skip, state.sc_status, sel_st)
    kq = torch.arange(n + 1, device=state.x.device)[None, :]
    u0 = torch.where(~skip[:, None] & (kq == state.q.long()[:, None]), 0.0,
                     state.u)
    nplus = fast._constraint_normal(pb, idx, st)
    z, r = fast._bmv(state.H, nplus), fast._bmv(state.Ns, nplus)
    valid = kq[:, :n] < state.q.long()[:, None]
    stat = state.status.long().gather(1, torch.where(
        valid, state.aorder.long(), 0).clamp(0, pb.m + n - 1))
    elig = valid & (stat != EQUALITY) & (stat != FIXED) & (r > 0)
    big = torch.tensor(opt.big_bnd, dtype=r.dtype, device=r.device)
    tks = torch.where(elig, u0[:, :n] / torch.where(elig, r, 1.0), big)
    t1 = float(torch.minimum(tks.min(), big))
    two = tks[0].sort().values[:2].tolist() + [opt.big_bnd]
    cand = _candidates(pb, state)
    sel = cand.sort().values[:2].tolist() + [float("inf")]
    nz, nn = float(fast._dot(nplus, z)[0]), float(fast._dot(nplus, nplus)[0])
    sign = -1.0 if int(st[0]) in (UPPER, UPPER_BOUND) else 1.0
    b = float(fast._selected_bound(pb, idx, st)[0])
    t2 = (sign * b - float(fast._dot(nplus, state.x)[0])) / (nz or 1.0)
    hs = max(float(state.hscale[0]), 1e-30)
    zthr = opt.zero_z_threshold * hs / n
    return {"q": int(state.q[0]), "n": n,
            "viol": float(viol[0]), "t1": t1, "t2": t2,
            "t_gap": _gap(t1, t2), "t1_runner_up_gap": _gap(two[0], two[1]),
            "selection_runner_up_gap": _gap(sel[0], sel[1]),
            "zz_over_threshold": float(fast._dot(z, z)[0])
            / max(zthr * zthr * nn, 1e-300),
            "delta_over_dep": nz / (fast._dep_eps(pb.G.dtype) * hs * nn)}


def _gap(a: float, b: float) -> float:
    """|a - b| relative to the larger magnitude (inf where either is not
    finite)."""
    if not (abs(a) < float("inf") and abs(b) < float("inf")):
        return float("inf")
    return abs(a - b) / max(abs(a), abs(b), 1e-300)


def _candidates(pb, state) -> torch.Tensor:
    """(m + n,) the selection's candidate violations of a one-lane state
    (``dense._select_violated``'s ``cand``): min(Cx - l, u - Cx) and
    min(x - xl, xu - x) on the inactive rows, inf on the active ones."""
    m = pb.m
    cx = fast._bmv(pb.C, state.x)
    inf = torch.tensor(float("inf"), dtype=state.x.dtype,
                       device=state.x.device)
    c = torch.cat([torch.minimum(cx - pb.l, pb.u - cx),
                   torch.minimum(state.x - pb.xl, pb.xu - state.x)], dim=1)
    return torch.where(state.status != 0, inf, c)[0]


def near_ties(plain: dict, k11: dict, dtype) -> list[str]:
    """The tests that rounding decides at the last state that K11 and the
    plain version share, from the :func:`margins` of both sides there
    (``plain``, ``k11``; the same active set, rounded in two orders).

    In f64 only a vertex: q >= n, where H is zero in exact arithmetic, so
    z = H n+, delta = n+^T z and the zero-z test read rounding noise.
    In f32 also: the dependence test where one side's ratio
    delta / (dep_eps hscale |n+|^2) is negative (H is positive
    semidefinite, so delta >= 0 in exact arithmetic: a negative delta is
    rounding of at least its size) and the plain side's distance to the
    threshold 1 is within both the two sides' disagreement and 16 times
    that negative ratio's size; the zero-z test within 4x of
    its threshold on the plain side; or the selection's sign, its argmin,
    t1's argmin or the t2 <= t1 test within 1e-4 relative."""
    tests = {"vertex": plain["q"] >= plain["n"]}
    if dtype == torch.float32:
        dp, dk, tol = plain["delta_over_dep"], k11["delta_over_dep"], 1e-4
        tests.update({
            "dependence": (min(dp, dk) < 0.0
                           and abs(dp - 1.0) <= min(abs(dp - dk),
                                                    -16.0 * min(dp, dk))),
            "zero-z test": 0.25 <= plain["zz_over_threshold"] <= 4.0,
            "selection sign": abs(plain["viol"]) <= tol,
            "selection argmin": plain["selection_runner_up_gap"] <= tol,
            "t1 argmin": plain["t1_runner_up_gap"] <= tol,
            "t2 <= t1": plain["t_gap"] <= tol})
    return [k for k, v in tests.items() if v]


# the class of each termination code: an answer, the cap, or no answer
_END_CLASS = {SUCCESS: "answer", MAX_ITER_REACHED: "cap",
              INFEASIBLE: "no answer", LINEAR_DEPENDENCY_DETECTED: "no answer",
              NON_POS_HESSIAN: "no answer"}


def outcomes(pb, got: fast.FastState, want: fast.FastState, lanes,
             ir_steps: int = 3) -> dict:
    """{lane: {"terms", "kkt", "objective", "sound"}} for each of
    ``lanes``: both sides' termination codes (plain, K11), the KKT residual
    and objective 0.5 x^T G x + a^T x of each, in f32 after ``ir_steps``
    steps of exact f64 refinement on its active set
    (``fast._refine_batch``), and whether the two outcomes are sound
    together: the same class of end (an answer: SUCCESS; the cap:
    MAX_ITER_REACHED; no answer: INFEASIBLE or LINEAR_DEPENDENCY_DETECTED,
    the two ways the engine gives a lane up), or both refined to KKT <=
    1e-8 with objectives equal within 1e-9 max(1, |f|). An f64 state is
    taken as it is (``fast.finalize``): refinement is the f32 engine's
    step."""
    from .kkt import kkt_residual

    lanes = list(lanes)
    if not lanes:
        return {}
    idx = torch.tensor(lanes, device=got.x.device)
    pb64 = pb._map(lambda t: t[idx]).with_dtype(torch.float64)
    side = {}
    for name, st in (("plain", want), ("k11", got)):
        sub = dataclasses.replace(st, **{f.name: getattr(st, f.name)[idx]
                                         for f in dataclasses.fields(st)})
        r = (fast._refine_batch(pb64, sub, ir_steps, functools.partial(
                 fast._DenseProducts, pb64, exact=True))
             if st.x.dtype == torch.float32 else fast.finalize(pb64, sub))
        x = r.x
        obj = 0.5 * fast._dot(x, fast._bmv(pb64.G, x)) + fast._dot(pb64.a, x)
        side[name] = (sub.term.tolist(),
                      kkt_residual(x, r.multipliers, pb64).tolist(),
                      obj.tolist())
    out = {}
    for j, lane in enumerate(lanes):
        (tp, kp, fp), (tk, kk, fk) = ((v[0][j], v[1][j], v[2][j])
                                      for v in (side["plain"], side["k11"]))
        refined = (kp <= 1e-8 and kk <= 1e-8
                   and abs(fp - fk) <= 1e-9 * max(1.0, abs(fp)))
        out[lane] = {"terms": (tp, tk), "kkt": (kp, kk),
                     "objective": (fp, fk),
                     "sound": _END_CLASS[tp] == _END_CLASS[tk] or refined}
    return out


def first_partings(pb, st0: fast.FastState, opt, lanes) -> dict:
    """{lane: (the first iteration at which K11 and the plain version part
    on ``lane`` of the batch ``pb`` from ``st0``, :func:`margins` of the
    plain version's and of K11's state after the iteration before)} for
    each of ``lanes``: the two states share their active set there, and
    the margins show how far each lies from the test that parts them. The
    lanes are bisected together on their own sub-batch: each gets its own
    iteration cap by an offset of its iteration count (the loop reads
    ``it`` only against the cap), so each bisection step is one K11 launch
    and one plain run."""
    lanes = list(lanes)
    if not lanes:
        return {}
    idx = torch.tensor(lanes, device=st0.x.device)
    sub = pb._map(lambda t: t[idx])
    s0 = dataclasses.replace(st0, **{f.name: getattr(st0, f.name)[idx]
                                     for f in dataclasses.fields(st0)})
    top = opt.max_iter

    def run(caps):
        # each lane stops at its own cap: it starts caps below the top
        off = (top - caps).to(s0.it.dtype)
        s1 = dataclasses.replace(s0, it=s0.it + off)
        a = fast._run_loop(sub, s1, opt)
        b = fast.fast_loop_plain(sub, s1, opt)
        same = same_lanes(a, b) & (a.aorder == b.aorder).all(dim=1)
        return same, a, b

    lo = s0.it.long().clone()
    hi = torch.full_like(lo, top)
    while bool((hi - lo > 1).any()):
        mid = torch.where(hi - lo > 1, (lo + hi) // 2, lo)
        same, _, _ = run(mid)
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    _, k11_lo, plain_lo = run(lo)

    def lane_of(st, j):
        return dataclasses.replace(st, **{f.name: getattr(st, f.name)[j:j + 1]
                                          for f in dataclasses.fields(st)})

    out = {}
    for j, lane in enumerate(lanes):
        one = sub._map(lambda t: t[j:j + 1])
        out[lane] = (int(hi[j]), margins(one, lane_of(plain_lo, j), opt),
                     margins(one, lane_of(k11_lo, j), opt))
    return out


def against_plain(pb, st0: fast.FastState, opt) -> dict:
    """K11 (one launch of ``fast._run_loop`` on a card) and the plain
    version from ``st0``: ``k11`` and ``plain`` (the final states), ``same``
    (:func:`same_lanes`),
    ``partings`` ({lane: {"iteration", "near_ties", "plain", "k11",
    "outcome"}} for every lane that parts: its first parting iteration and
    both sides' margins there from :func:`first_partings`, the tests that
    rounding decides there from :func:`near_ties`, and both sides' final
    outcomes from :func:`outcomes`), ``answer`` (the same lanes whose x is
    an answer: those that end SUCCESS or MAX_ITER_REACHED more than two
    slots from a vertex; an INFEASIBLE or dependent lane's last iterate is
    none, and a near-vertex active set amplifies the operators' rounding)
    and ``rel_x_err`` / ``abs_x_err`` (the largest |x - x_plain| over
    them, over max(1, |x_plain|) or not)."""
    got = fast._run_loop(pb, st0, opt)
    want = fast.fast_loop_plain(pb, st0, opt)
    same = same_lanes(got, want)
    parted = torch.nonzero(~same)[:, 0].tolist()
    ends = outcomes(pb, got, want, parted)
    partings = {
        lane: {"iteration": it,
               "near_ties": near_ties(mg, mg_k11, st0.x.dtype),
               "plain": mg, "k11": mg_k11, "outcome": ends[lane]}
        for lane, (it, mg, mg_k11) in first_partings(
            pb, st0, opt, parted).items()}
    answer = (same & ((want.term == 0) | (want.term == 4))
              & (want.q < pb.n - 2))
    diff = (got.x - want.x).abs().amax(dim=1)[answer]
    rel = diff / want.x[answer].abs().amax(dim=1).clamp_min(1.0)
    return {"k11": got, "plain": want, "same": same, "partings": partings,
            "answer": answer,
            "rel_x_err": float(rel.max()) if len(rel) else 0.0,
            "abs_x_err": float(diff.max()) if len(diff) else 0.0}
