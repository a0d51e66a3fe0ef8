"""The miss census of the f32 GI paths: the reference side and the verdicts.

Run from the repo's root (this file is not a test)::

    python tests/missed_lanes_census.py --census [--workers 3]
    python tests/missed_lanes_census.py --port
    python tests/missed_lanes_census.py --verdicts [--workers 3]
    python tests/missed_lanes_census.py --stages
    python tests/missed_lanes_census.py --spread [--workers 4]
    python tests/missed_lanes_census.py --split [--workers 6]
    python tests/missed_lanes_census.py --report

``--census`` draws each set of ``jrlqp_tpu_torch.testing.miss_census`` with
the JAX package (``random_qp_batch(jax.random.key(seed))``: the headline
set at seeds 0-7, K3's and K9's at seed 0, the size sweep at n = 10-100),
solves it with the path's Pallas kernel in interpret mode,
``vmap(solve_refined)`` and the port's plain path on the CPU, prints the
counts per set and writes every lane any of them misses to
``tests/data/missed_lanes_jax.npz`` (one run writes the whole file).
``--port`` adds the same solvers' outcomes on each lane alone to
``tests/data/missed_lanes_port.npz`` (the card's census). The card then
adds its outcomes to the JAX file (``miss_census --jax-lanes``).

``--verdicts`` finds, for each lane where the card's kernel (or the port's
plain path on the CPU) and the JAX kernel part, the first iteration at
which they choose differently, by bisecting iteration caps, and the
quantity that decided it with its distance from its threshold in f32 ulps;
a parting within 16 ulps is a near-tie. It drops the kernel's trajectory
from lanes where the card's kernel and the JAX kernel agree. ``--stages``
follows each parting beyond 16 ulps in which the port misses back through
the shared iterations: at each cap, how far each side's x and the deciding
slack lie from the f64 iterate of the same active set.

``--spread`` holds the JAX package against itself: on every lane of both
files where its Pallas kernel and its XLA f32 loop (``_run_fast``, as
``solve_refined`` calls it) end otherwise alone, the first parting of the
two by the same bisection, written into the files as ``verdict_xla``; it
prints each pairing with the JAX kernel (the XLA loop, the card's kernel,
the port's plain path): partings, near-ties, partings beyond a tie by who
misses, and the median deviation of each side's x along the deciding row.
``--split`` splits the deciding error by operation
(``jrlqp_tpu_torch.testing.op_split``): each side's iterations from its own
f32 states (the card's from ``tests/data/split_states_card.npz``, written
by ``miss_census --states`` on the card; the JAX kernel's by
:func:`jax_capped`; the plain version's on the CPU) replayed in that
side's order and held to its next state bit for bit, each operation's own
rounding against f64 on the same inputs, the deciding slack's error split
at every slack parting, and over the stage range of each lane the port
misses beyond a tie. ``--report`` prints the census and the spread side by
side.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import multiprocessing
import os
import sys
import time

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from jrlqp_tpu import SolverOptions as JOptions  # noqa: E402
from jrlqp_tpu.solver.fast import _run_fast  # noqa: E402
from jrlqp_tpu.testing.batch_gen import random_qp_batch as j_random_qp_batch  # noqa: E402
from jrlqp_tpu_torch import problem_from_numpy  # noqa: E402
from jrlqp_tpu_torch.testing import miss_census as mc  # noqa: E402
from jrlqp_tpu_torch.testing import op_split  # noqa: E402
from test_torch_missed_lanes import (  # noqa: E402
    FILES,
    SOLVERS,
    _brief,
    jax_problem,
    lane_arrays,
)

CHUNK = 2048
HEADLINE_SEEDS = dict((s[0], s[2]) for s in mc.SETS)["headline"]


def _setup_jax():
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])


def _load(which: str):
    return mc.load_lanes(str(FILES[which]))


def _save(which: str, lanes: list, summary: dict) -> None:
    mc.save_lanes(str(FILES[which]), lanes, summary)


def jax_batch(name: str, key: int) -> dict:
    """The JAX package's draws of a census batch as numpy f64 arrays: the
    headline set from ``random_qp_batch(key(seed))`` made in f32 and cast
    to f64 (bench.py:95-97), the size sweep's from ``random_qp_batch(
    key(0), n, 2n)`` in f64 (jrlqp_tpu/bench/harness.py:172)."""
    if name == "size_sweep":
        pbs = j_random_qp_batch(jax.random.key(0), mc.BATCH, key, 2 * key,
                                act_frac=mc.ACT_FRAC)
    else:
        pbs = j_random_qp_batch(jax.random.key(key), mc.BATCH, mc.N, mc.M,
                                act_frac=mc.ACT_FRAC, dtype=jnp.float32)
    return {k: np.asarray(getattr(pbs, k), dtype=np.float64)
            for k in mc.ARRAYS}


def _census_job(job):
    """One census batch: (name, path list, key). Returns (summary rows,
    lane records)."""
    _setup_jax()
    torch.set_num_threads(2)
    name, paths, key = job
    t0 = time.perf_counter()
    d = jax_batch(name, key)
    B = d["G"].shape[0]
    n, m = d["G"].shape[1], d["C"].shape[1]
    mi, ir = mc.set_options(name)
    seed = 0 if name == "size_sweep" else key
    ref = {"path": "K1", "max_iter": mi, "ir_steps": ir}
    refined = []
    by_path = {p: {"jax_pallas": [], "port_plain_cpu": []} for p in paths}
    for s in range(0, B, CHUNK):
        dc = {k: v[s:s + CHUNK] for k, v in d.items()}
        refined += SOLVERS["jax_solve_refined"](dc, ref)
        for p in paths:
            r = dict(ref, path=p)
            for w in by_path[p]:
                by_path[p][w] += SOLVERS[w](dc, r)
    rows, lanes = [], []
    for p in paths:
        set_name = {"K1": name, "K3": "non_fused", "K9": "compact"}[p]
        outs = dict(by_path[p], jax_solve_refined=refined)
        miss = {w: {i for i, o in enumerate(v) if not o["passed"]}
                for w, v in outs.items()}
        # solve_refined's misses are the headline set's, whatever the path
        saved = set().union(*(v for w, v in miss.items()
                              if p == "K1" or w != "jax_solve_refined"))
        parts = sum(not mc.same_outcome(a, b) for a, b in zip(
            outs["jax_pallas"], outs["port_plain_cpu"]))
        row = {"set": f"{set_name}/{seed}" + (f"/n{n}" if name == "size_sweep"
                                             else ""),
               "path": p, "lanes": B,
               **{f"{w}_misses": len(v) for w, v in miss.items()},
               "jax_pallas_and_port_plain_cpu_miss": len(
                   miss["jax_pallas"] & miss["port_plain_cpu"]),
               "jax_pallas_vs_port_plain_cpu_lanes_that_part": parts,
               "seconds": time.perf_counter() - t0}
        for i in sorted(saved):
            rec = {"set": set_name, "path": p, "seed": seed, "lane": i,
                   "n": n, "m": m, "max_iter": mi, "ir_steps": ir,
                   "missed_by": sorted(w for w, v in miss.items() if i in v),
                   "arrays": {k: v[i] for k, v in d.items()},
                   "outcomes": {w: v[i] for w, v in outs.items()}}
            add_alone(rec)
            lanes.append(rec)
        row["saved"] = [mc.lane_id(r) for r in lanes if r["path"] == p]
        rows.append(row)
        print(row, flush=True)
    return rows, lanes


def add_alone(rec: dict) -> None:
    """Each CPU solver on the lane alone, as ``<solver>_alone``; and
    whether that gives the outcome it had in the batch."""
    d = lane_arrays(rec)
    same = True
    for w, fn in SOLVERS.items():
        o = fn(d, rec)[0]
        rec["outcomes"][f"{w}_alone"] = o
        if w in rec["outcomes"]:
            same &= mc.same_outcome(o, rec["outcomes"][w])
    rec["cpu_alone_reproduces"] = bool(same)


def census(workers: int) -> None:
    """Every census batch in ``workers`` processes; one file of lanes."""
    jobs = [("size_sweep", ("K1",), n) for n in reversed(mc.SWEEP_SIZES)]
    jobs += [("headline", ("K1", "K3", "K9") if s == 0 else ("K1",), s)
             for s in HEADLINE_SEEDS]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        results = [f.result() for f in [ex.submit(_census_job, j)
                                        for j in jobs]]
    summary = {r["set"]: r for rows, _ in results for r in rows}
    lanes = [rec for _, recs in results for rec in recs]
    _save("jax", lanes, summary)
    print({"saved": len(lanes), "file": str(FILES["jax"])})


def port_lanes() -> None:
    """Each CPU solver's outcome on each lane of the port's file."""
    port, summary = _load("port")
    for rec in port:
        add_alone(rec)
        print(mc.lane_id(rec), {w: _brief(rec["outcomes"][f"{w}_alone"])
                                for w in SOLVERS}, flush=True)
    _save("port", port, summary)


# ---- where two solvers part: the first iteration and what decided it ----

NEAR_TIE_ULPS = 16


def jax_capped(rec: dict, cap: int) -> dict:
    """The JAX package's Pallas loop (the path's flags, interpret mode) on
    the lane alone, stopped after ``cap`` iterations, as numpy arrays."""
    from jrlqp_tpu.ops.pallas.gi_kernel import run_loop_pallas
    from jrlqp_tpu.solver.fast import _init_fast

    pb32 = jax_problem(lane_arrays(rec)).with_dtype(jnp.float32)
    if rec["path"] == "K1":
        out = run_loop_pallas(pb32, None, cap, interpret=True,
                              fused_init=True)
    else:
        opt32 = JOptions(max_iter=rec["max_iter"]).with_(
            dtype=jnp.float32, zero_z_threshold=1e-6)
        # jitted as inside solve_refined_pallas: run eagerly, the init
        # rounds otherwise
        state0 = jax.jit(jax.vmap(lambda p: _init_fast(p, opt32)))(pb32)
        out = run_loop_pallas(pb32, state0, cap, interpret=True,
                              pack=1 if rec["path"] == "K9" else None)
    return {k: np.asarray(v)[0] for k, v in out.items()}


def _ulp(v) -> float:
    return float(np.spacing(np.float32(abs(v))))


def f64_solution(rec: dict) -> np.ndarray:
    """x of the f64 J/R engine on the lane (the port's ``solve_batch``)."""
    from jrlqp_tpu_torch import SolverOptions
    from jrlqp_tpu_torch.solver import dense

    res = dense.solve_batch(problem_from_numpy(**lane_arrays(rec),
                                               device="cpu"),
                            SolverOptions(max_iter=rec["max_iter"]))
    return res.x[0].numpy()


def _data(rec: dict, dt=np.float32) -> dict:
    """The lane's arrays rounded to ``dt`` (the kernels' f32 input by
    default), in f64."""
    return {k: rec["arrays"][k].astype(dt).astype(np.float64)
            for k in mc.ARRAYS}


def _violations(rec: dict, x, f32_data: bool = True):
    """min(Cx - l, u - Cx) and min(x - xl, xu - x) per constraint in f64
    at x as given, on the f32-rounded data (or on the f64 data), with the
    scale |Cx| or |x| beside."""
    return op_split.violations(
        _data(rec, np.float32 if f32_data else np.float64), x)


def decide(rec: dict, prev: dict, nxt: dict, port_prev_x, port_next: dict
           ) -> dict:
    """What the iteration from ``prev`` (the JAX state, equal in status on
    both sides) to the two next states decided, and its margin. ``nxt`` is
    the JAX state after it, ``port_next`` the port's (status, term), and
    ``port_prev_x`` the port's x before it."""
    S0 = prev["status"] != 0
    sides = {"jax": (nxt["status"] != 0, int(nxt["term"])),
             "port": (port_next["status"] != 0, int(port_next["term"]))}
    change = {k: (sorted(np.nonzero(s & ~S0)[0].tolist()),
                  sorted(np.nonzero(~s & S0)[0].tolist()), t)
              for k, (s, t) in sides.items()}
    out = {"jax": change["jax"], "port": change["port"]}
    vj, scale_j = _violations(rec, prev["x"])
    vp, scale_p = _violations(rec, port_prev_x)
    v64, scale64 = _violations(rec, f64_solution(rec), f32_data=False)
    (aj, rj, tj), (ap, rp, tp) = change["jax"], change["port"]

    def margins(q, ref, ulp):
        # the quantity at the f64 solution, and how far each f32 side's
        # value lies from it, all in f32 ulps of the operands' scale
        return {"ulps": abs(q(v64)) / ulp,
                "jax_deviation_ulps": abs(q(vj) - q(v64)) / ulp,
                "port_deviation_ulps": abs(q(vp) - q(v64)) / ulp,
                **{f"{k}_{w}": float(q(v)) for w, v in
                   (("jax", vj), ("port", vp), ("f64", v64))
                   for k in (ref,)}}

    if (aj and not rj and tp == 0 and not ap) or (ap and not rp
                                                  and tj == 0 and not aj):
        p = (aj or ap)[0]
        out.update(kind="select: slack of constraint %d against viol >= 0"
                   % p, constraint=p,
                   **margins(lambda v: v[p], "slack",
                             _ulp(max(scale64[p], scale_j[p]))))
    elif aj and ap and aj != ap and not rj and not rp:
        p, q = aj[0], ap[0]
        out.update(kind="select: argmin between constraints %d and %d"
                   % (p, q),
                   **margins(lambda v: v[p] - v[q], "gap",
                             _ulp(max(scale64[p], scale64[q]))))
    elif (aj and not rj and rp and not ap) or (ap and not rp and rj
                                                 and not aj):
        out.update(_step_choice(rec, prev))
    elif 5 in (tj, tp) and aj == ap:
        out.update(_dependence(rec, prev))
    else:
        out.update(kind="other", ulps=float("nan"))
    return out


def _quantities(H, Ns, x, u, eligible, nplus, bp) -> dict:
    """z = H n+, r = N* n+; the step lengths t1 (partial: the least
    u_k / r_k over the eligible slots with r_k > 0) and t2 (full); nz =
    n+ z, nn = n+ n+ and |z|^2."""
    z, r = H @ nplus, Ns @ nplus
    ok = eligible & (r > 0)
    t1 = float(np.min(np.where(ok, u / np.where(ok, r, 1.0), np.inf),
                      initial=np.inf))
    nz = float(nplus @ z)
    return {"t1": t1, "t2": float((bp - nplus @ x) / nz), "nz": nz,
            "nn": float(nplus @ nplus), "znorm2": float(z @ z)}


def _iterate64(rec: dict, status):
    """(H, N*, x, u) in f64 on the f32-rounded data of the active set
    ``status`` alone: x and u of its equality-constrained minimizer, and
    the eligible slots (not equalities)."""
    it = op_split.iterate64(_data(rec), status)
    return (it["H"], it["Ns"], it["x"], it["u"],
            ~np.isin(np.asarray(status)[it["active"]], (3, 6)))


def _exact(rec: dict, status, p: int, st: int) -> dict:
    """:func:`_quantities` of the active set ``status`` alone
    (:func:`_iterate64`) for the candidate p at status st."""
    return _quantities(*_iterate64(rec, status),
                       *op_split.candidate_normal(_data(rec), p, st))


def _f32_state(rec: dict, prev: dict, p: int, st: int) -> dict:
    """:func:`_quantities` from the JAX package's f32 state (x, u, H, N*,
    its slots), in f64 arithmetic."""
    slot = prev["aorder"]
    kind = prev["status"][np.maximum(slot, 0)]
    return _quantities(prev["H"].astype(np.float64),
                       prev["Ns"].astype(np.float64),
                       prev["x"].astype(np.float64),
                       prev["u"].astype(np.float64),
                       (slot >= 0) & ~np.isin(kind, (3, 6)),
                       *op_split.candidate_normal(_data(rec), p, st))


def _candidate_of(rec: dict, prev: dict) -> tuple[int, int]:
    """(index, status) of the JAX state's candidate after ``prev``: its
    pending one, or the most violated inactive row and its nearer side."""
    m = rec["m"]
    if int(prev["skip1"]):
        return int(prev["sc_idx"]), int(prev["sc_status"])
    a = _data(rec)
    x = prev["x"].astype(np.float64)
    v, _ = _violations(rec, prev["x"])
    p = int(np.argmin(np.where(prev["status"] != 0, np.inf, v)))
    if p < m:
        cx = a["C"][p] @ x
        return p, 1 if cx - a["l"][p] <= a["u"][p] - cx else 2
    return p, 4 if x[p - m] - a["xl"][p - m] <= a["xu"][p - m] - x[p - m] \
        else 5


def _tests(q: dict, rec: dict, tr0: float) -> dict:
    """Each test the iteration makes, as (value, threshold, scale): the
    full step against the partial one (t2 <= t1), the zero-z test
    (|z|^2 > zs^2 nn, zs = 1e-6 tr0 / n) and the dependence test
    (nz <= 2e-7 tr0 nn); the scale sets the f32 resolution."""
    zs = 1e-6 * tr0 / rec["n"]
    return {"t2 <= t1": (q["t2"], q["t1"], max(abs(q["t1"]), abs(q["t2"]))),
            "|z|^2 > zs^2 nn": (q["znorm2"], zs * zs * q["nn"],
                                (tr0 / rec["n"]) ** 2 * q["nn"]),
            "nz <= dep_thr nn": (q["nz"], 2e-7 * tr0 * q["nn"],
                                 tr0 * q["nn"])}


def _margins(rec: dict, prev: dict, names) -> dict:
    """The test among ``names`` with the least margin at the exact
    iterate of the shared active set, in f32 ulps of its scale, and how
    far the JAX package's f32 state puts it from there. Where the shared
    state is mid-step (a pending candidate), its x and u are not the
    active set's minimizer, and the JAX state's values stand alone."""
    p, st = _candidate_of(rec, prev)
    tr0 = float(prev["hscale"])
    mid = bool(int(prev["skip1"]))
    f32 = _tests(_f32_state(rec, prev, p, st), rec, tr0)
    ex = f32 if mid else _tests(_exact(rec, prev["status"], p, st), rec, tr0)
    best = None
    for name in names:
        (v, t, sc), (vj, tj, _) = ex[name], f32[name]
        ulp = _ulp(sc)
        got = {"test": name, "constraint": p, "value_exact": v,
               "threshold_exact": t, "value_jax": vj, "threshold_jax": tj,
               "ulps": abs(v - t) / ulp,
               "jax_deviation_ulps": abs((vj - tj) - (v - t)) / ulp,
               "exact_state": not mid}
        if best is None or got["ulps"] < best["ulps"]:
            best = got
    return best


def _step_choice(rec: dict, prev: dict) -> dict:
    out = _margins(rec, prev, ("t2 <= t1", "|z|^2 > zs^2 nn"))
    out["kind"] = (f"step of constraint {out['constraint']}: "
                   f"{out['test']}")
    return out


def _dependence(rec: dict, prev: dict) -> dict:
    out = _margins(rec, prev, ("nz <= dep_thr nn",))
    out["kind"] = (f"dependence test of constraint {out['constraint']}: "
                   f"{out['test']}")
    return out


def first_parting(rec: dict, port_at, last: int, iterations=()) -> dict:
    """Bisect the iteration caps 0..``last`` for the first where the JAX
    package's Pallas loop and the port's (``port_at(cap)`` -> status, x,
    it, term) stop agreeing in status, iterations and termination; then
    what that iteration decided (:func:`decide`). Each side's state at
    ``last`` must end at one of ``iterations``, the counts its solves
    recorded."""
    cache, pcache = {}, {}

    def jx(c):
        if c not in cache:
            cache[c] = jax_capped(rec, c)
        return cache[c]

    def pt(c):
        if c not in pcache:
            pcache[c] = port_at(c)
        return pcache[c]

    def same(c):
        j, p = jx(c), pt(c)
        return (np.array_equal(j["status"], p["status"])
                and int(j["it"]) == int(p["it"])
                and int(j["term"]) == int(p["term"]))

    if same(last):
        return {"kind": "same discrete path; the f64 refinement of the same "
                        "active set decides the gate", "iteration": None,
                "ulps": float("nan")}
    for side, state in (("jax", jx(last)), ("port", pt(last))):
        if int(state["it"]) not in iterations:
            return {"kind": f"the {side} trajectory does not end at a "
                            f"recorded iteration count", "iteration": None,
                    "ulps": float("nan")}
    lo, hi = 0, last
    if not same(0):
        return {"kind": "the cold init differs", "iteration": 0,
                "ulps": float("nan")}
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if same(mid):
            lo = mid
        else:
            hi = mid
    out = decide(rec, jx(lo), jx(hi), pt(lo)["x"], pt(hi))
    out["iteration"] = hi
    return out




def _verdict_job(item):
    """(which, lane, verdict of the card's kernel against the JAX kernel,
    verdict of the port's plain path on the CPU against the JAX kernel);
    a verdict is None where the outcomes agree or were not recorded."""
    which, lane = item
    _setup_jax()
    rec = next(r for r in _load(which)[0] if mc.lane_id(r) == lane)
    o = rec["outcomes"]
    j = o["jax_pallas_alone"]
    last = max(v["iterations"] for v in o.values())
    last = min(last + 1, rec["max_iter"])
    out = []
    traj = rec.get("kernel_card_trajectory")
    k = o.get("kernel_card_alone")
    if k is None or mc.same_outcome(k, j):
        out.append(None)
    else:
        out.append(first_parting(
            rec, lambda c: {f: traj[f][c] for f in traj}, last,
            {k["iterations"], j["iterations"]}))
    cpu = o["port_plain_cpu_alone"]
    if mc.same_outcome(cpu, j):
        out.append(None)
    else:
        out.append(first_parting(rec, _plain_at(rec), last,
                                 {cpu["iterations"], j["iterations"]}))
    print(which, lane, out, flush=True)
    return which, lane, out[0], out[1]


def _plain_at(rec: dict):
    """cap -> the port's plain loop on the CPU at that cap (status, x, q,
    it, term)."""
    pb = mc.lane_problem(rec, "cpu")

    def at(c):
        t = mc.trajectory(rec["path"], pb, rec["max_iter"], [c])
        return {f: v[0] for f, v in t.items()}
    return at


def verdicts(workers: int) -> None:
    """The first parting of the card's kernel (``verdict``) and of the
    port's plain path on the CPU (``verdict_cpu``) from the JAX package's
    kernel on every lane of both files, written into the files; a parting
    within 16 f32 ulps of its threshold is a near-tie. The card's
    trajectory is kept only where the card's kernel and the JAX kernel
    part."""
    items = [(w, mc.lane_id(r)) for w in FILES for r in _load(w)[0]]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        got = {(w, lane): (v, c) for w, lane, v, c in ex.map(_verdict_job,
                                                             items)}
    for w in FILES:
        lanes, summary = _load(w)
        for rec in lanes:
            for key, v in zip(("verdict", "verdict_cpu"),
                              got[(w, mc.lane_id(rec))]):
                rec.pop(key, None)
                if v is not None:
                    v["near_tie"] = bool(v["ulps"] <= NEAR_TIE_ULPS)
                    rec[key] = v
            if "verdict" not in rec:
                rec.pop("kernel_card_trajectory", None)
        _save(w, lanes, summary)


# ---- where a port path's error outgrows the JAX kernel's ----

def _missed_beyond_tie(rec: dict) -> list[tuple[str, str]]:
    """(verdict key, port solver) of each parting beyond 16 ulps in which
    the port's side misses and the JAX kernel passes."""
    o = rec["outcomes"]
    out = []
    for key, side in (("verdict", "kernel_card_alone"),
                      ("verdict_cpu", "port_plain_cpu_alone")):
        v = rec.get(key)
        if (v and not v["near_tie"] and not o[side]["passed"]
                and o["jax_pallas_alone"]["passed"]):
            out.append((key, side))
    return out


def stage_rows(rec: dict, port_at, last: int, p: int) -> list[dict]:
    """For each cap 0..``last`` (the iterations the port and the JAX kernel
    share) where both sides hold the same active set at a vertex (no
    pending candidate): how far each side's x (max |x - x64| in f32 ulps of
    max |x64|) and the slack of constraint ``p`` (in f32 ulps of its row's
    |C x|) lie from the f64 minimizer x64 of that active set on the
    f32-rounded data. Cap 0 is the state after the cold init."""
    rows = []
    for c in range(last + 1):
        j, q = jax_capped(rec, c), port_at(c)
        if (not np.array_equal(j["status"] != 0, q["status"] != 0)
                or int(j["skip1"])):
            continue
        x64 = _iterate64(rec, j["status"])[2]
        v64, scale = _violations(rec, x64)
        ux = _ulp(np.max(np.abs(x64)))
        us = _ulp(max(scale[p], 1e-30))
        row = {"cap": c, "active": int(np.count_nonzero(j["status"]))}
        for side, x in (("jax", j["x"]), ("port", q["x"])):
            row[f"{side}_x_ulps"] = float(
                np.max(np.abs(x.astype(np.float64) - x64)) / ux)
            row[f"{side}_slack_ulps"] = float(
                abs(_violations(rec, x)[0][p] - v64[p]) / us)
        rows.append(row)
    return rows


def _stage_summary(rows: list[dict]) -> dict:
    """Where the port's deviation passes the JAX kernel's: at cap 0 (the
    cold init), the first cap from which the port's slack error stays
    above the JAX kernel's to the parting, and the medians over the loop."""
    above = [r["port_slack_ulps"] > r["jax_slack_ulps"] for r in rows]
    k = len(above)
    while k > 0 and above[k - 1]:
        k -= 1
    loop = rows[1:] if rows and rows[0]["cap"] == 0 else rows
    return {
        "init": rows[0] if rows and rows[0]["cap"] == 0 else None,
        "last_shared": rows[-1] if rows else None,
        "port_above_from_cap": rows[k]["cap"] if k < len(rows) else None,
        "median_loop": {f: float(np.median([r[f] for r in loop]))
                        for f in ("jax_x_ulps", "port_x_ulps",
                                  "jax_slack_ulps", "port_slack_ulps")}
        if loop else None,
        "caps_compared": len(rows)}


def _stage_job(item):
    which, lane, key = item
    _setup_jax()
    rec = next(r for r in _load(which)[0] if mc.lane_id(r) == lane)
    v = rec[key]
    if key == "verdict":
        traj = rec["kernel_card_trajectory"]

        def port_at(c):
            return {f: traj[f][c] for f in traj}
    else:
        port_at = _plain_at(rec)
    rows = stage_rows(rec, port_at, v["iteration"] - 1, v["constraint"])
    out = {"rows": rows, **_stage_summary(rows)}
    print(which, lane, key, {k: out[k] for k in out if k != "rows"},
          flush=True)
    return which, lane, key, out


def stages(workers: int) -> None:
    """:func:`stage_rows` of every parting beyond 16 ulps in which the
    port misses and the JAX kernel passes, written into the files as
    ``<verdict key>_stages``."""
    items = [(w, mc.lane_id(r), key) for w in FILES for r in _load(w)[0]
             for key, _ in _missed_beyond_tie(r)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        got = {(w, lane, key): out
               for w, lane, key, out in ex.map(_stage_job, items)}
    for w in FILES:
        lanes, summary = _load(w)
        for rec in lanes:
            for key in ("verdict", "verdict_cpu"):
                rec.pop(f"{key}_stages", None)
                if (w, mc.lane_id(rec), key) in got:
                    rec[f"{key}_stages"] = got[(w, mc.lane_id(rec), key)]
        _save(w, lanes, summary)


# ---- the reference's own spread: its Pallas kernel against its XLA loop ----

@functools.partial(jax.jit, static_argnames="opt")
def _xla_loop(pbs, opt):
    return jax.vmap(lambda p: _run_fast(p.with_dtype(jnp.float32), opt))(pbs)


def xla_capped(rec: dict, cap: int) -> dict:
    """The JAX package's XLA f32 loop (``_run_fast``, compact slots) on the
    lane alone, stopped after ``cap`` iterations, as ``solve_refined``
    calls it under ``vmap``; numpy arrays."""
    opt32 = JOptions(max_iter=cap).with_(dtype=jnp.float32,
                                         zero_z_threshold=1e-6)
    st = _xla_loop(jax_problem(lane_arrays(rec)), opt32)
    return {f.name: np.asarray(getattr(st, f.name))[0]
            for f in dataclasses.fields(st)}


def _rename(v: dict, old: str, new: str) -> dict:
    return {k.replace(old, new): val for k, val in v.items()}


def _spread_job(item):
    """(which, lane, the first parting of the JAX kernel and the XLA loop or
    None where their outcomes agree, whether the uncapped XLA loop gives
    ``jax_solve_refined_alone``'s iterations and active set)."""
    which, lane = item
    _setup_jax()
    rec = next(r for r in _load(which)[0] if mc.lane_id(r) == lane)
    o = rec["outcomes"]
    j, s = o["jax_pallas_alone"], o["jax_solve_refined_alone"]
    full = xla_capped(rec, rec["max_iter"])
    same_run = bool(int(full["it"]) == s["iterations"] and np.array_equal(
        full["status"] != 0, s["active_set"] != 0))
    v = None
    if not mc.same_outcome(j, s):
        last = min(max(j["iterations"], s["iterations"]) + 1, rec["max_iter"])
        v = _rename(first_parting(rec, lambda c: xla_capped(rec, c), last,
                                  {j["iterations"], s["iterations"]}),
                    "port", "xla")
        v["near_tie"] = bool(v["ulps"] <= NEAR_TIE_ULPS)
    print(which, lane, same_run, v, flush=True)
    return which, lane, v, same_run


def spread(workers: int) -> None:
    """The first parting of the JAX package's Pallas kernel (the path's
    flags) and its XLA loop on every lane of both files where their
    outcomes alone differ, written into the files as ``verdict_xla``."""
    items = [(w, mc.lane_id(r)) for w in FILES for r in _load(w)[0]]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        got = {(w, lane): (v, s) for w, lane, v, s in ex.map(_spread_job,
                                                             items)}
    bad = [k for k, (_, s) in got.items() if not s]
    if bad:
        raise RuntimeError(f"the capped XLA loop does not reproduce "
                           f"solve_refined's outcome on {bad}")
    for w in FILES:
        lanes, summary = _load(w)
        for rec in lanes:
            rec.pop("verdict_xla", None)
            v = got[(w, mc.lane_id(rec))][0]
            if v is not None:
                rec["verdict_xla"] = v
        _save(w, lanes, summary)


# (verdict key, the side held against the JAX kernel, its outcome alone,
# the key of its deviations in the verdict)
PAIRINGS = (("verdict_xla", "JAX XLA loop", "jax_solve_refined_alone", "xla"),
            ("verdict", "K on the card", "kernel_card_alone", "port"),
            ("verdict_cpu", "port plain, CPU", "port_plain_cpu_alone",
             "port"))


def spread_table() -> list[dict]:
    """Per pairing with the JAX Pallas kernel, over both files: lanes
    compared, partings, near-ties, partings beyond a tie by who misses,
    and on the slack partings the median deviation of each side's x along
    the deciding row (ulps of its |C x|)."""
    recs = _load("port")[0] + _load("jax")[0]
    rows = []
    for key, name, side, dev in PAIRINGS:
        got = [r for r in recs if key in r]
        beyond = [r for r in got if not r[key]["near_tie"]]

        def passed(r, w):
            return r["outcomes"][w]["passed"]
        slack = [r[key] for r in got if f"{dev}_deviation_ulps" in r[key]]
        rows.append({
            "pairing": f"JAX kernel vs {name}",
            "lanes": sum(side in r["outcomes"] for r in recs),
            "partings": len(got),
            "near_ties": len(got) - len(beyond),
            "beyond, the other misses": sorted(
                mc.lane_id(r) for r in beyond if not passed(r, side)
                and passed(r, "jax_pallas_alone")),
            "beyond, the JAX kernel misses": sorted(
                mc.lane_id(r) for r in beyond if passed(r, side)
                and not passed(r, "jax_pallas_alone")),
            "beyond, both miss": sorted(
                mc.lane_id(r) for r in beyond if not passed(r, side)
                and not passed(r, "jax_pallas_alone")),
            "slack partings": len(slack),
            "median deviation ulps (JAX kernel, other)": [
                float(np.median([v["jax_deviation_ulps"] for v in slack])),
                float(np.median([v[f"{dev}_deviation_ulps"] for v in slack]))]
            if slack else None})
    for row in rows:
        print(_r(row))
    return rows


# ---- the per-operation split of the deciding error ----

CARD_STATES = FILES["port"].parent / "split_states_card.npz"
# the lanes of ROADMAP queue 3d and the reverse lanes (PERF.md section 6):
# (file, lane, the verdict that parts)
SPLIT_LANES = (("port", "headline-3-9615", "verdict"),
               ("port", "size_sweep-0-n100-6448", "verdict"),
               ("jax", "headline-6-13413", "verdict"),
               ("jax", "headline-6-13413", "verdict_cpu"),
               ("jax", "size_sweep-0-n100-3536", "verdict_cpu"),
               ("jax", "size_sweep-0-n100-3525", "verdict_cpu"),
               ("jax", "size_sweep-0-n100-5043", "verdict"),
               ("jax", "size_sweep-0-n75-8518", "verdict"),
               ("jax", "non_fused-0-11024", "verdict"),
               ("jax", "size_sweep-0-n100-5043", "verdict_cpu"),
               ("jax", "size_sweep-0-n75-8518", "verdict_cpu"),
               ("jax", "non_fused-0-11024", "verdict_cpu"),
               ("port", "headline-2-7532", "verdict_cpu"),
               ("jax", "headline-7-1527", "verdict_cpu"))
OPS = ("slack", "z", "t1", "t2", "x_update", "rank_one")
PARTS = ("dot", "inherited", "x_update", "directions", "step_length",
         "state")


def _pack(rec: dict) -> int:
    from jrlqp_tpu.ops.pallas import gi_kernel as gk
    key = (gk._round_up(rec["n"] + 1, 8), gk._round_up(max(rec["m"], 1), 8))
    return gk._PROVEN_PACK.get(key) or gk._auto_pack(*key)


class JaxOrder:
    """The JAX kernel's reductions (``_packed_iterate``, interpret mode on
    the CPU): its ``_vecmat`` and ``_bmv`` on the padded operands of a pack
    of ``P`` copies of the lane (``run_loop_pallas`` pads a batch of one
    by wrapping), and ``jnp.sum`` of products over np slots; XLA on the
    CPU contracts each update a - b c into one FMA. The interface of
    ``op_split.K1Order``."""

    fused = True

    def __init__(self, rec: dict):
        from jrlqp_tpu.ops.pallas import gi_kernel as gk
        self.n, self.m, self.P = rec["n"], rec["m"], _pack(rec)
        self.np = gk._round_up(self.n + 1, 8)
        self.mp = gk._round_up(max(self.m, 1), 8)
        self._vecmat = jax.jit(gk._vecmat)
        self._bmv = jax.jit(gk._bmv)
        self._sum = jax.jit(lambda a, b: jnp.sum(a * b, axis=1,
                                                  keepdims=True))

    def _tile(self, A, rows, cols):
        out = np.zeros((self.P, rows, cols), np.float32)
        out[:, :A.shape[0], :A.shape[1]] = A
        return jnp.asarray(out)

    def _vec(self, v):
        out = np.zeros((self.P, self.np), np.float32)
        out[:, :len(v)] = v
        return jnp.asarray(out)

    def dot(self, vec, A, which):
        n, np_ = self.n, self.np
        v = self._vec(np.asarray(vec, np.float32))
        A = np.asarray(A, np.float32)
        if which == "G^T":
            return np.asarray(self._bmv(self._tile(A.T, np_, np_), v))[0, :n]
        if which == "Ct":
            return np.asarray(self._vecmat(v, self._tile(A, np_, self.mp))
                              )[0, :self.m]
        K = np.zeros((np_, 2 * np_), np.float32)
        if which == "K":
            K[:n, :n] = A[:, :n]
            K[:n, np_:np_ + n] = A[:, n:]
        else:
            K[:n, np_:np_ + n] = A
        zr = np.asarray(self._vecmat(v, self._tile(K, np_, 2 * np_)))[0]
        right = zr[np_:np_ + n]
        return np.concatenate([zr[:n], right]) if which == "K" else right

    def sum(self, a, b):
        return np.float32(np.asarray(self._sum(
            self._vec(np.asarray(a, np.float32)),
            self._vec(np.asarray(b, np.float32))))[0, 0])


def _side_states(rec: dict, side: str, caps) -> list[dict]:
    """Each side's whole state at ``caps``: "card" from the card's states
    file, "jax" from :func:`jax_capped`, "plain" from the port's plain
    version on the CPU."""
    if side == "jax":
        return [jax_capped(rec, c) for c in caps]
    if side == "plain":
        t = mc.trajectory(rec["path"], mc.lane_problem(rec, "cpu"),
                          rec["max_iter"], caps, full=True)
        return [{k: v[i] for k, v in t.items()} for i in range(len(caps))]
    got = _card_record(rec)
    idx = [int(np.flatnonzero(got["caps"] == c)[0]) for c in caps]
    return [{k: v[i] for k, v in got["states"].items()} for i in idx]


@functools.cache
def _card_file() -> dict:
    return {(r["file"], r["lane"]): r
            for r in mc.load_lanes(str(CARD_STATES))[0]}


def _card_record(rec: dict) -> dict:
    return _card_file()[(rec["file"], mc.lane_id(rec))]


def _order(rec: dict, side: str):
    return {"card": op_split.K1Order, "plain": op_split.PlainOrder(
        rec["n"], rec["m"])}.get(side) or JaxOrder(rec)


def _replayable(rec: dict, side: str) -> bool:
    """Whether ``op_split.gi_iteration`` replays this side's loop: the
    hole-based loops (K1, K3, their plain versions, the JAX packed
    kernels) and K9's adds, not the JAX pack-1 kernel (K9's counterpart,
    another layout)."""
    return not (rec["path"] == "K9" and side == "jax")


def _vertex_window(rec: dict, lo: int) -> list[int]:
    """The caps from the previous vertex (skip1 = 0) before ``lo`` to
    ``lo``, found on the JAX kernel's shared states."""
    c = lo - 1
    while c > 0 and int(jax_capped(rec, c)["skip1"]):
        c -= 1
    return list(range(max(c, 0), lo + 1))


def split_lane(rec: dict, key: str, side: str) -> dict:
    """``op_split.split_at_parting`` of one side at the parting ``rec[key]``
    (a slack), from the side's states at the previous vertex up to the
    parting's shared state."""
    v = rec[key]
    caps = _vertex_window(rec, v["iteration"] - 1)
    out = op_split.split_at_parting(op_split.f32_data(rec["arrays"]),
                                    _side_states(rec, side, caps),
                                    v["constraint"], _order(rec, side))
    return {"caps": caps, **out}


def _t_split(rec: dict, key: str, side: str) -> dict:
    """A step-choice parting (``t2 <= t1``): the side's f32 t2 - t1 at the
    shared state against the exact iterate's, split into the iteration's
    own rounding (f32 against f64 on the side's f32 state) and the state's
    error (f64 on the f32 state against the exact iterate); ulps of max(|t1|,
    |t2|)."""
    v = rec[key]
    lo = v["iteration"] - 1
    st = _side_states(rec, side, [lo])[0]
    d = op_split.f32_data(rec["arrays"])
    it = op_split.gi_iteration(st, d, _order(rec, side))
    q = _f32_state(rec, dict(st, u=np.asarray(st["u"])[:rec["n"]]),
                   it["sc_idx"], it["sc_status"])
    ex = _exact(rec, st["status"], it["sc_idx"], it["sc_status"])
    us = _ulp(max(abs(ex["t1"]), abs(ex["t2"])))
    own = (float(it["t2"]) - float(it["t1"])) - (q["t2"] - q["t1"])
    state = (q["t2"] - q["t1"]) - (ex["t2"] - ex["t1"])
    return {"caps": [lo], "own_rounding": own / us, "state": state / us,
            "total": (own + state) / us,
            "ops": [op_split.op_roundings(st, it, d, 0)]}


def _lane(which: str, lane: str) -> dict:
    rec = next(r for r in _load(which)[0] if mc.lane_id(r) == lane)
    return dict(rec, file=which)


def _split_job(item):
    which, lane, key, sides = item
    _setup_jax()
    torch.set_num_threads(1)
    rec = _lane(which, lane)
    slack = "constraint" in rec[key] and rec[key]["kind"].startswith(
        "select: slack")
    out = {}
    for side in sides:
        if not _replayable(rec, side):
            out[side] = None
            continue
        out[side] = (split_lane if slack else _t_split)(rec, key, side)
    print(which, lane, key, {s: o and (o.get("split") or {
        k: o[k] for k in ("own_rounding", "state", "total")})
        for s, o in out.items()}, flush=True)
    return which, lane, key, out


def _range_job(item):
    """Over the stage range of a lane where the port misses beyond a tie
    (from the cap where its error stays above the JAX kernel's to the
    parting), each side's iterations replayed and held to its next state,
    each operation's own rounding at every cap, and, at a slack parting,
    ``op_split.range_split`` of the deciding slack."""
    which, lane, key = item
    _setup_jax()
    torch.set_num_threads(1)
    rec = _lane(which, lane)
    v = rec[key]
    lo = v["iteration"] - 1
    caps = list(range(rec[f"{key}_stages"]["port_above_from_cap"], lo + 1))
    slack = v["kind"].startswith("select: slack")
    p = v["constraint"]
    d = op_split.f32_data(rec["arrays"])
    out = {"caps": caps}
    for side in ("card" if key == "verdict" else "plain", "jax"):
        states = _side_states(rec, side, caps)
        order = _order(rec, side)
        its = [op_split.gi_iteration(st, d, order) for st in states]
        ok = sum(op_split.same_next(a, b) for a, b in zip(its, states[1:]))
        got = {"replayed": [int(ok), len(caps) - 1],
               "ops": [op_split.op_roundings(st, it, d, p)
                       for st, it in zip(states[:-1], its[:-1])]}
        if slack:
            x64 = {i: op_split.iterate64(d, st["status"])["x"]
                   for i, st in enumerate(states) if int(st["skip1"]) == 0}
            got["range_split"] = op_split.range_split(
                d, p, float(its[-1]["sel"][p]), states, its, x64)
        out[side] = got
    print(which, lane, key, "range", caps[0], caps[-1],
          {s_: o.get("range_split") for s_, o in out.items()
           if isinstance(o, dict)}, flush=True)
    return which, lane, key, out


def _r(v):
    """``v`` with every float rounded to 2 decimals, for printing."""
    if isinstance(v, dict):
        return {k: _r(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_r(x) for x in v]
    return round(float(v), 2) if isinstance(v, (float, np.floating)) else v


def _median_ops(ops: list[dict], keys=OPS) -> dict:
    return {k: float(np.median([abs(o[k]) for o in ops if k in o]))
            for k in keys if any(k in o for o in ops)}


def split(workers: int) -> dict:
    """Part 2: the split at each 3d and reverse lane (K1 on the card, the
    JAX kernel, the port's plain version on the CPU), over the population
    of slack partings (the card's kernel's and the plain path's), and the
    operations' own rounding over the 3d lanes' stage ranges. Prints every
    number and returns them."""
    recs = {(w, mc.lane_id(r)): r for w in FILES for r in _load(w)[0]}
    items = []
    for (w, lane), r in recs.items():
        for key, side in (("verdict", "card"), ("verdict_cpu", "plain")):
            v = r.get(key)
            if v and (v["kind"].startswith("select: slack") or (
                    w, lane, key) in set(SPLIT_LANES)):
                items.append((w, lane, key, (side, "jax")))
    ranges = [(w, lane, key) for w, lane, key in SPLIT_LANES
              if f"{key}_stages" in recs[(w, lane)]]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        fs = [ex.submit(_split_job, i) for i in items]
        rs = [ex.submit(_range_job, i) for i in ranges]
        got = {(w, lane, key): out for w, lane, key, out in
               (f.result() for f in fs)}
        ranged = {(w, lane, key): out for w, lane, key, out in
                  (f.result() for f in rs)}
    return split_tables(recs, got, ranged)


def _oriented(parts: dict, total: float) -> dict:
    return {k: float(np.sign(total) * parts[k]) for k in PARTS}


def split_tables(recs: dict, got: dict, ranged: dict) -> dict:
    out = {"lanes": {}, "population": {}, "ranges": {}}
    for (w, lane, key), o in sorted(got.items()):
        side = "card" if key == "verdict" else "plain"
        if (w, lane, key) not in {s[:3] for s in SPLIT_LANES}:
            continue
        row = {}
        for s in (side, "jax"):
            if o.get(s) is None:
                row[s] = None
                continue
            if "split" in o[s]:
                row[s] = {**o[s]["split"], "replayed": o[s]["replayed"]}
            else:
                row[s] = {k: o[s][k] for k in ("own_rounding", "state",
                                                "total")}
        if row[side] and row["jax"] and "dot" in row[side]:
            # each part's share of the excess |E_port| - |E_jax|
            a, b = row[side], row["jax"]
            oa, ob = _oriented(a, a["total"]), _oriented(b, b["total"])
            row["excess"] = abs(a["total"]) - abs(b["total"])
            row["excess_by_part"] = {k: oa[k] - ob[k] for k in PARTS}
        out["lanes"][f"{lane} ({key})"] = row
        print("split", lane, key, _r(row))
    for key, side in (("verdict", "card"), ("verdict_cpu", "plain")):
        pop = [(lane, o) for (w, ln, k), o in got.items() if k == key
               for lane in [ln] if o.get(side) and "split" in o[side]
               and o.get("jax") and "split" in o["jax"]]
        rowp = {"slack partings": len(pop)}
        for s in (side, "jax"):
            last = [o[s]["ops"][-2] | {"slack": o[s]["ops"][-1]["slack"]}
                    for _, o in pop]
            rowp[f"{s} median own rounding, last step (ulps)"] = \
                _median_ops(last)
            rowp[f"{s} median |part| (ulps)"] = {
                k: float(np.median([abs(o[s]["split"][k]) for _, o in pop]))
                for k in PARTS + ("total",)}
            rowp[f"{s} replayed"] = [sum(o[s]["replayed"][0] for _, o in pop),
                                     sum(o[s]["replayed"][1] for _, o in pop)]
        rowp["ratio of medians (port / jax)"] = {
            k: rowp[f"{side} median own rounding, last step (ulps)"][k]
            / rowp["jax median own rounding, last step (ulps)"][k]
            for k in rowp["jax median own rounding, last step (ulps)"]
            if rowp["jax median own rounding, last step (ulps)"][k] > 0}
        out["population"][key] = rowp
        print("population", key, _r(rowp))
    for (w, lane, key), o in ranged.items():
        side = "card" if key == "verdict" else "plain"
        row = {"caps": [o["caps"][0], o["caps"][-1]]}
        for s_ in (side, "jax"):
            row[s_] = {"replayed": o[s_]["replayed"],
                       "median own rounding (ulps)": _median_ops(o[s_]["ops"]),
                       "range split (ulps)": o[s_].get("range_split")}
        out["ranges"][f"{lane} ({key})"] = row
        print("range", lane, key, _r(row))
    return out


def report() -> None:
    """The census side by side: per set the lanes drawn, each package's
    misses on its own draws, how many of them the other package passes
    (each lane alone); each side's partings from the JAX kernel, those
    beyond 16 ulps by who misses, and each lane's outcomes and parting."""
    port, psum = _load("port")
    jaxl, jsum = _load("jax")
    spread_table()

    def group(key):
        name = key.split("/")[0]
        return name + (key[key.rindex("/"):] if name == "size_sweep" else "")

    rows = {}
    for key, v in psum.items():
        if isinstance(v, dict):
            r = rows.setdefault(group(key), {})
            r["lanes"] = r.get("lanes", 0) + v["lanes"]
            r["K_card"] = r.get("K_card", 0) + v["kernel_misses"]
            r["plain_card"] = r.get("plain_card", 0) + v["plain_misses"]
    for key, v in jsum.items():
        if not isinstance(v, dict):
            continue
        r = rows.setdefault(group(key), {})
        r["jax_lanes"] = r.get("jax_lanes", 0) + v["lanes"]
        for w in ("jax_pallas", "jax_solve_refined", "port_plain_cpu"):
            r[w] = r.get(w, 0) + v[f"{w}_misses"]
    for recs, who, other in ((port, "kernel_card", "jax_pallas_alone"),
                             (jaxl, "jax_pallas", "kernel_card_alone")):
        for rec in recs:
            if who not in rec["missed_by"]:
                continue
            key = rec["set"] + (f"/n{rec['n']}" if rec["set"] == "size_sweep"
                                else "")
            r = rows[key]
            r[f"{who}_missed_other_passes"] = r.get(
                f"{who}_missed_other_passes", 0) + int(
                    rec["outcomes"].get(other, {}).get("passed", False))
    for key, r in rows.items():
        print(key, r)
    for key, side in (("verdict", "kernel_card_alone"),
                      ("verdict_cpu", "port_plain_cpu_alone")):
        recs = [r for r in port + jaxl if key in r]
        beyond = [r for r in recs if not r[key]["near_tie"]]
        dev = [(r[key]["port_deviation_ulps"], r[key]["jax_deviation_ulps"])
               for r in recs if "port_deviation_ulps" in r[key]]

        def brief(r):
            v = r[key]
            return (mc.lane_id(r), v["kind"][:30], round(v["ulps"], 1),
                    round(v.get("jax_deviation_ulps", float("nan")), 1),
                    round(v.get("port_deviation_ulps", float("nan")), 1))
        print(key, {
            "partings": len(recs),
            "within 16 ulps": len(recs) - len(beyond),
            "beyond, the port misses and the JAX kernel passes": [
                brief(r) for r in beyond
                if not r["outcomes"][side]["passed"]
                and r["outcomes"]["jax_pallas_alone"]["passed"]],
            "beyond, the JAX kernel misses and the port passes": [
                brief(r) for r in beyond
                if r["outcomes"][side]["passed"]
                and not r["outcomes"]["jax_pallas_alone"]["passed"]],
            "beyond, both miss": [
                brief(r) for r in beyond
                if not r["outcomes"][side]["passed"]
                and not r["outcomes"]["jax_pallas_alone"]["passed"]],
            "slack partings": len(dev),
            "port deviation larger": sum(p > j for p, j in dev),
            "median port, jax deviation ulps":
                [float(np.median([d[0] for d in dev])),
                 float(np.median([d[1] for d in dev]))] if dev else None,
            "port, jax deviation ulps, sorted":
                [sorted(round(d[0], 1) for d in dev),
                 sorted(round(d[1], 1) for d in dev)]})
    for which, recs in (("port", port), ("jax", jaxl)):
        for rec in recs:
            o = rec["outcomes"]
            print(which, mc.lane_id(rec), rec["missed_by"],
                  {w: _brief(o[w]) for w in ("kernel_card_alone",
                                             "plain_card_alone",
                                             "jax_pallas_alone",
                                             "jax_solve_refined_alone",
                                             "port_plain_cpu_alone")
                   if w in o},
                  *({k: v[k] for k in ("iteration", "kind", "ulps",
                                       "jax_deviation_ulps",
                                       "port_deviation_ulps", "near_tie")
                     if k in v} for v in (rec.get("verdict", {}),
                                          rec.get("verdict_cpu", {}))))
            for key in ("verdict_stages", "verdict_cpu_stages"):
                if key in rec:
                    print("   ", key, {k: v for k, v in rec[key].items()
                                       if k != "rows"})


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--census", action="store_true")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--verdicts", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--workers", type=int, default=3)
    args = ap.parse_args()
    _setup_jax()
    torch.set_num_threads(1)
    if args.census:
        census(args.workers)
    if args.port:
        port_lanes()
    if args.verdicts:
        verdicts(args.workers)
    if args.stages:
        stages(args.workers)
    if args.spread:
        spread(args.workers)
        spread_table()
    if args.split:
        split(args.workers)
    if args.report:
        report()
