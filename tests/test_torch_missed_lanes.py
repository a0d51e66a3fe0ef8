"""The lanes that the f32 GI paths miss, held to the card and to what every
CPU host reproduces.

Two files of lanes, in the layout of ``jrlqp_tpu_torch.testing.
miss_census`` (f64 arrays and recorded outcomes per lane):

- ``tests/data/missed_lanes_port.npz``: every lane of the census sets that
  the port's kernel (K1, K3 or K9) or its plain version misses on an H100
  (``python3 -m jrlqp_tpu_torch.testing.miss_census``), with the outcomes
  of the JAX package on the same arrays added;
- ``tests/data/missed_lanes_jax.npz``: every lane of the same sets, drawn
  by the JAX package from ``jax.random.key(seed)``, that the JAX package
  (the Pallas kernel in interpret mode with the path's flags, or
  ``solve_refined``) or the port's plain version on the CPU misses, with
  the card's outcomes added by ``miss_census --jax-lanes``.

A lane misses when it does not end SUCCESS with ``kkt_residual <= 1e-8``.
These lanes are f32 near-ties and accumulated-error partings: which side
of a tie an f32 sum lands on depends on the order in which the host's
BLAS and XLA's CPU code generation add it, so the CPU outcomes recorded in
the files (``*_alone``) are one host's rounding. They stay in the files as
data; each case checks what does not depend on the host:

- (a) a K1 lane: ``testing.k1_replay.k1_order_solve``, K1's whole solve
  replayed in K1's own order, gives the card's recorded
  ``kernel_card_alone`` (status, iterations, pass or fail, active set): the
  card's outcome on any host;
- (b) every lane, each CPU solver -- the JAX package's Pallas kernel in
  interpret mode with the path's flags (K1: ``fused_init=True``, K3:
  ``fused_init=False``, K9: ``pack=1``), ``vmap(solve_refined)`` and the
  port's plain path on the CPU, each on the lane alone: where it passes,
  its x is within 1e-7 of the lane's f64 solution (the port's
  ``dense.solve_batch`` on the CPU, itself held to the card's f64 J/R
  outcome ``f64_jr_card`` where the record has one); where one misses,
  ``solve_refined_kernel_rescued`` on the CPU passes the lane; where the
  JAX kernel and the port both pass, they agree on status, iterations and
  active set, and x within 1e-7.

The K3 and K9 lanes get (b) only: their cold init is batched
``torch.linalg`` on the card, which no order-exact replay reaches
(chip_smoke phase 20 holds them to their card records). Whether this host
reproduces each recorded CPU outcome is recorded per case
(``record_property("reproduces_record", ...)``), not asserted. Exact ties
(a tied selection, t2 == t1) never occur on these random lanes, so a QP
whose ties are exact in f32 holds every solver of every path to the
reference's rules: the lowest index, and a full step on t2 <= t1. The size
sweep's lanes (n up to 100, ``max_iter`` 500) are in
``tests/test_torch_missed_lanes_sweep.py``. Both files must be present: a
missing one fails the collection. ``tests/missed_lanes_census.py`` makes
them and their verdicts.
"""
from __future__ import annotations

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.problems import QPProblem as JQP
from jrlqp_tpu.solver.fast import solve_refined as j_solve_refined
from jrlqp_tpu.solver.fast import solve_refined_pallas
from jrlqp_tpu.testing.batch_gen import random_qp_batch as j_random_qp_batch
from jrlqp_tpu_torch import (
    SolverOptions,
    problem_from_numpy,
    solve_batch,
    solve_refined_kernel_rescued,
)
from jrlqp_tpu_torch.testing import miss_census as mc
from jrlqp_tpu_torch.testing.k1_replay import k1_order_solve
from jrlqp_tpu_torch.testing.kkt import kkt_residual
from test_torch_k1_replay import tie_qp

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"
FILES = {"port": DATA / "missed_lanes_port.npz",
         "jax": DATA / "missed_lanes_jax.npz"}

# each path's Pallas counterpart (jrlqp_tpu/solver/fast.py:687-750)
JAX_FLAGS = {"K1": {"fused_init": True}, "K3": {"fused_init": False},
             "K9": {"pack": 1}}
X_TOL = 1e-7


def jax_problem(d):
    B = d["G"].shape[0]
    return JQP(**{k: jnp.asarray(d[k]) for k in mc.ARRAYS},
               objcst=jnp.zeros((B,), d["G"].dtype))


def _np_outcomes(res, d) -> list[dict]:
    """Per-lane outcomes of a JAX or torch result on the arrays ``d``, the
    KKT residual by the port's oracle in f64."""
    def arr(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    r = {k: arr(getattr(res, k)) for k in ("x", "multipliers", "status",
                                           "iterations", "active_set")}
    kkt = kkt_residual(torch.from_numpy(r["x"].astype(np.float64)),
                       torch.from_numpy(r["multipliers"].astype(np.float64)),
                       problem_from_numpy(**d, device="cpu")).numpy()
    return [{"status": int(r["status"][i]),
             "iterations": int(r["iterations"][i]), "kkt": float(kkt[i]),
             "passed": bool(r["status"][i] == 0 and kkt[i] <= mc.GATE),
             "active_set": r["active_set"][i].astype(np.int8),
             "x": r["x"][i].astype(np.float64)}
            for i in range(len(kkt))]


def solve_jax_pallas(d, path, max_iter, ir_steps) -> list[dict]:
    return _np_outcomes(solve_refined_pallas(
        jax_problem(d), JOptions(max_iter=max_iter), ir_steps=ir_steps,
        interpret=True, **JAX_FLAGS[path]), d)


def solve_jax_refined(d, max_iter, ir_steps) -> list[dict]:
    return _np_outcomes(jax.vmap(lambda p: j_solve_refined(
        p, JOptions(max_iter=max_iter), ir_steps=ir_steps))(jax_problem(d)),
        d)


def solve_port_plain(d, path, max_iter, ir_steps) -> list[dict]:
    return _np_outcomes(mc.solve_path(
        path, problem_from_numpy(**d, device="cpu"), max_iter, ir_steps), d)


def solve_port_f64(d, max_iter) -> list[dict]:
    """The f64 J/R engine on the CPU: the lane's f64 solution."""
    return _np_outcomes(solve_batch(problem_from_numpy(**d, device="cpu"),
                                    SolverOptions(max_iter=max_iter)), d)


def solve_port_rescued(d, max_iter, ir_steps) -> list[dict]:
    return _np_outcomes(solve_refined_kernel_rescued(
        problem_from_numpy(**d, device="cpu"),
        SolverOptions(max_iter=max_iter), ir_steps=ir_steps), d)


SOLVERS = {"jax_pallas": lambda d, r: solve_jax_pallas(
               d, r["path"], r["max_iter"], r["ir_steps"]),
           "jax_solve_refined": lambda d, r: solve_jax_refined(
               d, r["max_iter"], r["ir_steps"]),
           "port_plain_cpu": lambda d, r: solve_port_plain(
               d, r["path"], r["max_iter"], r["ir_steps"])}


def lane_arrays(rec) -> dict:
    return {k: rec["arrays"][k][None] for k in mc.ARRAYS}


def _brief(o: dict) -> tuple:
    return (o["status"], o["iterations"], o["passed"])


def check_solvers(got: dict, d: dict, rec: dict) -> None:
    """(b): every CPU solver of ``got`` that passes is within 1e-7 of the
    lane's f64 solution; if one misses, the rescue passes the lane; where
    the JAX kernel and the port both pass, they agree."""
    f64 = solve_port_f64(d, rec["max_iter"])[0]
    assert f64["passed"], ("f64", f64["status"], f64["kkt"])
    card = rec["outcomes"].get("f64_jr_card")
    if card is not None:
        assert card["passed"] and f64["status"] == card["status"]
        np.testing.assert_allclose(f64["x"], card["x"], rtol=0, atol=X_TOL,
                                   err_msg="f64 J/R: CPU against the card")
    for w, o in got.items():
        if o["passed"]:
            np.testing.assert_allclose(o["x"], f64["x"], rtol=0, atol=X_TOL,
                                       err_msg=w)
    if not all(o["passed"] for o in got.values()):
        res = solve_port_rescued(d, rec["max_iter"], rec["ir_steps"])[0]
        assert res["status"] == 0 and res["kkt"] <= mc.GATE, (
            "rescue", res["status"], res["kkt"])
    a, b = got["jax_pallas"], got["port_plain_cpu"]
    if a["passed"] and b["passed"]:
        assert (a["status"], a["iterations"]) == (b["status"],
                                                  b["iterations"])
        np.testing.assert_array_equal(a["active_set"], b["active_set"])
        np.testing.assert_allclose(a["x"], b["x"], rtol=0, atol=X_TOL)


def check_lane(rec: dict, record_property) -> None:
    """(a) a K1 lane's order-exact replay gives the card's outcome; (b)
    each CPU solver on the lane alone passes near the f64 solution or is
    rescued, and the JAX kernel and the port agree where both pass. Which
    recorded CPU outcomes this host reproduces goes to
    ``record_property``."""
    if rec["path"] == "K1":
        rep = k1_order_solve(rec["arrays"], rec["max_iter"],
                             rec["ir_steps"])["outcome"]
        want = rec["outcomes"]["kernel_card_alone"]
        assert _brief(rep) == _brief(want), (_brief(rep), _brief(want))
        np.testing.assert_array_equal(rep["active_set"], want["active_set"])
    d = lane_arrays(rec)
    got = {w: SOLVERS[w](d, rec)[0] for w in SOLVERS}
    check_solvers(got, d, rec)
    record_property("reproduces_record", {
        w: mc.same_outcome(o, rec["outcomes"][f"{w}_alone"])
        for w, o in got.items()})


@functools.cache
def lanes(which: str) -> list[dict]:
    """The lane records of ``FILES[which]`` (FileNotFoundError if it is
    missing)."""
    return mc.load_lanes(str(FILES[which]))[0]


def record(which: str, lane: str) -> dict:
    return next(r for r in lanes(which) if mc.lane_id(r) == lane)


def lane_cases(sweep: bool) -> list:
    """One case per saved lane of both files: the size sweep's, or the
    other sets'."""
    return [pytest.param(which, mc.lane_id(r), id=f"{which}-{mc.lane_id(r)}")
            for which in FILES for r in lanes(which)
            if (r["set"] == "size_sweep") == sweep]


def pytest_generate_tests(metafunc):
    # the cases are read from the files at collection, not at import, so
    # that the census script can import the solvers above while it writes
    # the files anew
    if metafunc.function is test_missed_lane_against_the_other_package:
        metafunc.parametrize("which, lane", lane_cases(sweep=False))
    elif metafunc.function is test_jax_lanes_are_the_jax_draws:
        metafunc.parametrize("seed", sorted({
            r["seed"] for r in lanes("jax") if r["set"] != "size_sweep"}))


def test_missed_lane_against_the_other_package(which, lane,
                                              record_property):
    check_lane(record(which, lane), record_property)


@pytest.mark.parametrize("path", list(JAX_FLAGS))
def test_exact_ties_resolve_as_the_reference(path):
    # a QP whose selection and step lengths tie exactly in f32
    # (test_torch_k1_replay.tie_qp): every solver of every path takes the
    # lowest index and the full step, as the JAX package does
    d = {k: v[None] for k, v in tie_qp().items()}
    rec = {"path": path, "max_iter": 20, "ir_steps": 1}
    for w, solve in SOLVERS.items():
        o = solve(d, rec)[0]
        assert (o["status"], o["iterations"], o["passed"]) == (0, 2, True), w
        assert o["active_set"].tolist() == [1, 1, 0, 0], w
        np.testing.assert_array_equal(o["x"], [1.0, 1.0], err_msg=w)


# how far this host's f32 draw of a saved lane may lie from the saved one,
# in f32 ulps: jax.random's polynomials and XLA's dots round otherwise with
# and without FMA (up to 2 ulps of the array's largest |element|, and up to
# 3 ulps of max(|element|, term_floor) per element, under a no-FMA ISA
# setting). An entry that cancels to near 0 (an off-diagonal of G, a bound
# near 0) keeps the error of the sum that made it, so its own ulps (up to
# 5323) measure nothing of the draw; term_floor gives the sum's size
DRAW_ULPS = 8


def f32_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance between two f32 arrays in their elements' own
    units in the last place (0 for equal infinities)."""
    def ordered(v):
        i = v.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max(initial=0))


def term_floor(k: str, arrays: dict):
    """For each element of array ``k`` of a draw (batch_gen.random_qp_batch),
    a bound of the sum of |terms| that made it, from the draw itself; 0 for
    an element drawn alone. G = A Aᵀ/n + I: Σ_k |A_ik A_jk|/n is at most
    sqrt((G_ii - 1)(G_jj - 1)) (Cauchy-Schwarz). l and u are C x0 less or
    plus an offset, |x0| < 1: Σ_k |C_ik x0_k| is at most Σ_k |C_ik|."""
    if k == "G":
        d = np.sqrt(np.abs(np.diagonal(arrays["G"]) - 1.0))
        return np.outer(d, d)
    if k in ("l", "u"):
        return np.abs(arrays["C"]).sum(-1)
    return 0.0


def draw_ulps(saved: np.ndarray, drawn: np.ndarray, floor=None) -> float:
    """The largest distance between two f32 draws of one array over its
    finite elements, each in f32 ulps of max(|element|, ``floor``) (by
    default the array's largest finite |element|); their infinities must
    be equal."""
    fin = np.isfinite(saved)
    np.testing.assert_array_equal(np.isfinite(drawn), fin)
    np.testing.assert_array_equal(saved[~fin], drawn[~fin])
    if not fin.any():
        return 0.0
    if floor is None:
        floor = np.abs(saved[fin]).max()
    mag = np.broadcast_to(np.maximum(np.abs(saved), floor), saved.shape)
    ulp = np.spacing(mag[fin].astype(np.float32)).astype(np.float64)
    return float((np.abs(saved[fin].astype(np.float64) - drawn[fin])
                  / ulp).max())


def test_jax_lanes_are_the_jax_draws(seed, record_property):
    # the saved arrays are the JAX package's draws: lane i of
    # random_qp_batch(key(seed), 16384, 50, 100, act_frac=0.3), made in
    # f32 and cast to f64 (bench.py:95-97), held to this host's draw of
    # lane i within DRAW_ULPS; lane i + 1's draw is O(1) away
    recs = [r for r in lanes("jax")
            if r["set"] != "size_sweep" and r["seed"] == seed]
    pbs = j_random_qp_batch(jax.random.key(seed), mc.BATCH, mc.N, mc.M,
                            act_frac=mc.ACT_FRAC, dtype=jnp.float32)
    idx = np.array([r["lane"] for r in recs])
    drawn = {k: np.asarray(getattr(pbs, k)[idx]) for k in mc.ARRAYS}
    other = {k: np.asarray(getattr(pbs, k)[(idx + 1) % mc.BATCH])
             for k in ("G", "a", "C")}
    del pbs
    worst, worst_term, worst_el = 0.0, 0.0, 0
    for j, r in enumerate(recs):
        f32 = {k: r["arrays"][k].astype(np.float32) for k in mc.ARRAYS}
        for k, saved in f32.items():
            np.testing.assert_array_equal(saved.astype(np.float64),
                                          r["arrays"][k],
                                          err_msg=f"{mc.lane_id(r)} {k}: "
                                                  f"not an f32 draw")
            ulps = draw_ulps(saved, drawn[k][j])
            assert ulps <= DRAW_ULPS, f"{mc.lane_id(r)} {k}: {ulps} ulps"
            per_el = draw_ulps(saved, drawn[k][j], term_floor(k, f32))
            assert per_el <= DRAW_ULPS, (
                f"{mc.lane_id(r)} {k}: {per_el} ulps of an element's sum")
            worst = max(worst, ulps)
            worst_term = max(worst_term, per_el)
            worst_el = max(worst_el, f32_ulps(saved, drawn[k][j]))
        for k, v in other.items():
            assert np.abs(r["arrays"][k] - v[j]).max() > 0.1, (
                f"{mc.lane_id(r)} {k}: the next lane's draw is as near")
    record_property("max_draw_ulps", worst)
    record_property("max_term_ulps", worst_term)
    record_property("max_elementwise_ulps", worst_el)
