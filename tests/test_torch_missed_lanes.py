"""The lanes that the f32 GI paths miss, held against the other package.

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
Each lane is one case: the JAX package's Pallas kernel in interpret mode
with the path's flags (K1: ``fused_init=True``, K3: ``fused_init=False``,
K9: ``pack=1``), ``vmap(solve_refined)``, and the port's plain path on the
CPU each solve the lane alone and must give the recorded status, iteration
count, active set and pass or fail; where the JAX kernel and the port both
pass, their status, iterations and active set are equal and x is within
1e-7. The size sweep's lanes (n up to 100, ``max_iter`` 500) are in
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
from jrlqp_tpu_torch import problem_from_numpy
from jrlqp_tpu_torch.testing import miss_census as mc
from jrlqp_tpu_torch.testing.kkt import kkt_residual

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


def check_lane(rec: dict) -> None:
    """Each solver on the lane alone gives its recorded outcome; where the
    JAX kernel and the port both pass, they agree."""
    d = lane_arrays(rec)
    got = {w: SOLVERS[w](d, rec)[0] for w in SOLVERS}
    for w, o in got.items():
        want = rec["outcomes"][f"{w}_alone"]
        assert _brief(o) == _brief(want), (w, _brief(o), _brief(want))
        np.testing.assert_array_equal(o["active_set"], want["active_set"],
                                      err_msg=w)
    a, b = got["jax_pallas"], got["port_plain_cpu"]
    if a["passed"] and b["passed"]:
        assert (a["status"], a["iterations"]) == (b["status"],
                                                  b["iterations"])
        np.testing.assert_array_equal(a["active_set"], b["active_set"])
        np.testing.assert_allclose(a["x"], b["x"], rtol=0, atol=X_TOL)


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


def test_missed_lane_against_the_other_package(which, lane):
    check_lane(record(which, lane))


def test_jax_lanes_are_the_jax_draws(seed):
    # the saved arrays are the JAX package's draws: lane i of
    # random_qp_batch(key(seed), 16384, 50, 100, act_frac=0.3), made in
    # f32 and cast to f64 (bench.py:95-97)
    recs = [r for r in lanes("jax")
            if r["set"] != "size_sweep" and r["seed"] == seed]
    pbs = j_random_qp_batch(jax.random.key(seed), mc.BATCH, mc.N, mc.M,
                            act_frac=mc.ACT_FRAC, dtype=jnp.float32)
    idx = np.array([r["lane"] for r in recs])
    drawn = {k: np.asarray(getattr(pbs, k)[idx]).astype(np.float64)
             for k in mc.ARRAYS}
    del pbs
    for j, r in enumerate(recs):
        for k in mc.ARRAYS:
            np.testing.assert_array_equal(r["arrays"][k], drawn[k][j],
                                          err_msg=f"{mc.lane_id(r)} {k}")
