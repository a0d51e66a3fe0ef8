"""The f64 rescue of failed lanes: ``solve_refined_kernel_rescued`` against
``solve_refined_pallas_rescued(..., interpret=True)`` on the cases of
tests/test_rescue.py (inputs drawn by the JAX generator, passed through
numpy), and HS268 / S268 of the vendored Maros-Meszaros files, where the
f32 path alone stops at KKT 2.4e-6 and the rescue goes green."""
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.io.qps import read_qps
from jrlqp_tpu.solver.fast import _batch_kkt as j_batch_kkt
from jrlqp_tpu.solver.fast import solve_refined_pallas as j_refined
from jrlqp_tpu.solver.fast import (
    solve_refined_pallas_rescued as j_rescued,
)
from jrlqp_tpu.testing.batch_gen import random_qp_batch
from jrlqp_tpu_torch import (
    SolverOptions,
    problem_from_numpy,
    solve_refined_kernel_rescued,
)
from jrlqp_tpu_torch.ops.cuda import gi_kernel
from jrlqp_tpu_torch.solver import fast
from jrlqp_tpu_torch.testing.kkt import kkt_residual

torch.set_num_threads(1)

QPS = pathlib.Path(__file__).resolve().parent / "data" / "qps"
FIELDS = ("G", "a", "C", "l", "u", "xl", "xu", "objcst")


def _arrs(jpbs):
    return {k: np.asarray(getattr(jpbs, k)) for k in FIELDS}


def _key2():
    return random_qp_batch(jax.random.key(2), 24, 12, 24, act_frac=0.95), 120


def _key3():
    return random_qp_batch(jax.random.key(3), 8, 8, 14, act_frac=0.2), 100


def _key4():
    # lane 2: two nearly equal rows, both active at the same bound
    jpbs = random_qp_batch(jax.random.key(4), 6, 10, 20, act_frac=0.4)
    C, l, u = (np.array(getattr(jpbs, k)) for k in ("C", "l", "u"))
    C[2, 1] = C[2, 0] * (1 + 1e-7)
    l[2, 1], u[2, 1] = l[2, 0], u[2, 0]
    return dataclasses.replace(jpbs, C=jax.numpy.asarray(C),
                               l=jax.numpy.asarray(l),
                               u=jax.numpy.asarray(u)), 100


def _key3_infeasible():
    # lane 1: x_0-row >= 1 and the same row <= -1, the dense test's case
    jpbs, max_iter = _key3()
    C, l, u = (np.array(getattr(jpbs, k)) for k in ("C", "l", "u"))
    C[1, 1] = C[1, 0]
    l[1, 0], u[1, 0] = 1.0, np.inf
    l[1, 1], u[1, 1] = -np.inf, -1.0
    return dataclasses.replace(jpbs, C=jax.numpy.asarray(C),
                               l=jax.numpy.asarray(l),
                               u=jax.numpy.asarray(u)), max_iter


def _failed_lanes(res, resid, tol=1e-8):
    return set(np.nonzero((np.asarray(resid) > tol)
                          | (np.asarray(res.status) != 0))[0].tolist())


@pytest.mark.parametrize("case", [_key2, _key3, _key4, _key3_infeasible],
                         ids=["key2_act95", "key3_clean", "key4_injected",
                              "key3_infeasible_lane"])
def test_rescue_matches_jax(case):
    jpbs, max_iter = case()
    arrs = _arrs(jpbs)
    jopt = JOptions(max_iter=max_iter)
    opt = SolverOptions(max_iter=max_iter)
    pb = problem_from_numpy(**arrs, device="cpu")
    # the same lanes fail the first stage in both packages
    first = fast._solve_refined_from_init(pb, opt, 3, gi_kernel.run_loop)
    j_first = j_refined(jpbs, jopt, interpret=True)
    bad = _failed_lanes(first, kkt_residual(first.x, first.multipliers, pb))
    j_bad = _failed_lanes(j_first, j_batch_kkt(jpbs, j_first.x,
                                               j_first.multipliers))
    assert bad == j_bad
    res = solve_refined_kernel_rescued(pb, opt)
    ref = j_rescued(jpbs, jopt, interpret=True)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    # the infeasible lane's iteration count is not held: its two rows are
    # exact duplicates, so its degenerate steps (z ~ 0 against the zero-z
    # threshold) turn on rounding, and each engine of either package counts
    # its own number of them before it finds INFEASIBLE
    ok = res.status == 0
    np.testing.assert_array_equal(res.iterations.numpy()[ok.numpy()],
                                  np.asarray(ref.iterations)[ok.numpy()])
    assert int(ok.sum()) == pb.batch - (case is _key3_infeasible)
    assert float(kkt_residual(res.x, res.multipliers, pb)[ok].max()) <= 1e-8
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-8)
    if not bad:   # no failed lane: the first stage's result, unchanged
        for f in dataclasses.fields(res):
            assert torch.equal(getattr(res, f.name), getattr(first, f.name))
    if case is _key3_infeasible:     # rescued in f64, still infeasible
        assert bad == {1} and int(res.status[1]) == 3
        assert int(res.iterations[1]) > int(first.iterations[1])


@pytest.mark.parametrize("name", ["HS268", "S268"])
def test_hs268_s268_go_green_through_the_rescue(name):
    """f* = 5.7310705e-07 (corpus.json's pallas_rescued rows); the f32 path
    alone ends SUCCESS with KKT 2.4e-6 there."""
    q = read_qps(str(QPS / f"{name}.QPS"), engine="python")
    arrs = {k: np.asarray(getattr(q, k), np.float64)[None] for k in FIELDS}
    pb = problem_from_numpy(**arrs, device="cpu")
    opt = SolverOptions(max_iter=200)
    first = fast._solve_refined_from_init(pb, opt, 4, gi_kernel.run_loop)
    assert float(kkt_residual(first.x, first.multipliers, pb)[0]) > 1e-8
    res = solve_refined_kernel_rescued(pb, opt, ir_steps=4)
    assert int(res.status[0]) == 0
    assert float(kkt_residual(res.x, res.multipliers, pb)[0]) <= 1e-8
    assert abs(float(res.f[0]) + float(q.objcst) - 5.7310705e-07) <= 1e-6
