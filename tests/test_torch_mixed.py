"""The mixed-precision solve (``jrlqp_tpu_torch.solve_mixed``: the f32 J/R
solve, then the f64 warm start from its active set) against the JAX
``solve_mixed`` on the two cases of tests/test_mixed.py, batched: the same
status and active set on every lane, x within 1e-9, KKT <= 1e-8 on the
SUCCESS lanes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import QPProblem as JQP
from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.solver.mixed import solve_mixed as j_solve_mixed
from jrlqp_tpu.testing.batch_gen import random_qp_batch as j_random_qp_batch
from jrlqp_tpu_torch import (
    SolverOptions,
    TerminationStatus,
    problem_from_numpy,
    solve_mixed,
)
from jrlqp_tpu_torch.testing import (
    ProblemCharacteristics,
    kkt_residual,
    random_problem,
)

torch.set_num_threads(1)

KEYS = ("G", "a", "C", "l", "u", "xl", "xu", "objcst")


def _random_problems():
    """The ten problems of test_mixed_reaches_f64_accuracy, as one batch,
    with the generator's known solutions."""
    rng = np.random.default_rng(0)
    rpbs = [random_problem(ProblemCharacteristics(5, 5, 2, 6)
                           .nStrongActIneq(3), rng) for _ in range(10)]
    arrs = {k: np.stack([np.asarray(r.to_qp_arrays()[k], np.float64)
                         for r in rpbs]) for k in KEYS}
    return arrs, np.stack([r.x for r in rpbs]), 1000


def _qp_batch():
    """The batch of test_mixed_batch_kkt_residuals (jax key 3), as numpy."""
    pbs = j_random_qp_batch(jax.random.key(3), batch=16, n=12, m=20,
                            act_frac=0.3)
    return {k: np.asarray(getattr(pbs, k)) for k in KEYS}, None, 100


CASES = {"random_problems": _random_problems, "qp_batch": _qp_batch}


@pytest.fixture(scope="module")
def solved():
    """name -> (arrays, known x, port result, JAX result)."""
    out = {}
    for name, make in CASES.items():
        arrs, x_true, max_iter = make()
        ours = solve_mixed(problem_from_numpy(**arrs, device="cpu"),
                           SolverOptions(max_iter=max_iter))
        ref = jax.jit(jax.vmap(lambda p, mi=max_iter: j_solve_mixed(
            p, JOptions(max_iter=mi))))(
                JQP(**{k: jnp.asarray(v) for k, v in arrs.items()}))
        out[name] = (arrs, x_true, ours, ref)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_mixed_matches_jax(solved, name):
    arrs, x_true, ours, ref = solved[name]
    np.testing.assert_array_equal(ours.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(ours.active_set.numpy(),
                                  np.asarray(ref.active_set))
    np.testing.assert_array_equal(ours.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-9, err_msg="x: atol 1e-9")
    assert ours.x.dtype == torch.float64


@pytest.mark.parametrize("name", list(CASES))
def test_mixed_reaches_f64_accuracy(solved, name):
    arrs, x_true, ours, _ = solved[name]
    ok = ours.status == TerminationStatus.SUCCESS
    assert float(ok.double().mean()) >= 0.9
    pb = problem_from_numpy(**arrs, device="cpu")
    resid = kkt_residual(ours.x, ours.multipliers, pb)
    assert float(resid[ok].max()) <= 1e-8, "KKT <= 1e-8 on SUCCESS lanes"
    if x_true is not None:
        # the generator's known solution (test_mixed.py: rtol/atol 1e-6)
        near = np.isclose(ours.x.numpy(), x_true, rtol=1e-6,
                          atol=1e-6).all(axis=1)
        assert int(near.sum()) >= len(near) - 1
