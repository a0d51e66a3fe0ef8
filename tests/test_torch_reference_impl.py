"""The port's numpy executable spec (jrlqp_tpu_torch.reference_impl.solve_np)
against the JAX package's on the cases of tests/test_reference_impl.py: the
same numpy code, so every field is equal bit for bit (tolerance 0). On the
same problems the port's f64 J/R engine lands on the same optimum (x to
1e-8, multipliers to 1e-7 relative + 1e-8, as that file holds the JAX
engine)."""
import numpy as np
import pytest
import torch

from jrlqp_tpu.reference_impl import solve_np as j_solve_np
from jrlqp_tpu.testing import ProblemCharacteristics, random_problem
from jrlqp_tpu_torch import SolverOptions, problem_from_numpy, solve_batch
from jrlqp_tpu_torch.reference_impl import NpResult, solve_np
from jrlqp_tpu_torch.types import NON_POS_HESSIAN, SUCCESS

torch.set_num_threads(1)

STANDALONE = [
    ProblemCharacteristics(5, 5),
    ProblemCharacteristics(5, 5).nEq(2),
    ProblemCharacteristics(5, 5).nIneq(8).nStrongActIneq(4),
    ProblemCharacteristics(5, 5, 2, 6).nStrongActIneq(1).set_bounds(True)
    .nStrongActBounds(2),
]
DIFFERENTIAL = [
    ProblemCharacteristics(6, 6).nIneq(10).nStrongActIneq(3),
    ProblemCharacteristics(6, 6, 2, 8).nStrongActIneq(2),
    ProblemCharacteristics(4, 4).nIneq(6).nStrongActIneq(2).set_bounds(True)
    .nStrongActBounds(1),
]


def _cases():
    """(problem arrays, ground-truth x) of both lists, drawn as
    tests/test_reference_impl.py draws them (numpy seeds 0 and 7)."""
    out = []
    rng = np.random.default_rng(0)
    for c in STANDALONE:
        rpb = random_problem(c, rng)
        out.append((rpb.to_qp_arrays(), rpb.x))
    rng = np.random.default_rng(7)
    for seed in range(6):
        rpb = random_problem(DIFFERENTIAL[seed % 3], rng)
        out.append((rpb.to_qp_arrays(), rpb.x))
    return out


CASES = _cases()


def _args(d):
    return (d["G"], d["a"], d["C"], d["l"], d["u"], d["xl"], d["xu"])


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("k", range(len(CASES)))
def test_solve_np_matches_jax_bitwise(k):
    d, x_true = CASES[k]
    ours, ref = solve_np(*_args(d)), j_solve_np(*_args(d))
    assert isinstance(ours, NpResult)
    for f in ("x", "multipliers", "active_set"):
        _bitwise(getattr(ours, f), getattr(ref, f), f)
    assert (ours.f, ours.iterations, ours.status) == (ref.f, ref.iterations,
                                                      ref.status)
    assert ours.status == SUCCESS
    np.testing.assert_allclose(ours.x, x_true, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", range(len(STANDALONE), len(CASES)))
def test_solve_np_matches_port_jr_engine(k):
    d, _ = CASES[k]
    ours = solve_np(*_args(d))
    pb = problem_from_numpy(**{f: d[f][None] for f in ("G", "a", "C", "l",
                                                        "u", "xl", "xu")},
                            device="cpu")
    res = solve_batch(pb, SolverOptions())
    assert int(res.status[0]) == ours.status == SUCCESS
    np.testing.assert_allclose(ours.x, res.x[0].numpy(), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(ours.multipliers, res.multipliers[0].numpy(),
                               rtol=1e-7, atol=1e-8)


def test_solve_np_non_pos_hessian_matches_jax():
    G = np.diag([1.0, -1.0])
    args = (G, np.ones(2), np.ones((1, 2)), [-1.0], [1.0])
    ours, ref = solve_np(*args), j_solve_np(*args)
    assert ours.status == ref.status == NON_POS_HESSIAN
    _bitwise(ours.x, ref.x, "x")
