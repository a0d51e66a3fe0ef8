"""The dense J/R engine (``jrlqp_tpu_torch.solver.dense``): the cases of
tests/test_solver_dense.py through the port's ``solve_batch`` and the JAX
package's ``solve_batch`` on the same numpy arrays. Status, iterations and
active set equal per lane; x and the multipliers within 1e-10 (f64, the
same algorithm in another summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import QPProblem as JQP
from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu import solve_batch as j_solve_batch
from jrlqp_tpu.problems import pad_problem as j_pad_problem
from jrlqp_tpu.problems import stack_problems as j_stack_problems
from jrlqp_tpu.testing import ProblemCharacteristics, random_problem
from jrlqp_tpu_torch import (
    SolverOptions,
    TerminationStatus,
    no_retrace,
    pad_problem,
    problem_from_numpy,
    result_to_numpy,
    solve,
    solve_batch,
    stack_problems,
)
from jrlqp_tpu_torch.testing.kkt import kkt_residual

torch.set_num_threads(1)

j_solve_batch_jit = jax.jit(j_solve_batch, static_argnames=("opt",))


def np_problem(pb):
    """numpy f64 arrays of a batched JAX problem."""
    return {k: np.asarray(getattr(pb, k)) for k in
            ("G", "a", "C", "l", "u", "xl", "xu", "objcst")}


def jax_batch(arrs):
    return JQP(**{k: jnp.asarray(v) for k, v in arrs.items()})


def assert_results_match(ours, ref, x_tol=1e-10, mult_tol=1e-10,
                         check_iterations=True):
    """Per lane: status, iterations and active set equal; x and the
    multipliers within the tolerances."""
    np.testing.assert_array_equal(ours.status.numpy(), np.asarray(ref.status))
    if check_iterations:
        np.testing.assert_array_equal(ours.iterations.numpy(),
                                      np.asarray(ref.iterations))
    np.testing.assert_array_equal(ours.active_set.numpy(),
                                  np.asarray(ref.active_set))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=x_tol)
    np.testing.assert_allclose(ours.multipliers.numpy(),
                               np.asarray(ref.multipliers), rtol=0,
                               atol=mult_tol)


def both(arrs, opt_kw=None):
    """(port result, JAX result) of the batch ``arrs``."""
    opt_kw = opt_kw or {}
    ours = solve_batch(problem_from_numpy(**arrs, device="cpu"),
                       SolverOptions(**opt_kw))
    ref = j_solve_batch_jit(jax_batch(arrs), JOptions(**opt_kw))
    return ours, ref


def _one(**kw):
    """A batch of one from per-problem arrays."""
    B = {k: np.asarray(v, np.float64)[None] for k, v in kw.items()}
    B.setdefault("objcst", np.zeros(1))
    return B


def paper_problem():
    return _one(G=[[4.0, -2.0], [-2.0, 4.0]], a=[6.0, 0.0], C=[[1.0, 1.0]],
                l=[2.0], u=[10.0], xl=[0.0, 0.0], xu=[10.0, 10.0])


def test_simple_problem_paper():
    ours, ref = both(paper_problem())
    assert_results_match(ours, ref)
    np.testing.assert_allclose(ours.x[0].numpy(), [0.5, 1.5], atol=1e-10)
    pb = problem_from_numpy(**paper_problem(), device="cpu")
    assert float(kkt_residual(ours.x, ours.multipliers, pb)[0]) < 1e-10


def test_unconstrained_and_one_active():
    rng = np.random.default_rng(0)
    C = rng.uniform(-1, 1, (5, 3))
    base = dict(G=np.eye(3), a=np.zeros(3), C=C, l=-np.ones(5), u=np.ones(5),
                xl=np.full(3, -np.inf), xu=np.full(3, np.inf))
    l2, u2 = base["l"].copy(), base["u"].copy()
    l2[1], u2[1] = -2.0, -1.0           # force an active constraint
    arrs = {k: np.stack([np.asarray(v, np.float64), np.asarray(
        dict(base, l=l2, u=u2)[k], np.float64)]) for k, v in base.items()}
    arrs["objcst"] = np.zeros(2)
    ours, ref = both(arrs)
    assert_results_match(ours, ref)
    np.testing.assert_allclose(ours.x[0].numpy(), 0.0, atol=1e-12)
    assert int(ours.iterations[1]) >= 1


def _characteristic_sets():
    return [
        ProblemCharacteristics(5, 5),
        ProblemCharacteristics(5, 5).nEq(2),
        ProblemCharacteristics(5, 5).nIneq(8).nStrongActIneq(4),
        ProblemCharacteristics(5, 5, 2, 6).nStrongActIneq(3),
        ProblemCharacteristics(5, 5, 2, 6).nStrongActIneq(1)
        .set_bounds(True).nStrongActBounds(2),
    ]


def _random_batch(characs, seeds):
    rpbs = [random_problem(characs, np.random.default_rng(s)) for s in seeds]
    arrs = {k: np.stack([r.to_qp_arrays()[k] for r in rpbs]).astype(
        np.float64) for k in ("G", "a", "C", "l", "u", "xl", "xu", "objcst")}
    return rpbs, arrs


@pytest.mark.parametrize("which", range(5))
def test_random_problems_ground_truth(which):
    rpbs, arrs = _random_batch(_characteristic_sets()[which], range(4))
    ours, ref = both(arrs)
    assert_results_match(ours, ref)
    assert bool((ours.status == TerminationStatus.SUCCESS).all())
    for b, rpb in enumerate(rpbs):
        np.testing.assert_allclose(ours.x[b].numpy(), rpb.x, rtol=1e-6,
                                   atol=1e-6)


def test_infeasible_detection():
    ours, ref = both(_one(G=np.eye(2), a=np.zeros(2),
                          C=[[1.0, 0.0], [1.0, 0.0]], l=[1.0, -np.inf],
                          u=[np.inf, -1.0], xl=np.full(2, -np.inf),
                          xu=np.full(2, np.inf)))
    assert_results_match(ours, ref)
    assert int(ours.status[0]) == int(TerminationStatus.INFEASIBLE)


def test_non_pos_hessian():
    ours, ref = both(_one(G=[[1.0, 0.0], [0.0, -1.0]], a=np.zeros(2),
                          C=np.zeros((1, 2)), l=[-np.inf], u=[np.inf],
                          xl=np.full(2, -np.inf), xu=np.full(2, np.inf)))
    assert_results_match(ours, ref)
    assert int(ours.status[0]) == int(TerminationStatus.NON_POS_HESSIAN)


def test_equality_constraints_auto_activation():
    rpbs, arrs = _random_batch(ProblemCharacteristics(6, 6).nEq(3), [3, 4])
    ours, ref = both(arrs)
    assert_results_match(ours, ref)
    cx = np.einsum("bij,bj->bi", arrs["C"], ours.x.numpy())[:, :3]
    np.testing.assert_allclose(cx, arrs["l"][:, :3], atol=1e-8)


def test_fixed_variables():
    ours, ref = both(_one(G=2.0 * np.eye(3), a=np.ones(3), C=np.zeros((1, 3)),
                          l=[-np.inf], u=[np.inf],
                          xl=[0.7, -np.inf, -np.inf], xu=[0.7, np.inf, np.inf]))
    assert_results_match(ours, ref)
    np.testing.assert_allclose(ours.x[0].numpy(), [0.7, -0.5, -0.5],
                               atol=1e-10)


def test_batched_heterogeneous_padded():
    # the port's batch from the port's stack_problems, the JAX one from the
    # JAX package's; both give the same arrays
    rng = np.random.default_rng(7)
    jpbs, tpbs = [], []
    for characs in _characteristic_sets() * 2:
        d = random_problem(characs, rng).to_qp_arrays()
        jpbs.append(JQP(**{k: jnp.asarray(v) for k, v in d.items()}))
        tpbs.append(problem_from_numpy(**{k: np.asarray(v)[None]
                                          for k, v in d.items()},
                                       device="cpu"))
    arrs = np_problem(j_stack_problems(jpbs))
    pb = stack_problems(tpbs)
    for k, v in result_to_numpy(pb).items():
        assert v.tobytes() == arrs[k].tobytes(), k
    ours = solve_batch(pb, SolverOptions())
    ref = j_solve_batch_jit(jax_batch(arrs), JOptions())
    assert_results_match(ours, ref)
    assert float(kkt_residual(ours.x, ours.multipliers, pb).max()) < 1e-8


def test_multiple_uses_no_retrace():
    # many problems of one padded shape and of several shapes, after one
    # warm-up, build and load nothing (the JAX test's no-recompile check)
    rng = np.random.default_rng(42)

    def run_one(characs, n_pad=5, m_pad=10):
        d = random_problem(characs, rng).to_qp_arrays()
        jpb = j_pad_problem(JQP(**{k: jnp.asarray(v) for k, v in d.items()}),
                            n_pad, m_pad)
        arrs = {k: np.asarray(v)[None] for k, v in np_problem(jpb).items()}
        pb = pad_problem(problem_from_numpy(
            **{k: np.asarray(v)[None] for k, v in d.items()}, device="cpu"),
            n_pad, m_pad)
        for k, v in result_to_numpy(pb).items():
            assert v.tobytes() == arrs[k].tobytes(), k
        res = solve(pb)
        assert int(res.status[0]) == int(TerminationStatus.SUCCESS)
        ref = j_solve_batch_jit(jax_batch(arrs), JOptions())
        assert_results_match(res, ref)

    sets = _characteristic_sets()
    run_one(sets[0])
    with no_retrace():
        for characs in sets[1:]:
            run_one(characs)
        run_one(sets[0], n_pad=7, m_pad=12)


def test_no_retrace_raises_on_a_build():
    from jrlqp_tpu_torch.utils import spans

    # a build bumps the counter ``library.load`` of the registry, which
    # ``no_retrace`` reads; it is set back afterwards for every later reader
    # in the process
    try:
        with pytest.raises(AssertionError, match="no_retrace"):
            with no_retrace():
                spans.count("library.load")  # stands for a build inside it
    finally:
        spans.count("library.load", -1)
