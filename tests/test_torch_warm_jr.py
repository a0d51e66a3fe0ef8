"""The J/R warm start (``solve_warm``) and the explicit-operator
``solve_fast`` / ``solve_fast_warm`` against the JAX package's, vmapped, on
numpy inputs shared by both (f64). ``solve_warm`` is held on x, the
multipliers, status, iterations and active set, not on J and R, whose QR
column signs may differ between the two packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.solver.fast import solve_fast as j_solve_fast
from jrlqp_tpu.solver.fast import solve_fast_warm as j_solve_fast_warm
from jrlqp_tpu.solver.warm_start import solve_warm as j_solve_warm
from jrlqp_tpu.testing import ProblemCharacteristics, random_problem
from jrlqp_tpu_torch import (
    SolverOptions,
    problem_from_numpy,
    solve_batch,
    solve_fast,
    solve_fast_warm,
    solve_warm,
)
from test_torch_dense import _characteristic_sets, _random_batch, jax_batch
from test_torch_dense import assert_results_match

torch.set_num_threads(1)

j_warm = jax.jit(jax.vmap(j_solve_warm, in_axes=(0, 0, None)),
                 static_argnums=2)
j_fast = jax.jit(jax.vmap(j_solve_fast, in_axes=(0, None)), static_argnums=1)
j_fast_warm = jax.jit(jax.vmap(j_solve_fast_warm, in_axes=(0, 0, None)),
                      static_argnums=2)


def _perturbed(hints, m, rng):
    """Per lane: deactivate the first active entry, activate the last
    inactive one (LOWER or LOWER_BOUND), as tests/test_warm_start.py."""
    h = hints.copy()
    for b in range(h.shape[0]):
        act = np.nonzero(h[b] != 0)[0]
        inact = np.nonzero(h[b] == 0)[0]
        if len(act):
            h[b, act[rng.integers(len(act))]] = 0
        if len(inact):
            i = inact[-1]
            h[b, i] = 1 if i < m else 4
    return h


@pytest.mark.parametrize("which", range(5))
@pytest.mark.parametrize("hint", ["exact", "perturbed"])
def test_solve_warm_matches_jax(which, hint):
    _, arrs = _random_batch(_characteristic_sets()[which], range(10, 14))
    pb = problem_from_numpy(**arrs, device="cpu")
    cold = solve_batch(pb, SolverOptions())
    hints = cold.active_set.numpy()
    if hint == "perturbed":
        hints = _perturbed(hints, pb.m, np.random.default_rng(which))
    opt = SolverOptions(warm_start=True)
    ours = solve_warm(pb, torch.from_numpy(hints), opt)
    ref = j_warm(jax_batch(arrs), jnp.asarray(hints), JOptions(warm_start=True))
    assert_results_match(ours, ref)
    if hint == "exact":
        assert bool((ours.iterations == 0).all())
        np.testing.assert_allclose(ours.x.numpy(), cold.x.numpy(), atol=1e-9)


def test_solve_warm_hints_need_the_option():
    _, arrs = _random_batch(ProblemCharacteristics(5, 5).nEq(2), range(3))
    pb = problem_from_numpy(**arrs, device="cpu")
    hints = solve_batch(pb).active_set
    ours = solve_warm(pb, hints, SolverOptions())      # warm_start off
    ref = j_warm(jax_batch(arrs), jnp.asarray(hints.numpy()), JOptions())
    assert_results_match(ours, ref)


@pytest.mark.parametrize("which", range(5))
def test_solve_fast_and_fast_warm_match_jax(which):
    _, arrs = _random_batch(_characteristic_sets()[which], range(20, 24))
    pb = problem_from_numpy(**arrs, device="cpu")
    ours = solve_fast(pb, SolverOptions())
    ref = j_fast(jax_batch(arrs), JOptions())
    assert_results_match(ours, ref, x_tol=1e-10, mult_tol=1e-9)
    hints = _perturbed(ours.active_set.numpy(), pb.m,
                       np.random.default_rng(which))
    opt = SolverOptions(warm_start=True)
    ours_w = solve_fast_warm(pb, torch.from_numpy(hints), opt)
    ref_w = j_fast_warm(jax_batch(arrs), jnp.asarray(hints),
                        JOptions(warm_start=True))
    # the explicit warm init inverts M = N^T G^-1 N, which is ill-conditioned
    # on the sets with bounds, and carries that product's rounding through
    # the operators: the two packages' summation orders part by ~1e-8 there
    assert_results_match(ours_w, ref_w, x_tol=1e-7, mult_tol=1e-6)


def test_fast_warm_from_exact_hints_takes_no_iteration():
    rpbs = [random_problem(ProblemCharacteristics(5, 5).nIneq(8)
                           .nStrongActIneq(4), np.random.default_rng(s))
            for s in range(4)]
    arrs = {k: np.stack([r.to_qp_arrays()[k] for r in rpbs]) for k in
            ("G", "a", "C", "l", "u", "xl", "xu", "objcst")}
    pb = problem_from_numpy(**arrs, device="cpu")
    cold = solve_fast(pb)
    warm = solve_fast_warm(pb, cold.active_set,
                           SolverOptions(warm_start=True))
    assert bool((warm.iterations == 0).all())
    np.testing.assert_allclose(warm.x.numpy(), cold.x.numpy(), atol=1e-9)
