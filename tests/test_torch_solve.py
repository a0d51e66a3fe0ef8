"""The port's main path ``solve_refined_kernel`` (plain K1 on the CPU, then
f64 refinement) against ``solve_refined_pallas(..., fused_init=True)`` in
interpret mode, on the batches of test_torch_gi_kernel.py; and its
``fused_init=False`` branch (the torch cold init, then plain K3) against
``solve_refined_pallas(..., fused_init=False)``."""
import inspect

import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.solver.fast import solve_refined_pallas
from jrlqp_tpu_torch import (
    SolverOptions,
    TerminationStatus,
    problem_from_numpy,
    result_to_numpy,
    solve_refined_kernel,
)
from jrlqp_tpu_torch.testing.batch_gen import random_qp_batch
from jrlqp_tpu_torch.testing.kkt import kkt_residual
from test_torch_card import CASES, make_case
from test_torch_gi_kernel import jax_problem

torch.set_num_threads(1)


def _solve_both(d, max_iter, validate=False):
    ref = solve_refined_pallas(
        jax_problem(d), JOptions(max_iter=max_iter, validate=validate),
        ir_steps=1, interpret=True, pack=4, fused_init=True)
    pb = problem_from_numpy(**d, device="cpu")
    res = solve_refined_kernel(
        pb, SolverOptions(max_iter=max_iter, validate=validate), ir_steps=1)
    return ref, res, pb


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_pallas_interpret(name):
    d, max_iter = make_case(name)
    ref, res, pb = _solve_both(d, max_iter)
    ours = result_to_numpy(res)
    np.testing.assert_array_equal(ours["status"], np.asarray(ref.status))
    np.testing.assert_array_equal(ours["iterations"],
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(ours["active_set"],
                                  np.asarray(ref.active_set))
    # both engines refine to <= 1e-8 KKT; accumulation order differs
    np.testing.assert_allclose(ours["x"], np.asarray(ref.x), atol=1e-7)
    np.testing.assert_allclose(ours["multipliers"],
                               np.asarray(ref.multipliers), atol=1e-6)
    ok = res.status == 0
    resid = kkt_residual(res.x, res.multipliers, pb)
    assert bool((resid[ok] <= 1e-8).all()), resid.numpy()
    assert ok.any()


def test_validate_flags_inverted_bounds():
    d, max_iter = make_case("n8_m12")
    d["l"][1, 4] = d["u"][1, 4] + 1.0          # lane 1: l > u
    ref, res, _ = _solve_both(d, max_iter, validate=True)
    st = res.status.numpy()
    assert st[1] == int(TerminationStatus.INCONSISTENT_INPUT)
    np.testing.assert_array_equal(st, np.asarray(ref.status))
    _, res_off, _ = _solve_both(d, max_iter, validate=False)
    assert res_off.status[1] != int(TerminationStatus.INCONSISTENT_INPUT)


def test_fixed_variable_is_honored():
    d, max_iter = make_case("eq_fixed")
    res = solve_refined_kernel(problem_from_numpy(**d, device="cpu"),
                               SolverOptions(max_iter=max_iter))
    np.testing.assert_allclose(res.x[:, 2].numpy(), 0.41, atol=1e-6)


def test_torch_generator_batch_solves():
    # the port's own generator (f32 made, f64 solved, as the headline
    # solve does) at a small size, on the CPU
    gen = torch.Generator().manual_seed(0)
    pbs = random_qp_batch(gen, 16, 10, 20, act_frac=0.3,
                          dtype=torch.float32).with_dtype(torch.float64)
    assert pbs.G.shape == (16, 10, 10) and pbs.l.dtype == torch.float64
    assert bool((pbs.l <= pbs.u).all())
    assert bool((torch.linalg.eigvalsh(pbs.G) >= 1.0 - 1e-5).all())
    res = solve_refined_kernel(pbs, SolverOptions(max_iter=150), ir_steps=1)
    resid = kkt_residual(res.x, res.multipliers, pbs)
    assert bool(((resid <= 1e-8) & (res.status == 0)).all()), resid


def test_default_ir_steps_match_pallas():
    # both packages called with their defaults: ir_steps is 3 in each
    assert (inspect.signature(solve_refined_kernel).parameters["ir_steps"]
            .default == inspect.signature(solve_refined_pallas)
            .parameters["ir_steps"].default == 3)
    d, max_iter = make_case("n8_m12")
    ref = solve_refined_pallas(jax_problem(d), JOptions(max_iter=max_iter),
                               interpret=True, pack=4, fused_init=True)
    pb = problem_from_numpy(**d, device="cpu")
    res = solve_refined_kernel(pb, SolverOptions(max_iter=max_iter))
    ours = result_to_numpy(res)
    np.testing.assert_array_equal(ours["status"], np.asarray(ref.status))
    np.testing.assert_array_equal(ours["active_set"],
                                  np.asarray(ref.active_set))
    np.testing.assert_allclose(ours["x"], np.asarray(ref.x), atol=1e-7)
    np.testing.assert_allclose(ours["multipliers"],
                               np.asarray(ref.multipliers), atol=1e-6)
    assert bool((kkt_residual(res.x, res.multipliers, pb) <= 1e-8).all())


@pytest.mark.parametrize("validate", [False, True])
@pytest.mark.parametrize("name", ["n8_m12", "eq_fixed", "non_spd"])
def test_unfused_init_matches_pallas_interpret(name, validate):
    # fused_init=False (the JAX default): lane for lane against the JAX
    # branch; status, iterations and active set equal, x within 1e-7 and
    # the multipliers within 1e-6 (f32 loop, f64 refinement)
    d, max_iter = make_case(name)
    d["l"][1, 4] = d["u"][1, 4] + 1.0          # lane 1: l > u
    ref = solve_refined_pallas(
        jax_problem(d), JOptions(max_iter=max_iter, validate=validate),
        ir_steps=1, interpret=True, pack=4, fused_init=False)
    pb = problem_from_numpy(**d, device="cpu")
    res = solve_refined_kernel(
        pb, SolverOptions(max_iter=max_iter, validate=validate), ir_steps=1,
        fused_init=False)
    ours = result_to_numpy(res)
    for k in ("status", "iterations", "active_set"):
        np.testing.assert_array_equal(ours[k], np.asarray(getattr(ref, k)),
                                      err_msg=k)
    np.testing.assert_allclose(ours["x"], np.asarray(ref.x), atol=1e-7,
                               err_msg="x: atol 1e-7")
    np.testing.assert_allclose(ours["multipliers"],
                               np.asarray(ref.multipliers), atol=1e-6,
                               err_msg="multipliers: atol 1e-6")
    inconsistent = ours["status"][1] == int(
        TerminationStatus.INCONSISTENT_INPUT)
    assert inconsistent == validate
