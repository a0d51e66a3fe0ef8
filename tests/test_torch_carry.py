"""The trajectory carry: K4's plain version against ``run_warm_loop_pallas``
(interpret mode, pack 4) from the same carry, and a drifting-bounds
``solve_refined_kernel_carry`` trajectory against
``solve_refined_pallas_carry``, on numpy inputs shared by both packages.
On the CPU the loops run their plain versions and no launch counter
moves."""
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.ops.pallas.gi_kernel import run_warm_loop_pallas
from jrlqp_tpu.solver.fast import solve_refined_pallas_carry
from jrlqp_tpu_torch import (
    SolverOptions,
    TerminationStatus,
    problem_from_numpy,
    result_to_numpy,
    solve_refined_kernel,
    solve_refined_kernel_carry,
)
from jrlqp_tpu_torch.ops.cuda import gi_kernel
from jrlqp_tpu_torch.solver import fast
from jrlqp_tpu_torch.testing.kkt import kkt_residual
from jrlqp_tpu_torch.utils import spans
from test_torch_card import drifted, make_case, np_qp_batch
from test_torch_gi_kernel import jax_problem

torch.set_num_threads(1)

OUT_INT = ("status", "aorder", "q", "it", "term", "skip1", "sc_idx",
           "sc_status")
OUT_F32 = ("x", "u", "H", "Ns")


def _f32(d):
    return {k: v.astype(np.float32) for k, v in d.items()}


def _batch(name):
    if name == "large_drift":   # as test_warm_carry_kernel_large_drift
        return np_qp_batch(29, 5, 8, 12, 0.5), 100
    return make_case(name)


def _carry_np(carry):
    return [np.asarray(getattr(carry, k))
            for k in ("H", "Ns", "status", "aorder", "q")]


@pytest.mark.parametrize("name,scale", [
    ("n8_m12", 0.02), ("n8_m12", 0.5), ("eq_fixed", 0.02),
    ("vertex_touch", 0.02), ("large_drift", 0.5),
])
def test_gi_warm_plain_matches_pallas_interpret(name, scale):
    d, max_iter = _batch(name)
    _, carry = solve_refined_pallas_carry(
        jax_problem(d), None, JOptions(max_iter=max_iter), interpret=True,
        pack=4)
    carry = _carry_np(carry)
    d2 = _f32(drifted(d, scale, 7))
    ref = run_warm_loop_pallas(jax_problem(d2), *carry, max_iter,
                               interpret=True, pack=4)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    pb2 = problem_from_numpy(**d2, device="cpu")
    tcarry = [torch.from_numpy(np.array(v)) for v in carry]
    ours = gi_kernel.gi_warm_plain(pb2, *tcarry, max_iter)
    ours = {k: v.numpy() for k, v in ours.items()}
    assert ours.keys() == ref.keys()
    for k in OUT_INT:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for k in OUT_F32:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(ours["hscale"], ref["hscale"], rtol=1e-5)
    assert (ours["term"] == 0).all()
    if name == "large_drift":
        # max_iter 0 leaves only the prologue: its deactivations count
        pro = gi_kernel.gi_warm_plain(pb2, *tcarry, 0)
        assert int(pro["it"].max()) > 0


def _assert_same_result(ours, ref):
    np.testing.assert_array_equal(ours["status"], np.asarray(ref.status))
    np.testing.assert_array_equal(ours["iterations"],
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(ours["active_set"],
                                  np.asarray(ref.active_set))
    np.testing.assert_allclose(ours["x"], np.asarray(ref.x), atol=1e-7)
    np.testing.assert_allclose(ours["multipliers"],
                               np.asarray(ref.multipliers), atol=1e-6)


def test_carry_trajectory_matches_pallas_interpret():
    """After test_carry_warm_start_trajectory (tests/test_warm_start.py):
    4 steps of bound drift 0.02 with G and C fixed; every warm step equals
    the JAX package's, equals a cold solve, and converges in ~0
    iterations."""
    B, n, m, max_iter = 6, 9, 16, 100
    d = np_qp_batch(3, B, n, m, 0.4)
    jopt, opt = JOptions(max_iter=max_iter), SolverOptions(max_iter=max_iter)
    ref, jcarry = solve_refined_pallas_carry(jax_problem(d), None, jopt,
                                             interpret=True, pack=4)
    res, carry = solve_refined_kernel_carry(problem_from_numpy(**d, device="cpu"), None,
                                            opt)
    _assert_same_result(result_to_numpy(res), ref)
    warm_its = []
    for step in range(4):
        ds = drifted(d, 0.02, 10 + step)
        ref, jcarry = solve_refined_pallas_carry(jax_problem(ds), jcarry,
                                                 jopt, interpret=True,
                                                 pack=4)
        pb = problem_from_numpy(**ds, device="cpu")
        res, carry = solve_refined_kernel_carry(pb, carry, opt)
        _assert_same_result(result_to_numpy(res), ref)
        assert bool((res.status == 0).all())
        cold = solve_refined_kernel(pb, opt)
        torch.testing.assert_close(res.x, cold.x, rtol=0, atol=1e-9)
        assert float(kkt_residual(res.x, res.multipliers, pb).max()) <= 1e-8
        warm_its.append(res.iterations)
    assert float(torch.cat(warm_its).double().mean()) <= 2.0


def test_carry_cold_step_validates():
    # the cold step gates inconsistent lanes under opt.validate (the JAX
    # cold branch does not: ROADMAP queue 3)
    d, max_iter = make_case("n8_m12")
    d["l"][1, 4] = d["u"][1, 4] + 1.0          # lane 1: l > u
    res, _ = solve_refined_kernel_carry(
        problem_from_numpy(**d, device="cpu"), None,
        SolverOptions(max_iter=max_iter, validate=True))
    st = res.status.numpy()
    assert st[1] == int(TerminationStatus.INCONSISTENT_INPUT)
    assert (st[[0, 2, 3, 4, 5]] == 0).all()


def test_loops_on_cpu_are_the_plain_versions():
    d, max_iter = make_case("eq_lane_mix")
    pb = problem_from_numpy(**_f32(d), device="cpu")
    cold, carry = solve_refined_kernel_carry(problem_from_numpy(**d, device="cpu"), None,
                                             SolverOptions(max_iter=max_iter))
    hints = cold.active_set.clone()
    hints[:, ::2] = 0
    opt32 = SolverOptions(max_iter=max_iter, warm_start=True).with_(
        dtype=torch.float32, zero_z_threshold=1e-6)
    state0 = fast._init_fast_warm(pb, hints, opt32)
    pairs = [(gi_kernel.run_loop(pb, state0, max_iter),
              gi_kernel.gi_loop_plain(pb, state0, max_iter))]
    pb2 = problem_from_numpy(**_f32(drifted(d, 0.02, 1)), device="cpu")
    co = (carry.H, carry.Ns, carry.status, carry.aorder, carry.q)
    pairs.append((gi_kernel.run_warm_loop(pb2, *co, max_iter),
                  gi_kernel.gi_warm_plain(pb2, *co, max_iter)))
    for a, b in pairs:
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert (spans.counter("launch.K1"), spans.counter("launch.K3"),
            spans.counter("launch.K4")) == (0, 0, 0)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        gi_kernel.run_warm_loop(pb2.to("meta"), *co, max_iter)
