"""The hint warm start: the port's batched warm init, K3's plain version and
``solve_refined_warm_kernel`` against the JAX package (Pallas in interpret
mode, pack 4), on numpy inputs shared by both; and K3 resuming a capped K1
run, pending candidate included."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.ops.pallas.gi_kernel import run_loop_pallas
from jrlqp_tpu.solver.fast import FastState as JFastState
from jrlqp_tpu.solver.fast import _init_fast_warm as j_init_fast_warm
from jrlqp_tpu.solver.fast import solve_refined_warm_pallas
from jrlqp_tpu.solver.warm_start import (
    _process_initial_active_set as j_process_initial_active_set,
)
from jrlqp_tpu_torch import (
    SolverOptions,
    problem_from_numpy,
    result_to_numpy,
    solve_refined_kernel,
    solve_refined_warm_kernel,
)
from jrlqp_tpu_torch.ops.cuda import gi_kernel
from jrlqp_tpu_torch.solver import fast
from jrlqp_tpu_torch.solver.warm_start import _process_initial_active_set
from jrlqp_tpu_torch.testing.kkt import kkt_residual
from jrlqp_tpu_torch.types import (
    LOWER,
    MAX_ITER_REACHED,
    RUNNING,
    UPPER,
    UPPER_BOUND,
)
from test_torch_card import CASES, make_case, np_qp_batch
from test_torch_gi_kernel import jax_problem

torch.set_num_threads(1)

SPD_CASES = [k for k in CASES if k != "non_spd"]
STATE_INT = ("status", "aorder", "q", "it", "term", "skip1", "sc_idx",
             "sc_status")
STATE_F32 = ("x", "u", "H", "Ns")


def _f32(d):
    return {k: v.astype(np.float32) for k, v in d.items()}


def _cold_hints(d, max_iter):
    """The active set of a cold solve of batch ``d`` (the port's, which
    equals the JAX package's: tests/test_torch_solve.py)."""
    res = solve_refined_kernel(problem_from_numpy(**d, device="cpu"),
                               SolverOptions(max_iter=max_iter))
    return res.active_set.numpy()


def _hints(kind, d, max_iter):
    if kind == "exact":
        return _cold_hints(d, max_iter)
    if kind == "half":
        h = _cold_hints(d, max_iter)
        h[:, ::2] = 0
        return h
    if kind in ("overflow", "inf_bound"):   # every constraint hinted, > n
        B, m = d["l"].shape
        n = d["a"].shape[1]
        rng = np.random.default_rng(3)
        h = np.zeros((B, m + n), np.int32)
        h[:, :m] = np.where(rng.uniform(size=(B, m)) < 0.5, LOWER, UPPER)
        if kind == "inf_bound":
            # hints at infinite bounds: dropped against big_bnd in f64 (in
            # f32, 1e100 rounds to inf and both packages keep them)
            h[:, m:m + 2] = UPPER_BOUND
        return h
    raise ValueError(kind)


def _opt32(max_iter, warm_start=True):
    return (JOptions(max_iter=max_iter, warm_start=warm_start).with_(
        dtype=np.float32, zero_z_threshold=1e-6),
        SolverOptions(max_iter=max_iter, warm_start=warm_start).with_(
        dtype=torch.float32, zero_z_threshold=1e-6))


def _jax_init(d32, hints, jopt):
    st = jax.vmap(lambda p, h: j_init_fast_warm(p, h, jopt))(
        jax_problem(d32), hints)
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _jax_state(s):
    """The JAX package's FastState from a dict of numpy arrays."""
    return JFastState(**{k: jnp.asarray(v) for k, v in s.items()})


def _torch_state(s):
    """The port's FastState from the JAX package's, through numpy."""
    return fast.FastState(**{k: torch.from_numpy(np.array(v))
                             for k, v in s.items()})


def _rank_deficient():
    """Constraint row 0 zero with l0 = -1 < 0 < u0 = 1, and constraints 0
    and 1 hinted LOWER: M = N^T G^-1 N has a zero pivot on every lane."""
    d = np_qp_batch(5, 6, 8, 12, 0.4)
    d["C"][:, 0] = 0.0
    d["l"][:, 0], d["u"][:, 0] = -1.0, 1.0
    hints = np.zeros((6, 12 + 8), np.int32)
    hints[:, :2] = LOWER
    return d, hints, 60


def _init_case(name, kind):
    if kind == "rank_deficient":
        return _rank_deficient()
    d, max_iter = make_case(name)
    return d, _hints(kind, d, max_iter), max_iter


@pytest.mark.parametrize("name,kind,warm_start", [
    ("n8_m12", "exact", True),
    ("n13_m7", "half", True),
    ("eq_fixed", "exact", True),
    ("eq_lane_mix", "half", True),
    ("vertex_touch", "overflow", True),
    ("vertex_touch", "inf_bound", True),
    ("n8_m12", "exact", False),
])
def test_process_initial_active_set_matches_jax(name, kind, warm_start):
    d, hints, max_iter = _init_case(name, kind)
    jopt = JOptions(max_iter=max_iter, warm_start=warm_start)
    ref = jax.vmap(lambda p, h: j_process_initial_active_set(p, h, jopt))(
        jax_problem(d), hints)
    ours = _process_initial_active_set(
        problem_from_numpy(**d, device="cpu"), torch.from_numpy(hints),
        SolverOptions(max_iter=max_iter, warm_start=warm_start))
    for a, b, what in zip(ours, ref, ("status", "aorder", "q", "over")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)
    if kind in ("overflow", "inf_bound"):
        assert (ours[2].numpy() == d["a"].shape[1]).all()   # q == n
        assert (ours[0].numpy()[:, d["l"].shape[1]:] == 0).all()
    if not warm_start:
        assert (ours[2].numpy() == 0).all()


@pytest.mark.parametrize("name,kind", [
    ("n8_m12", "exact"), ("n13_m7", "half"), ("eq_fixed", "half"),
    ("vertex_touch", "exact"), ("eq_lane_mix", "half"),
    ("rank_deficient", "rank_deficient"),
])
def test_init_fast_warm_matches_jax(name, kind):
    d, hints, max_iter = _init_case(name, kind)
    d32 = _f32(d)
    jopt, opt = _opt32(max_iter)
    ref = _jax_init(d32, hints, jopt)
    ours = fast._init_fast_warm(problem_from_numpy(**d32, device="cpu"),
                                torch.from_numpy(hints), opt)
    for k in STATE_INT:
        np.testing.assert_array_equal(getattr(ours, k).numpy(), ref[k],
                                      err_msg=k)
    for k in STATE_F32:
        np.testing.assert_allclose(getattr(ours, k).numpy(), ref[k],
                                   rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(ours.hscale.numpy(), ref["hscale"], rtol=1e-5)
    if kind == "rank_deficient":
        # the cold fallback in both: no hint survives, q = 0
        assert (ours.q.numpy() == 0).all() and (ref["q"] == 0).all()
        assert (ours.term.numpy() == RUNNING).all()


@pytest.mark.parametrize("name,kind", [
    ("n8_m12", "half"), ("n13_m7", "exact"), ("eq_fixed", "half"),
    ("eq_lane_mix", "exact"), ("vertex_touch", "half"),
    ("non_spd", "half"),
])
def test_gi_loop_plain_matches_pallas_interpret(name, kind):
    d, max_iter = make_case(name)
    d32 = _f32(d)
    hints = _hints(kind, d, max_iter)
    jopt, _ = _opt32(max_iter)
    state0 = _jax_init(d32, hints, jopt)
    ref = run_loop_pallas(jax_problem(d32), _jax_state(state0), max_iter,
                          interpret=True, pack=4, presort=False)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ours = gi_kernel.gi_loop_plain(problem_from_numpy(**d32, device="cpu"),
                                   _torch_state(state0), max_iter)
    ours = {k: v.numpy() for k, v in ours.items()}
    assert ours.keys() == ref.keys()
    for k in STATE_INT:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for k in STATE_F32:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(ours["hscale"], ref["hscale"])


@pytest.mark.parametrize("name", SPD_CASES)
@pytest.mark.parametrize("kind", ["exact", "half"])
def test_solve_refined_warm_matches_pallas_interpret(name, kind):
    d, max_iter = make_case(name)
    hints = _hints(kind, d, max_iter)
    jopt = JOptions(max_iter=max_iter, warm_start=True)
    ref = solve_refined_warm_pallas(jax_problem(d), hints, jopt,
                                    interpret=True, pack=4)
    pb = problem_from_numpy(**d, device="cpu")
    res = solve_refined_warm_kernel(
        pb, torch.from_numpy(hints),
        SolverOptions(max_iter=max_iter, warm_start=True))
    ours = result_to_numpy(res)
    np.testing.assert_array_equal(ours["status"], np.asarray(ref.status))
    np.testing.assert_array_equal(ours["iterations"],
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(ours["active_set"],
                                  np.asarray(ref.active_set))
    np.testing.assert_allclose(ours["x"], np.asarray(ref.x), atol=1e-7)
    np.testing.assert_allclose(ours["multipliers"],
                               np.asarray(ref.multipliers), atol=1e-6)
    ok = res.status == 0
    assert ok.any()
    resid = kkt_residual(res.x, res.multipliers, pb)
    assert bool((resid[ok] <= 1e-8).all()), resid.numpy()
    if kind == "exact":   # the cold solve's own active set: no iteration
        assert int(res.iterations.max()) == 0


@pytest.mark.parametrize("name", list(CASES))
def test_gi_loop_resumes_capped_run(name):
    """K3 started from a K1 run capped at c iterations ends as the uncapped
    K1 run, also on lanes capped right after a removal (skip1 = 1), whose
    pending candidate's normal K3 rebuilds from (sc_idx, sc_status)."""
    d, max_iter = make_case(name)
    pb = problem_from_numpy(**_f32(d), device="cpu")
    full = gi_kernel.gi_fused_plain(pb, max_iter)
    pending = 0
    for cap in range(1, int(full["it"].max()) + 1):
        st = fast._state_from_kernel_out(gi_kernel.gi_fused_plain(pb, cap),
                                         pb.batch)
        capped = st.term == MAX_ITER_REACHED
        pending += int((capped & st.skip1).sum())
        st = dataclasses.replace(st, term=torch.where(
            capped, RUNNING, st.term).to(torch.int32))
        out = gi_kernel.gi_loop_plain(pb, st, max_iter)
        for k in ("term", "it", "q", "status", "aorder"):
            assert torch.equal(out[k], full[k]), (cap, k)
        assert torch.equal(out["x"], full["x"]), cap
    if name in ("n8_m12", "vertex_touch"):
        assert pending > 0
