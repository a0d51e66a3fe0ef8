"""Iteration tracing (``jrlqp_tpu_torch.utils``) against the JAX package's
``jrlqp_tpu.utils`` on the cases of tests/test_logger.py and a small random
batch (JAX vmapped where the port is batched): the trace rows within 1e-10
for the f64 traces and 1e-5 for the f32 fast trace; the kernel trajectory
capture against ``capture_pallas_trajectory(interpret=True)`` cap by cap;
and ``dump_matlab`` line by line."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.utils import LogFlags as JFlags
from jrlqp_tpu.utils import capture_pallas_trajectory as j_capture
from jrlqp_tpu.utils import dump_matlab as j_dump
from jrlqp_tpu.utils import solve_fast_traced as j_fast_traced
from jrlqp_tpu.utils import solve_traced as j_traced
from jrlqp_tpu_torch import (
    LogFlags,
    SolverOptions,
    capture_kernel_trajectory,
    dump_matlab,
    problem_from_numpy,
    solve_batch,
    solve_fast,
    solve_fast_traced,
    solve_traced,
)
from test_torch_card import np_qp_batch
from test_torch_dense import jax_batch, paper_problem

torch.set_num_threads(1)

ALL_ROWS = (LogFlags.ITERATION_BASIC_DETAILS | LogFlags.ITERATION_ADVANCE_DETAILS
            | LogFlags.ACTIVE_SET | LogFlags.ACTIVE_SET_DETAILS)
FIELDS = ("x", "f", "q", "sc_idx", "sc_status", "u", "status", "aorder")


def _batches():
    d = np_qp_batch(5, 4, 6, 9, 0.5)
    d["objcst"] = np.zeros(4)
    return {"paper": paper_problem(), "random": d}


def _jax_traced(fn, arrs, opt, flags):
    f = jax.jit(jax.vmap(lambda p: fn(p, opt, JFlags(int(flags)))))
    return f(jax_batch(arrs))


def _assert_trace_matches(tr, jtr, tol):
    valid = tr.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jtr.valid))
    for k in FIELDS:
        ours, ref = getattr(tr, k), getattr(jtr, k)
        assert (ours is None) == (ref is None), k
        if ours is not None:
            np.testing.assert_allclose(ours.numpy()[valid],
                                       np.asarray(ref)[valid], rtol=0,
                                       atol=tol, err_msg=k)


@pytest.mark.parametrize("flags", [ALL_ROWS, ALL_ROWS | LogFlags.INIT,
                                   LogFlags.ITERATION_BASIC_DETAILS
                                   | LogFlags.ACTIVE_SET])
@pytest.mark.parametrize("batch", ["paper", "random"])
def test_dense_trace_matches_jax(batch, flags):
    arrs = _batches()[batch]
    pb = problem_from_numpy(**arrs, device="cpu")
    opt = SolverOptions(max_iter=20)
    res, tr = solve_traced(pb, opt, flags)
    jres, jtr = _jax_traced(j_traced, arrs, JOptions(max_iter=20), flags)
    _assert_trace_matches(tr, jtr, 1e-10)
    plain = solve_batch(pb, opt)
    assert torch.equal(res.iterations, plain.iterations)
    assert torch.equal(res.status, plain.status)
    np.testing.assert_allclose(res.x.numpy(), plain.x.numpy(), atol=1e-12)
    it = res.iterations.numpy()
    valid = tr.valid.numpy()
    for b in range(pb.batch):           # valid rows: exactly the iterations
        assert valid[b, :it[b]].all() and not valid[b, it[b]:].any()
        if it[b]:
            np.testing.assert_allclose(tr.x[b, it[b] - 1].numpy(),
                                       res.x[b].numpy(), atol=1e-12)
    if not flags & LogFlags.ITERATION_ADVANCE_DETAILS:
        assert tr.u is None and tr.status is not None


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("batch", ["paper", "random"])
def test_fast_trace_matches_jax(batch, dtype):
    arrs = _batches()[batch]
    tdt, jdt, tol = ((torch.float64, jnp.float64, 1e-10) if dtype == "f64"
                     else (torch.float32, jnp.float32, 1e-5))
    kw = {} if dtype == "f64" else {"zero_z_threshold": 1e-6}
    arrs = {k: v.astype(np.float64 if dtype == "f64" else np.float32)
            for k, v in arrs.items()}
    pb = problem_from_numpy(**arrs, device="cpu")
    opt = SolverOptions(max_iter=20, dtype=tdt, **kw)
    res, tr = solve_fast_traced(pb, opt, ALL_ROWS)
    jres, jtr = _jax_traced(j_fast_traced, arrs,
                            JOptions(max_iter=20, dtype=jdt, **kw), ALL_ROWS)
    _assert_trace_matches(tr, jtr, tol)
    plain = solve_fast(pb, opt)
    assert torch.equal(res.iterations, plain.iterations)
    np.testing.assert_allclose(res.x.numpy(), plain.x.numpy(), atol=1e-12)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), atol=tol)


def test_fast_trace_agrees_with_dense_trace():
    pb = problem_from_numpy(**paper_problem(), device="cpu")
    opt = SolverOptions(max_iter=20)
    res_d, _ = solve_traced(pb, opt, LogFlags.ITERATION_BASIC_DETAILS)
    res_f, _ = solve_fast_traced(pb, opt, LogFlags.ITERATION_BASIC_DETAILS)
    np.testing.assert_allclose(res_f.f.numpy(), res_d.f.numpy(), atol=1e-10)
    np.testing.assert_allclose(res_f.x.numpy(), res_d.x.numpy(), atol=1e-10)


@pytest.mark.parametrize("batch", ["paper", "random"])
def test_capture_kernel_trajectory_matches_pallas(batch):
    arrs = {k: v[:1] for k, v in _batches()[batch].items()}
    one = jax.tree.map(lambda a: a[0], jax_batch(arrs))
    opt = SolverOptions(max_iter=20)
    f32 = {k: v.astype(np.float32) for k, v in arrs.items()}
    res_f, tr_f = solve_fast_traced(
        problem_from_numpy(**f32, device="cpu"),
        opt.with_(dtype=torch.float32, zero_z_threshold=1e-6))
    n_it = int(res_f.iterations[0])
    caps = max(n_it + 1, 2)
    traj = capture_kernel_trajectory(problem_from_numpy(**arrs, device="cpu"),
                                     opt, n_iters=caps)
    ref = j_capture(one, JOptions(max_iter=20), n_iters=caps, interpret=True)
    for k in ("q", "it", "term"):
        np.testing.assert_array_equal(traj[k][:, 0].numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(traj["x"][:, 0].numpy(), ref["x"], atol=1e-5)
    for k in range(n_it):        # cap k+1 == the traced iteration k+1
        np.testing.assert_allclose(traj["x"][k, 0].numpy(),
                                   tr_f.x[0, k].numpy(), atol=1e-5)
    assert int(traj["term"][n_it, 0]) == 0


def _numbers(line):
    return [float(v) for v in re.findall(r"-?[\d.]+(?:e-?\d+)?|nan|inf",
                                         line.split("=", 1)[1])]


@pytest.mark.parametrize("batch", ["paper", "random"])
def test_dump_matlab_matches_jax(batch):
    arrs = _batches()[batch]
    pb = problem_from_numpy(**arrs, device="cpu")
    opt = SolverOptions(max_iter=20)
    res, tr = solve_traced(pb, opt, ALL_ROWS)
    lane = pb.batch - 1
    ours = dump_matlab("log", tr, res, lane=lane).splitlines()
    one = jax.tree.map(lambda a: a[lane], jax_batch(arrs))
    jres, jtr = j_traced(one, JOptions(max_iter=20), JFlags(int(ALL_ROWS)))
    ref = j_dump("log", jtr, jres).splitlines()
    assert len(ours) == len(ref)
    assert f"log_final.iterations = {int(res.iterations[lane])};" in ours
    for a, b in zip(ours, ref):
        assert a.split("=")[0] == b.split("=")[0]
        np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=0,
                                   atol=1e-10)
