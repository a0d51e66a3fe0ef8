"""The two-phase compacted solve ``solve_refined_kernel_compacted`` (the
torch init and K3's plain version to a reduced cap, then K3 again on the
lanes that hit it) against the JAX single launch
``solve_refined_pallas(..., interpret=True)`` on the cases of
tests/test_rescue.py:69-110, and against the port's own single launch
``solve_refined_kernel(..., fused_init=False)``: the same status and
iterations on every lane, x within 1e-9."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.solver.fast import solve_refined_pallas as j_refined
from jrlqp_tpu.testing.batch_gen import random_qp_batch
from jrlqp_tpu_torch import (
    SolverOptions,
    problem_from_numpy,
    solve_refined_kernel,
    solve_refined_kernel_compacted,
)
from jrlqp_tpu_torch.ops.cuda import gi_kernel
from jrlqp_tpu_torch.solver import fast
from jrlqp_tpu_torch.testing.kkt import kkt_residual
from jrlqp_tpu_torch.types import MAX_ITER_REACHED

torch.set_num_threads(1)

FIELDS = ("G", "a", "C", "l", "u", "xl", "xu", "objcst")


def _pair(key, batch, n, m, act_frac):
    jpbs = random_qp_batch(jax.random.key(key), batch, n, m,
                           act_frac=act_frac)
    pbs = problem_from_numpy(**{k: np.asarray(getattr(jpbs, k))
                                for k in FIELDS}, device="cpu")
    return jpbs, pbs


def _same_lanes(res, ref_status, ref_it, ref_x, x_tol=1e-9):
    np.testing.assert_array_equal(res.status.numpy(), ref_status)
    np.testing.assert_array_equal(res.iterations.numpy(), ref_it)
    assert float(np.abs(res.x.numpy() - ref_x).max()) <= x_tol


@pytest.mark.parametrize("case", [
    # (key, batch, n, m, act_frac, max_iter, phase1_frac)
    (21, 12, 10, 16, 0.6, 100, 0.12),   # test_compacted_matches_plain_pallas
    (22, 6, 8, 12, 0.2, 200, 0.9),      # test_compacted_phase1_covers_all
    (21, 12, 10, 16, 0.6, 100, 0.06),   # a cap of 6: 10 of 12 lanes go on
], ids=["plain_pallas_case", "phase1_covers_all", "lanes_continue"])
def test_compacted_matches_jax_single_launch(case):
    key, batch, n, m, act, max_iter, frac = case
    jpbs, pbs = _pair(key, batch, n, m, act)
    ref = j_refined(jpbs, JOptions(max_iter=max_iter), interpret=True)
    opt = SolverOptions(max_iter=max_iter)
    res = solve_refined_kernel_compacted(pbs, opt, phase1_frac=frac)
    _same_lanes(res, np.asarray(ref.status), np.asarray(ref.iterations),
                np.asarray(ref.x))
    assert bool((res.status == 0).all())
    assert float(kkt_residual(res.x, res.multipliers, pbs).max()) <= 1e-8
    single = solve_refined_kernel(pbs, opt, fused_init=False)
    _same_lanes(res, single.status.numpy(), single.iterations.numpy(),
                single.x.numpy())


def test_compacted_resumes_a_pending_candidate():
    """Phase 1 caps lanes right after a removal (skip1 = 1, a pending
    candidate). The JAX package's K3 starts such a lane from n+ = 0 and
    ends it INFEASIBLE (ROADMAP section 3: with this batch and cap,
    ``solve_refined_pallas_compacted(..., phase1_frac=6/80, pack=4,
    interpret=True)`` ends lanes 10 and 13 INFEASIBLE); the port's K3
    rebuilds the candidate's normal at entry, so every lane ends SUCCESS,
    as in the single launch."""
    jpbs, pbs = _pair(0, 16, 10, 20, 0.5)
    max_iter, frac = 80, 6 / 80
    opt = SolverOptions(max_iter=max_iter)
    pb32 = pbs.with_dtype(torch.float32)
    opt32 = opt.with_(dtype=torch.float32, zero_z_threshold=1e-6)
    st = fast._state_from_kernel_out(
        gi_kernel.run_loop(pb32, fast._init_fast(pb32, opt32), 6), pbs.batch)
    capped = st.term == MAX_ITER_REACHED
    assert int((capped & st.skip1).sum()) > 0
    res = solve_refined_kernel_compacted(pbs, opt, phase1_frac=frac)
    assert bool((res.status == 0).all()), res.status
    ref = j_refined(jpbs, JOptions(max_iter=max_iter), interpret=True)
    _same_lanes(res, np.asarray(ref.status), np.asarray(ref.iterations),
                np.asarray(ref.x))
    assert float(kkt_residual(res.x, res.multipliers, pbs).max()) <= 1e-8


def test_compacted_runs_k3_twice_on_the_unfinished_lanes(monkeypatch):
    """Phase 1 on the whole batch to the cap, phase 2 on exactly the lanes
    that hit it, RUNNING, with the full budget."""
    _, pbs = _pair(21, 12, 10, 16, 0.6)
    calls = []
    real = fast.run_loop

    def spy(pb32, state0, max_iter):
        calls.append((pb32.batch, max_iter, state0.term.clone()))
        return real(pb32, state0, max_iter)

    monkeypatch.setattr(fast, "run_loop", spy)
    opt = SolverOptions(max_iter=100)
    fast.solve_refined_kernel_compacted(pbs, opt, phase1_frac=0.06)
    assert [c[:2] for c in calls[:1]] == [(12, 6)]
    assert len(calls) == 2
    batch2, budget2, term2 = calls[1]
    assert 0 < batch2 < 12 and budget2 == 100
    assert bool((term2 == -1).all())
    calls.clear()
    fast.solve_refined_kernel_compacted(pbs, opt, phase1_frac=1.0)
    assert [c[:2] for c in calls] == [(12, 100)]


def test_compacted_keeps_validate():
    _, pbs = _pair(22, 6, 8, 12, 0.2)
    pbs = dataclasses.replace(pbs, l=pbs.l.clone())
    pbs.l[1, 0] = pbs.u[1, 0] + 1.0        # inverted bounds on lane 1
    res = solve_refined_kernel_compacted(
        pbs, SolverOptions(max_iter=100, validate=True), phase1_frac=0.1)
    assert int(res.status[1]) == 1         # INCONSISTENT_INPUT
    assert bool((res.status[[0, 2, 3, 4, 5]] == 0).all())
