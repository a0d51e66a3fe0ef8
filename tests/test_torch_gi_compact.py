"""K9, the compact-slot GI loop: its plain version against the Pallas
``_kernel`` (``run_loop_pallas(..., pack=1, interpret=True)``) from the same
``_init_fast`` states, and against the port's torch XLA loop ``_run_loop``
lane for lane (both use compact slots); ``solve_refined_kernel_compact``
against ``solve_refined_pallas(..., pack=1, interpret=True)``; and a capped
run resumed with a pending candidate (skip1 = 1), whose normal the port
rebuilds at entry where the Pallas kernel starts it at zero."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.ops.pallas.gi_kernel import run_loop_pallas
from jrlqp_tpu.solver.fast import _init_fast as j_init_fast
from jrlqp_tpu.solver.fast import solve_refined_pallas
from jrlqp_tpu.testing.batch_gen import random_qp_batch
from jrlqp_tpu_torch import (
    SolverOptions,
    problem_from_numpy,
    solve_refined_kernel_compact,
)
from jrlqp_tpu_torch.ops.cuda import gi_kernel
from jrlqp_tpu_torch.solver import fast
from jrlqp_tpu_torch.types import MAX_ITER_REACHED, RUNNING
from jrlqp_tpu_torch.utils import spans
from test_torch_card import CASES, make_case
from test_torch_gi_kernel import jax_problem

torch.set_num_threads(1)

K9_CASES = ["n8_m12", "n13_m7", "eq_fixed"]
INTS = ("term", "it", "q", "status", "aorder")


def _f32(d):
    return {k: v.astype(np.float32) for k, v in d.items()}


def _opt32(max_iter):
    return SolverOptions(max_iter=max_iter).with_(dtype=torch.float32,
                                                  zero_z_threshold=1e-6)


def _assert_scaled(ours, ref, keys, tol=1e-5):
    """|ours - ref| <= tol * max(1, max |ref lane|), lane by lane."""
    for k in keys:
        o = np.asarray(ours[k], np.float64).reshape(len(ours[k]), -1)
        r = np.asarray(ref[k], np.float64).reshape(len(ref[k]), -1)
        mag = np.maximum(1.0, np.abs(r).max(axis=1))
        assert (np.abs(o - r).max(axis=1) <= tol * mag).all(), k


@pytest.mark.parametrize("name", K9_CASES)
def test_plain_matches_pallas_pack1(name):
    d, max_iter = make_case(name)
    d32 = _f32(d)
    jp = jax_problem(d32)
    jopt = JOptions(max_iter=max_iter, dtype=jnp.float32,
                    zero_z_threshold=1e-6)
    st0 = jax.vmap(lambda p: j_init_fast(p, jopt))(jp)
    ref = run_loop_pallas(jp, st0, max_iter, interpret=True, pack=1)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    pb = problem_from_numpy(**d32, device="cpu")
    ours = gi_kernel.gi_compact_plain(
        pb, fast._init_fast(pb, _opt32(max_iter)), max_iter)
    ours = {k: v.numpy() for k, v in ours.items()}
    for k in INTS + ("skip1", "sc_idx", "sc_status"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    _assert_scaled(ours, ref, ("x", "u", "H", "Ns"))
    np.testing.assert_allclose(ours["hscale"], ref["hscale"], rtol=1e-6)
    if name == "eq_fixed":
        assert (ours["status"][:, [0, 3]] == 3).all()     # EQUALITY
        assert (ours["status"][:, 6 + 2] == 6).all()      # FIXED


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_torch_xla_loop(name):
    d, max_iter = make_case(name)
    pb = problem_from_numpy(**_f32(d), device="cpu")
    opt32 = _opt32(max_iter)
    st0 = fast._init_fast(pb, opt32)
    ours = gi_kernel.gi_compact_plain(pb, st0, max_iter)
    xla = fast._run_loop(pb, st0, opt32)
    for k in INTS:
        assert torch.equal(ours[k], getattr(xla, k).to(ours[k].dtype)), k
    ref = {"x": xla.x, "u": xla.u[:, :pb.n], "H": xla.H, "Ns": xla.Ns}
    _assert_scaled({k: ours[k].numpy() for k in ref},
                   {k: v.numpy() for k, v in ref.items()}, ref)


@pytest.mark.parametrize("n,m,batch", [(8, 12, 6), (13, 7, 4)])
def test_compact_solve_matches_pallas_pack1(n, m, batch):
    opt = SolverOptions(max_iter=60)
    jpbs = random_qp_batch(jax.random.key(0), batch, n, m, act_frac=0.4)
    ref = solve_refined_pallas(jpbs, JOptions(max_iter=60), interpret=True,
                               pack=1)
    arrs = {k: np.asarray(getattr(jpbs, k)) for k in
            ("G", "a", "C", "l", "u", "xl", "xu", "objcst")}
    res = solve_refined_kernel_compact(
        problem_from_numpy(**arrs, device="cpu"), opt)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-7)
    np.testing.assert_allclose(res.multipliers.numpy(),
                               np.asarray(ref.multipliers), atol=1e-6)


def test_compact_path_on_cpu_is_the_plain_version():
    d, max_iter = make_case("n8_m12")
    pb = problem_from_numpy(**_f32(d), device="cpu")
    st0 = fast._init_fast(pb, _opt32(max_iter))
    a = gi_kernel.run_loop_compact(pb, st0, max_iter)
    b = gi_kernel.gi_compact_plain(pb, st0, max_iter)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert spans.counter("launch.K9") == 0


@pytest.mark.parametrize("name", ["n8_m12", "vertex_touch"])
def test_resumed_pending_candidate(name):
    """K9 started from its own run capped at c iterations ends as the
    uncapped run, also on lanes capped right after a removal (skip1 = 1):
    the port rebuilds the pending candidate's normal from (sc_idx,
    sc_status) at entry. The Pallas ``_kernel`` starts it at zero
    (gi_kernel.py:336-339), so such a lane gets z = r = 0 and cannot end as
    the uncapped run: a reference-side deviation (ROADMAP queue 3)."""
    d, max_iter = make_case(name)
    pb = problem_from_numpy(**_f32(d), device="cpu")
    st0 = fast._init_fast(pb, _opt32(max_iter))
    full = gi_kernel.gi_compact_plain(pb, st0, max_iter)
    pending = 0
    for cap in range(1, int(full["it"].max()) + 1):
        st = fast._state_from_kernel_out(
            gi_kernel.gi_compact_plain(pb, st0, cap), pb.batch)
        capped = st.term == MAX_ITER_REACHED
        lanes = capped & st.skip1
        pending += int(lanes.sum())
        st = dataclasses.replace(st, term=torch.where(
            capped, RUNNING, st.term).to(torch.int32))
        out = gi_kernel.gi_compact_plain(pb, st, max_iter)
        for k in INTS:
            assert torch.equal(out[k], full[k]), (cap, k)
        torch.testing.assert_close(out["x"], full["x"], rtol=0, atol=1e-6)
    assert pending > 0
