"""The XLA engine's loop in the port, batched: ``solve_refined`` (cold init,
``fast_iteration`` until no lane runs, f64 refinement) against
``jax.vmap(jrlqp_tpu.solver.fast.solve_refined)``, the selection's tie
order, ``_refine_batch`` on the loop's compact states, and
``_init_fast_from_carry`` from a kernel carry with slot holes. Inputs are
made with numpy and shared by both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.solver import dense as jdense
from jrlqp_tpu.solver import fast as jfast
from jrlqp_tpu_torch import (
    SolverOptions,
    problem_from_numpy,
    solve_refined_kernel_carry,
)
from jrlqp_tpu_torch.solver import fast
from jrlqp_tpu_torch.testing.kkt import kkt_residual
from jrlqp_tpu_torch.types import EQUALITY, FIXED, MAX_ITER_REACHED
from test_torch_card import HOLES, drifted, make_case, np_qp_batch
from test_torch_gi_kernel import jax_problem

torch.set_num_threads(1)


def _eq_bounds(seed, B=8, n=10, m=20):
    """A feasible batch with an equality and box bounds on half the
    variables, around an interior point x0 in [-0.25, 0.25]^n."""
    rng = np.random.default_rng(seed)
    d = np_qp_batch(seed, B, n, m, 0.0)
    x0 = rng.uniform(-0.25, 0.25, (B, n))
    cx = np.einsum("bij,bj->bi", d["C"], x0)
    d["l"] = cx - rng.uniform(0.01, 1.0, (B, m))
    d["u"] = cx + rng.uniform(0.01, 1.0, (B, m))
    d["l"][:, 0] = d["u"][:, 0] = cx[:, 0]      # an equality in every lane
    d["xl"][:, ::2] = -0.3
    d["xu"][:, ::2] = 0.3
    return d


def _batch(name):
    """(numpy f64 arrays, max_iter)."""
    if name == "n10_m20":
        return np_qp_batch(2, 8, 10, 20, 0.5), 100
    if name == "eq_bounds":
        return _eq_bounds(1), 100
    return make_case(name)


def _state_np(st):
    return {k: np.asarray(getattr(st, k))
            for k in jfast.FastState.__dataclass_fields__}


@pytest.mark.parametrize("name", ["n10_m20", "eq_bounds", "eq_fixed",
                                  "vertex_touch", "non_spd"])
def test_solve_refined_matches_jax_vmap(name):
    d, max_iter = _batch(name)
    ref = jax.vmap(lambda p: jfast.solve_refined(
        p, JOptions(max_iter=max_iter)))(jax_problem(d))
    pb = problem_from_numpy(**d, device="cpu")
    res = fast.solve_refined(pb, SolverOptions(max_iter=max_iter))
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.active_set.numpy(),
                                  np.asarray(ref.active_set))
    ok = res.status.numpy() == 0
    np.testing.assert_allclose(res.x.numpy()[ok], np.asarray(ref.x)[ok],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(res.multipliers.numpy()[ok],
                               np.asarray(ref.multipliers)[ok], rtol=0,
                               atol=1e-6)
    assert float(kkt_residual(res.x, res.multipliers, pb)[ok].max()) <= 1e-8
    if name == "non_spd":
        assert res.status.tolist() == [0, 0, 2, 0]
    if name == "eq_bounds":
        assert (res.status == 0).all()
        assert (res.active_set.numpy()[:, 0] == 3).all()     # EQUALITY
        assert (res.active_set.numpy()[:, 20:] >= 4).any()   # a bound


def test_loop_caps_at_max_iter_as_jax():
    d, _ = _batch("n10_m20")
    ref = jax.vmap(lambda p: jfast.solve_refined(p, JOptions(max_iter=3)))(
        jax_problem(d))
    res = fast.solve_refined(problem_from_numpy(**d, device="cpu"),
                             SolverOptions(max_iter=3))
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(ref.iterations))
    assert (res.status == MAX_ITER_REACHED).any()
    assert int(res.iterations.max()) == 3


def test_select_violated_ties_go_to_the_lowest_index():
    B, n, m = 3, 6, 4
    C = np.zeros((B, m, n))
    C[:, 1, 0] = C[:, 3, 0] = 1.0       # rows 1 and 3 identical
    C[:, 0, 1] = C[:, 2, 2] = 1.0
    d = dict(G=np.tile(np.eye(n), (B, 1, 1)), a=np.zeros((B, n)), C=C,
             l=np.full((B, m), -1.0), u=np.full((B, m), 1.0),
             xl=np.full((B, n), -np.inf), xu=np.full((B, n), np.inf))
    d["l"][0, [1, 3]] = 0.5              # lane 0: rows 1 and 3 tie
    d["xl"][1, [2, 4]] = 0.5             # lane 1: bounds 2 and 4 tie
    d["u"][2, 2] = -0.5                  # lane 2: row 2 (upper) against
    d["xu"][2, 0] = -0.5                 # bound 0 (upper): general first
    x = np.zeros((B, n))
    status = np.zeros((B, m + n), np.int32)
    pb = problem_from_numpy(**d, device="cpu")
    idx, st, viol = fast._select_violated(pb, torch.from_numpy(x),
                                          torch.from_numpy(status))
    assert idx.tolist() == [1, m + 2, 2]
    assert st.tolist() == [1, 4, 2]      # LOWER, LOWER_BOUND, UPPER
    np.testing.assert_array_equal(viol.numpy(), [-0.5, -0.5, -0.5])
    jpb = jax_problem(d)
    for b in range(B):
        one = jax.tree.map(lambda v: v[b], jpb)
        ji, js, jv = jdense._select_violated(one, jnp.asarray(x[b]),
                                             jnp.asarray(status[b]))
        assert (int(ji), int(js), float(jv)) == (idx[b].item(), st[b].item(),
                                                 viol[b].item())
    # an active candidate is skipped: the tie moves to the next one
    status[0, 1] = 1
    idx, _, _ = fast._select_violated(pb, torch.from_numpy(x),
                                      torch.from_numpy(status))
    assert idx[0].item() == 3


def test_refine_batch_on_a_compact_state():
    # the loop's states are compact: aorder >= 0 exactly on slots k < q,
    # so the hole-aware refinement equals the JAX package's refinement of
    # the same state, and the per-problem one that reads k < q
    d, max_iter = _batch("eq_bounds")
    pb = problem_from_numpy(**d, device="cpu")
    pb32 = pb.with_dtype(torch.float32)
    opt32 = SolverOptions(max_iter=max_iter).with_(dtype=torch.float32,
                                                   zero_z_threshold=1e-6)
    st = fast._run_fast(pb32, opt32)
    k = torch.arange(pb.n)[None, :]
    assert torch.equal(st.aorder >= 0, k < st.q[:, None].long())
    assert int(st.q.min()) > 0
    res = fast._refine_batch(pb, st, 3)
    jst = jfast.FastState(**{k: jnp.asarray(v)
                             for k, v in _state_np(st).items()})
    jpb = jax_problem(d)
    ref = jfast._refine_batch(jpb, jst, 3)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(res.multipliers.numpy(),
                               np.asarray(ref.multipliers), rtol=0,
                               atol=1e-10)
    one = jax.vmap(jfast._refine, (0, 0, None))(jpb, jst, 3)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(one.x), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(res.active_set.numpy(),
                                  np.asarray(one.active_set))


def _removable_u(st):
    """(eligible, u) of a state as numpy arrays: the slots k < q whose
    constraint is neither an equality nor a fixed variable, and u by
    slot."""
    n = st["aorder"].shape[1]
    mt = st["status"].shape[1]
    valid = np.arange(n)[None, :] < st["q"][:, None]
    idx = np.where(valid, st["aorder"], 0).clip(0, mt - 1)
    sts = np.take_along_axis(st["status"], idx, 1)
    return valid & (sts != EQUALITY) & (sts != FIXED), st["u"][:, :n]


def carry_band(ref):
    """(B,) lanes whose JAX carry init (a state as numpy arrays) kept a
    removable slot with a multiplier in [-1e-5, 0): the port's carry init
    drops every negative multiplier (``fast._CARRY_UTOL``), so there the
    two part by design."""
    elig, u = _removable_u(ref)
    return (elig & (u < 0) & (u >= -1e-5)).any(axis=1)


def assert_dropped_in_band(st, ref, band):
    """On the band lanes the port's carry init went on where the JAX one
    stopped: more deactivations, fewer active slots, each of them active in
    the JAX state too, and no removable multiplier left below zero."""
    ours = _state_np(st)
    elig, u = _removable_u(ours)
    for b in np.flatnonzero(band):
        assert ours["it"][b] > ref["it"][b] and ours["q"][b] < ref["q"][b]
        assert set(ours["aorder"][b, :ours["q"][b]]) < set(
            ref["aorder"][b, :ref["q"][b]])
        assert not (u[b] < 0)[elig[b]].any()


@pytest.mark.parametrize("scale", [0.02, 0.5])
@pytest.mark.parametrize("name", list(HOLES))
def test_init_fast_from_carry_matches_jax(name, scale):
    # every lane as the JAX package's but those where its init kept a
    # multiplier in [-1e-5, 0), which the port drops (assert_dropped_in_band)
    seed, B, n, m, act_frac = HOLES[name]
    d = np_qp_batch(seed, B, n, m, act_frac)
    _, carry = solve_refined_kernel_carry(problem_from_numpy(**d, device="cpu"), None,
                                          SolverOptions(max_iter=100))
    ao = carry.aorder.numpy()
    assert ((ao[:, :-1] < 0) & (ao[:, 1:] >= 0)).any()
    co = [getattr(carry, k) for k in ("H", "Ns", "status", "aorder", "q")]
    d2 = {k: v.astype(np.float32) for k, v in drifted(d, scale, 3).items()}
    st = fast._init_fast_from_carry(problem_from_numpy(**d2, device="cpu"), *co)
    ref = jax.vmap(jfast._init_fast_from_carry)(
        jax_problem(d2), *[jnp.asarray(c.numpy()) for c in co])
    ref = _state_np(ref)
    band = carry_band(ref)
    same = ~band
    for k in ("status", "aorder", "q", "it", "term"):
        np.testing.assert_array_equal(getattr(st, k).numpy()[same],
                                      ref[k][same], err_msg=k)
    for k in ("x", "u", "Ns"):
        np.testing.assert_allclose(getattr(st, k).numpy()[same],
                                   ref[k][same], rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(st.hscale.numpy(), ref["hscale"], rtol=1e-6)
    assert_dropped_in_band(st, ref, band)
    # compacted: the free slots come last
    k = torch.arange(n)[None, :]
    assert torch.equal(st.aorder >= 0, k < st.q[:, None].long())
    if scale == 0.5:
        assert int(st.it.sum()) > 0       # some deactivations ran
