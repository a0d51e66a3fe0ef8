"""The box-and-single-constraint solver (``jrlqp_tpu_torch.solver.
box_single``) against the JAX package on the cases of
tests/test_box_single.py, batched: the closed form ``solve_box`` against
JAX ``solve_box`` (status, iterations and active set equal; x, the
multipliers and f within 1e-12) and the GI-machinery ``solve_box_gi``
against JAX ``solve_box_gi`` (the same, within 1e-10)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu.solver import box_single as jbox
from jrlqp_tpu_torch import SolverOptions, TerminationStatus, solve_batch
from jrlqp_tpu_torch.solver.box_single import (
    box_qp_problem,
    solve_box,
    solve_box_gi,
)
from jrlqp_tpu_torch.testing.kkt import check_kkt, kkt_residual
from test_box_single import _generate

torch.set_num_threads(1)

j_box = jax.jit(jax.vmap(jbox.solve_box))
j_box_gi = jax.jit(jax.vmap(jbox.solve_box_gi))


def _stack(data):
    """(x0, c, bl, xl, xu) numpy batches from per-lane tuples."""
    return [np.stack([np.asarray(d[k], np.float64) for d in data])
            for k in range(5)]


def _assert_match(ours, ref, tol):
    for k in ("status", "iterations", "active_set"):
        np.testing.assert_array_equal(getattr(ours, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    for k in ("x", "multipliers", "f"):
        np.testing.assert_allclose(getattr(ours, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=0,
                                   atol=tol, err_msg=f"{k}: atol {tol}")


def _both(arrs):
    """Port and JAX results of both solvers on the batch ``arrs``."""
    t = [torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    return (solve_box(*t), j_box(*j)), (solve_box_gi(*t), j_box_gi(*j))


def _check_both(arrs):
    (cf, jcf), (gi, jgi) = _both(arrs)
    _assert_match(cf, jcf, 1e-12)
    _assert_match(gi, jgi, 1e-10)
    return cf, gi


def test_box_inactive_case():
    rng = np.random.default_rng(0)
    arrs = _stack([_generate(rng, 6, act=False) for _ in range(5)])
    cf, _ = _check_both(arrs)
    assert (cf.status == TerminationStatus.SUCCESS).all()
    np.testing.assert_allclose(cf.x.numpy(), np.clip(arrs[0], arrs[3],
                                                     arrs[4]), atol=1e-12)
    pb = box_qp_problem(*[torch.from_numpy(a) for a in arrs])
    assert check_kkt(cf.x, cf.multipliers, pb).all()


def test_box_active_vs_dense_gi():
    rng = np.random.default_rng(1)
    data = [_generate(rng, 7, act=act, act_level=0.3 + 0.05 * trial)
            for act in (False, True) for trial in range(8)]
    arrs = _stack(data)
    cf, _ = _check_both(arrs)
    assert (cf.status == TerminationStatus.SUCCESS).all()
    t = [torch.from_numpy(a) for a in arrs]
    pb = box_qp_problem(*t)
    dense = solve_batch(pb, SolverOptions())
    assert (dense.status == TerminationStatus.SUCCESS).all()
    np.testing.assert_allclose(cf.x.numpy(), dense.x.numpy(), atol=1e-9,
                               err_msg="atol 1e-9")
    np.testing.assert_allclose(cf.multipliers.numpy(),
                               dense.multipliers.numpy(), atol=1e-9,
                               err_msg="atol 1e-9")
    # the box solver reports f = 0.5|x-x0|^2, the dense one 0.5x'x - x0'x
    np.testing.assert_allclose(
        cf.f.numpy(), dense.f.numpy() + 0.5 * (arrs[0] ** 2).sum(axis=1),
        atol=1e-9, err_msg="atol 1e-9")
    assert check_kkt(cf.x, cf.multipliers, pb).all()


def test_box_batched():
    rng = np.random.default_rng(3)
    arrs = _stack([_generate(rng, 8, act=bool(i % 2)) for i in range(64)])
    cf, _ = _check_both(arrs)
    assert (cf.status == TerminationStatus.SUCCESS).all()
    pb = box_qp_problem(*[torch.from_numpy(a) for a in arrs])
    assert check_kkt(cf.x, cf.multipliers, pb).all()


def test_box_closed_form_vs_gi_machinery():
    rng = np.random.default_rng(11)
    arrs = _stack([_generate(rng, 9, act=act, act_level=0.4)
                   for act in (False, True) for _ in range(6)])
    cf, gi = _check_both(arrs)
    assert (cf.status == 0).all() and (gi.status == 0).all()
    np.testing.assert_allclose(cf.x.numpy(), gi.x.numpy(), atol=1e-9,
                               err_msg="atol 1e-9")
    np.testing.assert_allclose(cf.multipliers.numpy(),
                               gi.multipliers.numpy(), atol=1e-9,
                               err_msg="atol 1e-9")


def test_box_infeasible_detected():
    rng = np.random.default_rng(12)
    data = []
    for _ in range(5):
        x0, c, _, xl, xu = _generate(rng, 6, act=True)
        data.append((x0, c, float(np.where(c > 0, xu, xl) @ c) + 0.5, xl, xu))
    cf, gi = _check_both(_stack(data))
    assert (cf.status == TerminationStatus.INFEASIBLE).all()
    assert (gi.status == TerminationStatus.INFEASIBLE).all()


def test_box_degenerate_corner():
    rng = np.random.default_rng(13)
    data = []
    for _ in range(10):
        x0, c, _, xl, xu = _generate(rng, 6, act=True)
        data.append((x0, c, float(np.where(c > 0, xu, xl) @ c), xl, xu))
    arrs = _stack(data)
    t = [torch.from_numpy(a) for a in arrs]
    cf = solve_box(*t)
    ref = j_box(*[jnp.asarray(a) for a in arrs])
    # at the corner the unclamped point y = x0 + lam c lands on bounds, and
    # which side of a bound it rounds to follows the last bit of lam (the
    # two packages sum g in another order): a bound's flag may differ only
    # where y is within 1e-12 of it
    y = arrs[0] + cf.multipliers.numpy()[:, :1] * -arrs[1]
    tie = np.minimum(np.abs(y - arrs[3]), np.abs(y - arrs[4])) <= 1e-12
    differ = cf.active_set.numpy()[:, 1:] != np.asarray(ref.active_set)[:, 1:]
    assert not (differ & ~tie).any(), "a bound flag differs off a tie"
    np.testing.assert_array_equal(cf.active_set.numpy()[:, 0],
                                  np.asarray(ref.active_set)[:, 0])
    for k in ("status", "iterations"):
        np.testing.assert_array_equal(getattr(cf, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    for k in ("x", "multipliers", "f"):
        np.testing.assert_allclose(getattr(cf, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=0,
                                   atol=1e-12, err_msg=f"{k}: atol 1e-12")
    hit = cf.status == 0
    assert int(hit.sum()) >= 7
    corner = np.where(arrs[1] > 0, arrs[4], arrs[3])
    np.testing.assert_allclose(cf.x.numpy()[hit.numpy()],
                               corner[hit.numpy()], atol=1e-9)
    pb = box_qp_problem(*t)
    assert float(kkt_residual(cf.x, cf.multipliers, pb)[hit].max()) <= 1e-9


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_box_scalar_bound_and_dtype(dtype):
    # a scalar bl broadcasts over the lanes; f32 lanes follow the JAX f32
    # solve (its tolerances scale with the dtype's eps)
    rng = np.random.default_rng(4)
    arrs = _stack([_generate(rng, 5, act=True) for _ in range(6)])
    bl = float(arrs[2].mean())
    t = [torch.from_numpy(a).to(dtype) for a in arrs]
    ours = solve_box(t[0], t[1], bl, t[3], t[4])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ref = jax.vmap(jbox.solve_box, in_axes=(0, 0, None, 0, 0))(
        *[jnp.asarray(a, jdt) for a in (arrs[0], arrs[1])],
        jnp.asarray(bl, jdt), *[jnp.asarray(a, jdt) for a in arrs[3:]])
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    _assert_match(ours, ref, tol)
    assert ours.x.dtype == dtype
