"""The structured fast solver: ``solve_structured_fast_batch`` and
``solve_structured_fast_carry`` of the port against the JAX package's
(``backend="pallas"`` in interpret mode for the port's ``"auto"``, whose
CPU batch runs the plain versions of K5-K8; ``backend="xla"`` for
``"blocks"``), on numpy inputs shared by both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.structured import containers as jc
from jrlqp_tpu.solver import fast as jfast
from jrlqp_tpu.structured import solver as js
from jrlqp_tpu_torch import SolverOptions, TerminationStatus
from jrlqp_tpu_torch.solver import fast
from jrlqp_tpu_torch.structured import (
    GType,
    solve_structured_fast,
    solve_structured_fast_batch,
    solve_structured_fast_carry,
    structured_from_numpy,
    structured_qp_problem,
)
from jrlqp_tpu_torch.testing.ik_gen import ik_batch, ik_step
from jrlqp_tpu_torch.testing.kkt import kkt_residual
from jrlqp_tpu_torch.types import LOWER, UPPER
from jrlqp_tpu_torch.utils import spans
from test_torch_gi_kernel import jax_problem
from test_torch_structured_loop import carry_band

torch.set_num_threads(1)

NB, S, MC, B = 3, 8, 2, 5
JBACKEND = {"auto": "pallas", "blocks": "xla"}


def _jax_args(d, gtype):
    sg = jc.StructuredG(diag=jnp.asarray(d["diag"]), off=jnp.asarray(d["off"]),
                        gtype=int(gtype))
    sc = jc.StructuredC(blocks=jnp.asarray(d["blocks"]))
    return sg, jnp.asarray(d["a"]), sc, jnp.asarray(d["l"]), jnp.asarray(
        d["u"])


def _args(d, gtype):
    sg, sc = structured_from_numpy(diag=d["diag"], off=d["off"], gtype=gtype,
                                   blocks=d["blocks"], device="cpu")
    return sg, torch.from_numpy(d["a"]), sc, torch.from_numpy(d["l"]), \
        torch.from_numpy(d["u"])


def _bounds(d, key):
    return None if d.get(key) is None else torch.from_numpy(d[key])


def _jbounds(d, key):
    return None if d.get(key) is None else jnp.asarray(d[key])


def _assert_same(res, ref, x_tol=1e-7):
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.active_set.numpy(),
                                  np.asarray(ref.active_set))
    ok = res.status.numpy() == 0
    np.testing.assert_allclose(res.x.numpy()[ok], np.asarray(ref.x)[ok],
                               rtol=0, atol=x_tol)
    np.testing.assert_allclose(res.multipliers.numpy()[ok],
                               np.asarray(ref.multipliers)[ok], rtol=0,
                               atol=1e-6)


def _solve_both(d, gtype, backend, opt=None, jopt=None):
    opt = opt or SolverOptions(max_iter=200)
    jopt = jopt or JOptions(max_iter=200)
    res = solve_structured_fast_batch(
        *_args(d, gtype), _bounds(d, "xl"), _bounds(d, "xu"), opt=opt,
        backend=backend)
    ref = js.solve_structured_fast_batch(
        *_jax_args(d, gtype), _jbounds(d, "xl"), _jbounds(d, "xu"),
        opt=jopt, backend=JBACKEND[backend], interpret=True)
    return res, ref


@pytest.mark.parametrize("backend", ["auto", "blocks"])
@pytest.mark.parametrize("gtype", list(GType))
def test_batch_matches_jax(gtype, backend):
    d = ik_batch(B, nb=NB, s=S, mc=MC, seed=int(gtype) + 1)
    res, ref = _solve_both(d, gtype, backend)
    _assert_same(res, ref)
    assert bool((res.status == 0).all())
    pb = structured_qp_problem(*_args(d, gtype))
    assert float(kkt_residual(res.x, res.multipliers, pb).max()) <= 1e-8
    assert int(res.iterations.min()) > 0


def test_batch_matches_the_dense_engine():
    # the structured init against the port's dense solve of the same
    # problems: same status and active set, x to refinement accuracy
    d = ik_batch(B, nb=NB, s=S, mc=MC, seed=7)
    for gtype in GType:
        args = _args(d, gtype)
        res = solve_structured_fast_batch(*args,
                                          opt=SolverOptions(max_iter=200))
        dense = fast.solve_refined(structured_qp_problem(*args),
                                   SolverOptions(max_iter=200))
        assert torch.equal(res.status, dense.status)
        assert torch.equal(res.active_set, dense.active_set)
        torch.testing.assert_close(res.x, dense.x, rtol=0, atol=1e-9)


@pytest.mark.parametrize("backend", ["auto", "blocks"])
def test_with_equalities_and_bounds(backend):
    # after test_structured_with_equalities_and_bounds: an equality and
    # box bounds |x| <= 0.05, around an interior point so the batch stays
    # feasible (the IK bounds sit around a point in [-1, 1]^n)
    d = ik_batch(B, nb=NB, s=S, mc=MC, seed=42)
    rng = np.random.default_rng(42)
    n, m = NB * S, NB * MC
    x0 = rng.uniform(-0.025, 0.025, (B, n))
    cx = np.einsum("bij,bj->bi", structured_qp_problem(
        *_args(d, GType.TRI_BLOCK_DIAGONAL)).C.numpy(), x0)
    d["l"] = cx - rng.uniform(0.0, 0.5, (B, m))
    d["u"] = cx + rng.uniform(0.0, 2.0, (B, m))
    d["l"][:, 0] = d["u"][:, 0] = cx[:, 0]
    d["xl"] = np.full((B, n), -0.05)
    d["xu"] = np.full((B, n), 0.05)
    res, ref = _solve_both(d, GType.TRI_BLOCK_DIAGONAL, backend)
    _assert_same(res, ref)
    assert bool((res.status == 0).all())
    assert (res.active_set.numpy()[:, 0] == 3).all()
    assert (res.active_set.numpy()[:, m:] >= 4).any(axis=1).all()


@pytest.mark.parametrize("backend", ["auto", "blocks"])
def test_non_spd_lane_flagged(backend):
    # after test_structured_fast_pallas_non_spd_flagged: lane 2's block 1
    # is indefinite; the kernel clamps pivots and the whole-factor rule
    # flags it, the composed path by cholesky_ex's info
    d = ik_batch(4, nb=NB, s=4, mc=MC, seed=3)
    d["diag"][2, 1] -= 3 * NB * 4 * np.eye(4)
    for gtype in GType:
        res, ref = _solve_both(d, gtype, backend)
        _assert_same(res, ref)
        assert res.status.tolist() == [0, 0, 2, 0], gtype


def test_validate_gates_inconsistent_lanes():
    d = ik_batch(B, nb=NB, s=S, mc=MC, seed=11)
    d["l"][3, 2] = d["u"][3, 2] + 1.0            # lane 3: l > u
    res, ref = _solve_both(d, GType.BLOCK_ARROW_DOWN, "auto",
                           SolverOptions(max_iter=200, validate=True),
                           JOptions(max_iter=200, validate=True))
    _assert_same(res, ref)
    assert res.status.tolist() == [
        0, 0, 0, int(TerminationStatus.INCONSISTENT_INPUT), 0]


def _jax_carry_init(ds, gtype, jcarry):
    """The JAX package's carry init of the step ``ds`` from ``jcarry``, as
    numpy arrays, on the dense f32 problem its warm step builds."""
    pb = structured_qp_problem(*_args(ds, gtype)).with_dtype(torch.float32)
    st = jax.vmap(jfast._init_fast_from_carry)(
        jax_problem({k: getattr(pb, k).numpy()
                     for k in ("G", "a", "C", "l", "u", "xl", "xu")}),
        jcarry.H, jcarry.Ns, jcarry.status, jcarry.aorder, jcarry.q)
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _lanes(res, keep):
    """The lanes ``keep`` of a result of either package, as torch tensors."""
    return type(res)(**{f.name: torch.as_tensor(np.array(
        getattr(res, f.name)))[torch.as_tensor(keep)]
        for f in dataclasses.fields(res)})


def _kkt(res, ds, gtype):
    pb = structured_qp_problem(*_args(ds, gtype))
    return kkt_residual(torch.as_tensor(np.asarray(res.x)),
                        torch.as_tensor(np.asarray(res.multipliers)), pb)


@pytest.mark.parametrize("gtype", [GType.TRI_BLOCK_DIAGONAL,
                                   GType.BLOCK_ARROW_UP])
def test_carry_trajectory_matches_jax(gtype):
    # after test_structured_fast_carry_trajectory: a cold step and three
    # warm steps at drift 0.02 (fresh noise on a, a shared shift of l and
    # u), each equal to the JAX package's and to a cold solve; a lane
    # whose JAX carry init kept a multiplier in [-1e-5, 0), which the
    # port's drops, parts from the JAX package's from that step on, by
    # design, with a KKT residual no larger
    d = ik_batch(B, nb=NB, s=S, mc=MC, seed=20 + int(gtype))
    rng = np.random.default_rng(0)
    opt, jopt = SolverOptions(max_iter=200), JOptions(max_iter=200)
    carry = jcarry = None
    warm_its = []
    parted = np.zeros(B, bool)
    for step in range(4):
        ds = ik_step(d, 0.02, rng)
        if jcarry is not None:
            parted |= carry_band(_jax_carry_init(ds, gtype, jcarry))
        res, carry = solve_structured_fast_carry(*_args(ds, gtype), carry,
                                                 opt=opt)
        ref, jcarry = js.solve_structured_fast_carry(
            *_jax_args(ds, gtype), jcarry, opt=jopt, backend="pallas",
            interpret=True)
        _assert_same(_lanes(res, ~parted), _lanes(ref, ~parted))
        kkt = _kkt(res, ds, gtype)
        assert bool((kkt[parted] <= _kkt(ref, ds, gtype)[parted]).all())
        assert bool((res.status == 0).all())
        cold = solve_structured_fast_batch(*_args(ds, gtype), opt=opt)
        torch.testing.assert_close(res.x, cold.x, rtol=0, atol=1e-9)
        if step:
            warm_its.append(res.iterations)
    assert float(torch.cat(warm_its).double().mean()) <= 3.0


def test_carry_drops_a_wrong_sign_multiplier_the_jax_carry_keeps():
    # a lane like the benchmark cell ik9x43-track's missed lane (seed
    # 2147521101, lane 500 of pool key 29): the step's a moved along one
    # active row's signed normal, so that on the carried active set, in
    # f64, the row's multiplier is -5e-6 and x is unchanged. The JAX carry
    # init keeps the row (its band is [-1e-5, 0)), its loop finds nothing
    # violated and the lane ends SUCCESS with the wrong sign, which no
    # refinement removes; the port's drops the row and the lane passes at
    # the cold solve's answer. Every other lane is the JAX package's.
    gtype, lane = GType.TRI_BLOCK_DIAGONAL, 2
    d = ik_batch(B, nb=NB, s=S, mc=MC, seed=40)
    opt, jopt = SolverOptions(max_iter=200), JOptions(max_iter=200)
    _, carry = solve_structured_fast_carry(*_args(d, gtype), None, opt=opt)
    _, jcarry = js.solve_structured_fast_carry(
        *_jax_args(d, gtype), None, opt=jopt, backend="pallas",
        interpret=True)
    ds = ik_step(d, 0.02, np.random.default_rng(5))
    pb = structured_qp_problem(*_args(ds, gtype))
    q = int(carry.q[lane])
    rows = carry.aorder[lane, :q].long()
    st = carry.status[lane, rows]
    assert bool(((st == LOWER) | (st == UPPER)).all())   # general rows
    sign = torch.where(st == UPPER, -1.0, 1.0).double()
    N = (sign[:, None] * pb.C[lane, rows]).T                 # (n, q)
    b = sign * torch.where(st == UPPER, pb.u[lane, rows], pb.l[lane, rows])
    n = pb.n
    kkt = torch.zeros((n + q, n + q), dtype=torch.float64)
    kkt[:n, :n], kkt[:n, n:], kkt[n:, :n] = pb.G[lane], -N, N.T
    u = torch.linalg.solve(kkt, torch.cat([-pb.a[lane], b]))[n:]
    k = int(u.argmax())
    ds["a"][lane] += ((-5e-6 - u[k]) * N[:, k]).numpy()
    band = carry_band(_jax_carry_init(ds, gtype, jcarry))
    assert band.tolist() == [b_ == lane for b_ in range(B)]
    res, _ = solve_structured_fast_carry(*_args(ds, gtype), carry, opt=opt)
    ref, _ = js.solve_structured_fast_carry(
        *_jax_args(ds, gtype), jcarry, opt=jopt, backend="pallas",
        interpret=True)
    others = ~band
    _assert_same(_lanes(res, others), _lanes(ref, others))
    row = int(rows[k])
    assert int(res.active_set[lane, row]) == 0
    assert int(np.asarray(ref.active_set)[lane, row]) != 0
    assert int(res.iterations[lane]) > int(np.asarray(ref.iterations)[lane])
    ours, theirs = _kkt(res, ds, gtype)[lane], _kkt(ref, ds, gtype)[lane]
    print(f"lane {lane}: KKT {float(ours)!r} (JAX carry {float(theirs)!r})")
    assert int(res.status[lane]) == 0 and float(ours) <= 1e-8 < float(theirs)
    cold = solve_structured_fast_batch(*_args(ds, gtype), opt=opt)
    torch.testing.assert_close(res.x[lane], cold.x[lane], rtol=0, atol=1e-9)


def test_carry_warm_step_validates():
    # a warm step gates inconsistent lanes as the JAX warm branch does
    d = ik_batch(B, nb=NB, s=S, mc=MC, seed=12)
    opt = SolverOptions(max_iter=200, validate=True)
    jopt = JOptions(max_iter=200, validate=True)
    _, carry = solve_structured_fast_carry(*_args(d, 0), None, opt=opt)
    _, jcarry = js.solve_structured_fast_carry(
        *_jax_args(d, 0), None, opt=jopt, backend="pallas", interpret=True)
    d2 = ik_step(d, 0.02, np.random.default_rng(1))
    d2["l"][1, 4] = d2["u"][1, 4] + 1.0
    res, _ = solve_structured_fast_carry(*_args(d2, 0), carry, opt=opt)
    ref, _ = js.solve_structured_fast_carry(
        *_jax_args(d2, 0), jcarry, opt=jopt, backend="pallas",
        interpret=True)
    _assert_same(res, ref)
    assert res.status[1].item() == int(TerminationStatus.INCONSISTENT_INPUT)


def test_single_problem_wrapper_and_dense_c():
    d = ik_batch(2, nb=NB, s=S, mc=MC, seed=30)
    sg, a, sc, l, u = _args(d, GType.BLOCK_ARROW_DOWN)
    batch = solve_structured_fast_batch(sg, a, sc.to_dense(), l, u)
    one = solve_structured_fast(
        dataclasses.replace(sg, diag=sg.diag[1], off=sg.off[1]), a[1],
        type(sc)(blocks=sc.blocks[1]), l[1], u[1])
    assert one.x.shape == (NB * S,) and one.status.shape == ()
    for f in ("iterations", "status", "active_set"):
        assert torch.equal(getattr(one, f), getattr(batch, f)[1]), f
    for f in ("x", "multipliers", "f"):
        torch.testing.assert_close(getattr(one, f), getattr(batch, f)[1],
                                   rtol=0, atol=1e-12)


def test_cpu_batch_launches_no_kernel():
    d = ik_batch(3, nb=NB, s=S, mc=MC, seed=13)
    for gtype in GType:
        _, carry = solve_structured_fast_carry(*_args(d, gtype), None)
        solve_structured_fast_carry(
            *_args(ik_step(d, 0.02, np.random.default_rng(2)), gtype), carry)
    assert (spans.counter("launch.K5"), spans.counter("launch.K6"),
            spans.counter("launch.K7"), spans.counter("launch.K8"),
            spans.counter("launch.K1"), spans.counter("launch.K3"),
            spans.counter("launch.K4")) == (0,) * 7
    with pytest.raises(ValueError, match="backend"):
        solve_structured_fast_batch(*_args(d, 0), backend="xla")
    with pytest.raises(RuntimeError, match="no kernel"):
        sg, a, sc, l, u = _args(d, 0)
        solve_structured_fast_batch(
            dataclasses.replace(sg, diag=sg.diag.to("meta"),
                                off=sg.off.to("meta")),
            a.to("meta"), type(sc)(blocks=sc.blocks.to("meta")),
            l.to("meta"), u.to("meta"))
