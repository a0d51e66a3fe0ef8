"""The port's benchmark harness (jrlqp_tpu_torch.bench.harness) against the
JAX package's (jrlqp_tpu.bench.harness): ``time_batch`` through the size
and active-fraction sweeps for each of the five solvers, and the scaling
capture over a mesh of CPU devices, with the problem generator of both
modules replaced by one that returns the same numpy batch. The rows' names and keys are equal letter for letter, and so are
mean_iterations, success_rate and kkt_pass_rate (tolerance 0: means over 8
lanes of integer counts and flags). The JAX kernels run in interpret mode.
tests/test_torch_harness_fixtures.py holds the other fixtures."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jrlqp_tpu.solver.fast as jfast
from jrlqp_tpu.bench import harness as jh
from jrlqp_tpu.problems import QPProblem as JProblem
from jrlqp_tpu_torch import problem_from_numpy
from jrlqp_tpu_torch.bench import harness as th
from jrlqp_tpu_torch.ops.cuda import gi_kernel

torch.set_num_threads(1)

SOLVERS = ("f64", "mixed", "refined", "pallas", "pallas_rescued")
STATS = ("mean_iterations", "success_rate", "kkt_pass_rate")


def np_batch(batch, n, m, act_frac):
    """random_qp_batch's distribution in numpy, seeded by the shape."""
    rng = np.random.default_rng([batch, n, m, round(100 * act_frac)])
    A = rng.standard_normal((batch, n, n))
    G = A @ A.transpose(0, 2, 1) / n + np.eye(n)
    C = rng.standard_normal((batch, m, n))
    x0 = rng.uniform(-1.0, 1.0, (batch, n))
    cx = np.einsum("bij,bj->bi", C, x0)
    tight = np.arange(m) < int(act_frac * min(n, m))
    l = cx - np.where(tight, 0.0, 3.0 * rng.uniform(0.01, 1.0, (batch, m)))
    return dict(G=G, a=rng.standard_normal((batch, n)), C=C, l=l,
                u=cx + 3.0 * rng.uniform(0.01, 1.0, (batch, m)),
                xl=np.full((batch, n), -np.inf),
                xu=np.full((batch, n), np.inf), objcst=np.zeros(batch))


@pytest.fixture
def shared_batches(monkeypatch):
    """Both harness modules draw their problems from :func:`np_batch`; the
    JAX kernels run in interpret mode."""
    def jax_gen(key, batch, n, m, act_frac=0.3, **kw):
        return JProblem(**{k: jnp.asarray(v) for k, v in
                           np_batch(batch, n, m, act_frac).items()})

    def torch_gen(gen, batch, n, m, act_frac=0.3, **kw):
        return problem_from_numpy(**np_batch(batch, n, m, act_frac),
                                  device=gen.device)

    monkeypatch.setattr(jh, "random_qp_batch", jax_gen)
    monkeypatch.setattr(th, "random_qp_batch", torch_gen)
    for name in ("solve_refined_pallas", "solve_refined_pallas_carry",
                 "solve_refined_pallas_rescued"):
        monkeypatch.setattr(jfast, name, functools.partial(
            getattr(jfast, name), interpret=True))


def same_rows(ours, ref, stats=()):
    """Equal names, keys (in order) and ``stats`` values, row by row."""
    def d(r):
        return r.row() if dataclasses.is_dataclass(r) else r

    ours, ref = [d(r) for r in ours], [d(r) for r in ref]
    assert [r["name"] for r in ours] == [r["name"] for r in ref]
    assert [list(r) for r in ours] == [list(r) for r in ref]
    for a, b in zip(ours, ref):
        for k in stats:
            assert a[k] == b[k], (a["name"], k, a[k], b[k])


@pytest.mark.parametrize("solver", SOLVERS)
def test_time_batch_matches_jax(shared_batches, solver):
    before = (gi_kernel.launches, gi_kernel.loop_launches)
    ours = th.bench_size_sweep(sizes=(6,), batch=8, solver=solver,
                               device="cpu")
    ref = jh.bench_size_sweep(sizes=(6,), batch=8, solver=solver)
    same_rows(ours, ref, STATS)
    assert ours[0].name == "size/n=6/m=12" and ours[0].batch == 8
    assert ours[0].kkt_pass_rate == 1.0
    assert ours[0].max_kkt_residual <= 1e-8
    assert ours[0].us_per_solve == pytest.approx(
        ours[0].wall_s / 8 * 1e6)
    # CPU tensors run the plain versions: no CUDA launch is counted
    assert (gi_kernel.launches, gi_kernel.loop_launches) == before


def test_active_sweep_matches_jax(shared_batches):
    ours = th.bench_active_sweep(n=6, m=12, fracs=(0.0, 0.5), batch=8,
                                 solver="f64", device="cpu")
    ref = jh.bench_active_sweep(n=6, m=12, fracs=(0.0, 0.5), batch=8,
                                solver="f64")
    same_rows(ours, ref, STATS)
    assert [r.name for r in ours] == ["active/0%", "active/50%"]


def test_scaling_rows(shared_batches):
    kw = dict(mesh_sizes=(1, 2, 4), n=5, m=8, per_device_batch=2,
              engine="f64")
    ours = th.bench_scaling(**kw, devices=[torch.device("cpu")] * 2)
    ref = jh.bench_scaling(**{**kw, "mesh_sizes": (1, 2)}, platform="cpu")
    same_rows(ours, ref, ("mesh_size", "platform", "batch", "success_rate"))
    assert [r["name"] for r in ours] == ["scaling/f64/mesh=1/cpu",
                                         "scaling/f64/mesh=2/cpu"]
    assert ours[0]["efficiency"] == 1.0


def test_time_batch_on_its_own_draws():
    """Unpatched, the port draws from a torch.Generator seeded with
    ``seed``: the same seed gives the same batch and statistics."""
    a = th.bench_size_sweep(sizes=(5,), batch=4, solver="pallas",
                            device="cpu")
    b = th.bench_size_sweep(sizes=(5,), batch=4, solver="pallas",
                            device="cpu")
    c = th.bench_size_sweep(sizes=(5,), batch=4, solver="pallas", seed=1,
                            device="cpu")
    assert [getattr(a[0], k) for k in STATS] == [getattr(b[0], k)
                                                  for k in STATS]
    assert a[0].success_rate == c[0].success_rate == 1.0


def test_unknown_solver_raises():
    # the JAX harness falls back to "f64" for any other name
    pbs = problem_from_numpy(**np_batch(2, 3, 4, 0.3), device="cpu")
    with pytest.raises(ValueError, match="unknown solver"):
        th.time_batch("x", pbs, solver="f32")
    with pytest.raises(ValueError, match="unknown solver"):
        th.bench_warm_start_trajectory(n=3, m=4, steps=2, batch=2,
                                       solver="refined", device="cpu")
