"""Mesh-sharded batch solves of the port (``jrlqp_tpu_torch.parallel``) on a
mesh of 8 CPU devices, mirroring tests/test_sharded.py: the engines "f64",
"refined" and "pallas" (both ``fused_init`` values) sharded against the
same engine unsharded (status, iterations and active set equal, x within
1e-12) and against the JAX ``solve_sharded`` on its 8 virtual devices
(status and active set equal); ``BatchStats`` exact; ``make_mesh`` raising
where there are too few CUDA devices."""
import jax
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.parallel import make_mesh as j_make_mesh
from jrlqp_tpu.parallel import solve_sharded as j_solve_sharded
from jrlqp_tpu.testing.batch_gen import random_qp_batch as j_random_qp_batch
from jrlqp_tpu_torch import (
    SolverOptions,
    problem_from_numpy,
    solve_batch,
    solve_refined_kernel,
)
from jrlqp_tpu_torch.parallel import (
    BatchStats,
    make_mesh,
    shard_batch,
    solve_sharded,
)
from jrlqp_tpu_torch.solver.fast import solve_refined
from jrlqp_tpu_torch.testing.kkt import kkt_residual

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
ENGINES = [("f64", False), ("refined", False), ("pallas", False),
           ("pallas", True)]
MAX_ITER = 60


@pytest.fixture(scope="module")
def batch():
    """The batch of tests/test_sharded.py (jax key 1, 16 x (7, 11)) as
    numpy, the port's problem and the JAX one."""
    jpbs = j_random_qp_batch(jax.random.key(1), 16, 7, 11, act_frac=0.4)
    arrs = {k: np.asarray(getattr(jpbs, k)) for k in
            ("G", "a", "C", "l", "u", "xl", "xu", "objcst")}
    return arrs, problem_from_numpy(**arrs, device="cpu"), jpbs


def _unsharded(pb, engine, fused_init):
    opt = SolverOptions(max_iter=MAX_ITER)
    if engine == "pallas":
        return solve_refined_kernel(pb, opt, fused_init=fused_init)
    if engine == "refined":
        return solve_refined(pb, opt)
    return solve_batch(pb, opt)


def _assert_same(res, ref, x_tol):
    for k in ("status", "iterations", "active_set"):
        np.testing.assert_array_equal(getattr(res, k).numpy(),
                                      getattr(ref, k).numpy(), err_msg=k)
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=x_tol, err_msg=f"x: atol {x_tol}")


def _assert_stats(stats, res):
    it = res.iterations.long()
    assert stats == BatchStats(total_iterations=int(it.sum()),
                               n_success=int((res.status == 0).sum()),
                               max_iterations=int(it.max()))


@pytest.mark.parametrize("engine,fused_init", ENGINES)
def test_sharded_matches_unsharded(batch, engine, fused_init):
    _, pb, _ = batch
    res, stats = solve_sharded(pb, SolverOptions(max_iter=MAX_ITER),
                               mesh=make_mesh(devices=CPU8), engine=engine,
                               fused_init=fused_init)
    ref = _unsharded(pb, engine, fused_init)
    _assert_same(res, ref, 1e-12)
    _assert_stats(stats, res)
    assert stats.n_success == 16
    resid = kkt_residual(res.x, res.multipliers, pb)
    assert float(resid.max()) <= 1e-8


@pytest.mark.parametrize("engine,fused_init", ENGINES)
def test_sharded_matches_jax(batch, engine, fused_init):
    _, pb, jpbs = batch
    res, stats = solve_sharded(pb, SolverOptions(max_iter=MAX_ITER),
                               mesh=make_mesh(devices=CPU8), engine=engine,
                               fused_init=fused_init)
    ref, jstats = j_solve_sharded(jpbs, JOptions(max_iter=MAX_ITER),
                                  mesh=j_make_mesh(8), engine=engine,
                                  fused_init=fused_init)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(res.active_set.numpy(),
                                  np.asarray(ref.active_set))
    assert stats.n_success == int(jstats.n_success)


def test_uneven_shards_and_repeated_device(batch):
    # 16 lanes over 3 devices: shards of 6, 5 and 5, in order
    _, pb, _ = batch
    mesh = make_mesh(devices=[torch.device("cpu")] * 3)
    shards = shard_batch(pb, mesh)
    assert [s.batch for s in shards] == [6, 5, 5]
    assert torch.equal(torch.cat([s.G for s in shards]), pb.G)
    res, stats = solve_sharded(pb, SolverOptions(max_iter=MAX_ITER),
                               mesh=mesh)
    _assert_same(res, _unsharded(pb, "f64", False), 1e-12)
    _assert_stats(stats, res)
    # more devices than lanes: the empty shards are skipped
    small = shard_batch(pb, make_mesh(devices=CPU8))[0]
    res2, stats2 = solve_sharded(small, SolverOptions(max_iter=MAX_ITER),
                                 mesh=make_mesh(devices=CPU8))
    assert res2.x.shape == (2, 7) and stats2.n_success == 2


def test_make_mesh_needs_the_cuda_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: make_mesh() takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="need 9 devices"):
        make_mesh(9, devices=CPU8)
    mesh = make_mesh(2, devices=CPU8)
    assert mesh.size == 2 and mesh.axis == "batch"


def test_unknown_engine_raises(batch):
    with pytest.raises(ValueError, match="unknown engine"):
        solve_sharded(batch[1], mesh=make_mesh(devices=CPU8), engine="fast")
