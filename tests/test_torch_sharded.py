"""Mesh-sharded batch solves of the port (``jrlqp_tpu_torch.parallel``) on a
mesh of 8 CPU devices, mirroring tests/test_sharded.py: the engines "f64",
"refined" and "pallas" (both ``fused_init`` values) sharded against the
same engine unsharded (status, iterations and active set equal, x within
1e-12) and against the JAX ``solve_sharded`` on its 8 virtual devices
(status and active set equal); ``BatchStats`` exact; ``make_mesh`` raising
where there are too few CUDA devices. The shards run at the same time (each
waits at a barrier of all of them), a failing shard's error reaches the
caller once every shard has ended, and each engine's lanes are bit for bit
those of its shards solved alone."""
import dataclasses
import threading
import time

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
from jrlqp_tpu_torch.parallel import mesh as mesh_mod
from jrlqp_tpu_torch.solver.fast import solve_refined
from jrlqp_tpu_torch.solver.state import GIResult
from jrlqp_tpu_torch.testing import shard_timeline
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


@pytest.mark.parametrize("engine,fused_init", ENGINES)
def test_shards_run_at_the_same_time(batch, engine, fused_init, monkeypatch):
    # each shard waits at a barrier of all the mesh's shards before its
    # engine runs: only shards solved at the same time get through it (one
    # after another, the first waits out the timeout and it breaks)
    _, pb, _ = batch
    mesh = make_mesh(devices=CPU8)
    # the host-loop engines run on threads too where _THREADED_ENGINES says
    monkeypatch.setattr(mesh_mod, "_THREADED_ENGINES", mesh_mod.ENGINES)
    barrier = threading.Barrier(mesh.size, timeout=10)
    solve_shard = mesh_mod._solve_shard
    threads = set()

    def at_the_barrier(shard, *args):
        threads.add(threading.get_ident())
        barrier.wait()
        return solve_shard(shard, *args)

    monkeypatch.setattr(mesh_mod, "_solve_shard", at_the_barrier)
    with shard_timeline.record(devices=["cpu"]) as tl:
        res, stats = solve_sharded(pb, SolverOptions(max_iter=MAX_ITER),
                                   mesh=mesh, engine=engine,
                                   fused_init=fused_init)
    assert len(threads) == mesh.size
    _assert_same(res, _unsharded(pb, engine, fused_init), 1e-12)
    _assert_stats(stats, res)
    ov = tl.overlap()
    assert [sh["lanes"] for sh in tl.shards] == [2] * mesh.size
    assert ov["shards"] == mesh.size and ov["calls_common_ms"] > 0, ov


def test_a_failing_shard_raises_once_every_shard_ended(batch, monkeypatch):
    # shards 2 and 5 fail at once, the others end 0.2 s later: the caller
    # gets shard 2's error, with shard 5's noted on it, after all six ended
    _, pb, _ = batch
    mesh = make_mesh(devices=CPU8)
    parts = shard_batch(pb, mesh)
    solve_shard = mesh_mod._solve_shard
    ended = []

    def failing(shard, *args):
        i = next(i for i, p in enumerate(parts) if torch.equal(p.a, shard.a))
        if i in (2, 5):
            raise RuntimeError(f"shard {i} failed")
        time.sleep(0.2)
        out = solve_shard(shard, *args)
        ended.append(i)
        return out

    monkeypatch.setattr(mesh_mod, "_solve_shard", failing)
    with pytest.raises(RuntimeError, match="shard 2 failed") as err:
        solve_sharded(pb, SolverOptions(max_iter=MAX_ITER), mesh=mesh,
                      engine="pallas")
    assert sorted(ended) == [0, 1, 3, 4, 6, 7]
    notes = getattr(err.value, "__notes__", [])
    assert len(notes) == 1 and "shard 5 failed" in notes[0], notes
    # the next solve runs as before
    monkeypatch.setattr(mesh_mod, "_solve_shard", solve_shard)
    res, _ = solve_sharded(pb, SolverOptions(max_iter=MAX_ITER), mesh=mesh,
                           engine="pallas")
    _assert_same(res, _unsharded(pb, "pallas", False), 1e-12)


def test_every_shard_is_moved_before_any_is_solved(batch, monkeypatch):
    # a solve queued on the input's card ahead of another card's copy would
    # hold that copy back: every worker issues its moves first, and a move
    # that fails (shard 3's) is raised once every other shard was solved
    _, pb, _ = batch
    mesh = make_mesh(devices=CPU8)
    parts = shard_batch(pb, mesh)
    to, solve_shard = mesh_mod._to, mesh_mod._solve_shard
    order = []

    def index(shard):
        return next(i for i, p in enumerate(parts) if torch.equal(p.a, shard.a))

    def moving(part, dev):
        i = index(part)
        time.sleep(0.02 * i)        # shard 7's move ends 0.14 s after 0's
        order.append(("move", i))
        if i == 3:
            raise RuntimeError("shard 3 could not be moved")
        return to(part, dev)

    def solving(shard, *args):
        order.append(("solve", index(shard)))
        return solve_shard(shard, *args)

    monkeypatch.setattr(mesh_mod, "_to", moving)
    monkeypatch.setattr(mesh_mod, "_solve_shard", solving)
    with pytest.raises(RuntimeError, match="shard 3 could not be moved"):
        solve_sharded(pb, SolverOptions(max_iter=MAX_ITER), mesh=mesh,
                      engine="pallas")
    assert [k for k, _ in order] == ["move"] * 8 + ["solve"] * 7, order
    assert sorted(i for k, i in order if k == "solve") == [
        0, 1, 2, 4, 5, 6, 7]


@pytest.mark.parametrize("engine,fused_init", ENGINES)
def test_sharded_lanes_are_the_shards_solved_alone(batch, engine,
                                                    fused_init):
    _, pb, _ = batch
    mesh = make_mesh(devices=CPU8)
    res, _ = solve_sharded(pb, SolverOptions(max_iter=MAX_ITER), mesh=mesh,
                           engine=engine, fused_init=fused_init)
    alone = [_unsharded(shard, engine, fused_init)
             for shard in shard_batch(pb, mesh)]
    for f in dataclasses.fields(GIResult):
        want = torch.cat([getattr(r, f.name) for r in alone])
        assert torch.equal(getattr(res, f.name), want), f.name


def test_a_card_named_several_times_gets_one_worker(batch, monkeypatch):
    # shards on one CUDA card share one worker, which solves them in order;
    # each CPU entry is a device of its own
    cuda = [torch.device("cuda", i) for i in range(2)]
    cpu = torch.device("cpu")
    assert mesh_mod._workers([cuda[0], cuda[1], cuda[0], cpu, cpu]) == [
        [0, 2], [1], [3], [4]]
    # a worker of several shards runs on past a failing one: shard 1
    # fails, shards 2 and 3 of its worker still end, shard 6 fails too
    _, pb, _ = batch
    mesh = make_mesh(devices=CPU8)
    parts = shard_batch(pb, mesh)
    monkeypatch.setattr(mesh_mod, "_workers",
                        lambda devices: [[0, 1, 2, 3], [4, 5, 6, 7]])
    solve_shard = mesh_mod._solve_shard
    ended = []

    def failing(shard, *args):
        i = next(i for i, p in enumerate(parts) if torch.equal(p.a, shard.a))
        if i in (1, 6):
            raise RuntimeError(f"shard {i} failed")
        out = solve_shard(shard, *args)
        ended.append(i)
        return out

    monkeypatch.setattr(mesh_mod, "_solve_shard", failing)
    with pytest.raises(RuntimeError, match="shard 1 failed") as err:
        solve_sharded(pb, SolverOptions(max_iter=MAX_ITER), mesh=mesh,
                      engine="pallas")
    assert sorted(ended) == [0, 2, 3, 4, 5, 7]
    assert "shard 6 failed" in err.value.__notes__[0]
    monkeypatch.setattr(mesh_mod, "_solve_shard", solve_shard)
    res, _ = solve_sharded(pb, SolverOptions(max_iter=MAX_ITER), mesh=mesh,
                           engine="pallas")
    _assert_same(res, _unsharded(pb, "pallas", False), 1e-12)


@pytest.mark.parametrize("engine,fused_init", ENGINES)
def test_which_engines_run_on_threads(batch, engine, fused_init,
                                      monkeypatch):
    # the kernel engine's shards run on a thread each; the host-loop
    # engines' one after another in the caller's thread, in shard order
    _, pb, _ = batch
    mesh = make_mesh(devices=CPU8)
    parts = shard_batch(pb, mesh)
    solve_shard = mesh_mod._solve_shard
    calls = []

    def noting(shard, *args):
        i = next(i for i, p in enumerate(parts) if torch.equal(p.a, shard.a))
        calls.append((i, threading.get_ident()))
        return solve_shard(shard, *args)

    monkeypatch.setattr(mesh_mod, "_solve_shard", noting)
    res, _ = solve_sharded(pb, SolverOptions(max_iter=MAX_ITER), mesh=mesh,
                           engine=engine, fused_init=fused_init)
    _assert_same(res, _unsharded(pb, engine, fused_init), 1e-12)
    threads = {t for _, t in calls}
    if engine in mesh_mod._THREADED_ENGINES:
        assert len(calls) == mesh.size and len(threads) == mesh.size
        assert threading.get_ident() not in threads
    else:
        assert threads == {threading.get_ident()}
        assert [i for i, _ in calls] == list(range(mesh.size))
