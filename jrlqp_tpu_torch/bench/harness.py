"""Benchmark harness: timing fixtures mirroring the reference's
google-benchmark suite (ref: benchmarks/Solvers.cpp:613-639,
benchmarks/SolversWarmStart.cpp:218-276, benchmarks/Decomposition.cpp).

Counterpart of :mod:`jrlqp_tpu.bench.harness`: the same functions, row
names and dictionary keys, so the two packages' rows line up. The unit of
work is a batch: every fixture reports us/solve = wall time / batch and
solves/s, plus mean GI iterations (the reference's ``it`` counter,
SolversWarmStart.cpp:250).

``solver=`` and ``engine=`` keep the JAX package's names: ``"pallas"`` is
:func:`~jrlqp_tpu_torch.solver.fast.solve_refined_kernel` (K1),
``"pallas_rescued"`` :func:`~jrlqp_tpu_torch.solver.fast.
solve_refined_kernel_rescued`, ``"refined"`` the torch-loop engine
:func:`~jrlqp_tpu_torch.solver.fast.solve_refined`, ``"mixed"``
:func:`~jrlqp_tpu_torch.solver.mixed.solve_mixed` and ``"f64"`` the J/R
engine :func:`~jrlqp_tpu_torch.solver.dense.solve_batch`; another name
raises. Every function draws its problems on ``device`` (the card unless
the caller names another): ``random_qp_batch`` with a ``torch.Generator``
seeded from ``seed`` there, or the JAX harness's numpy draws where it made
them with numpy. A CUDA batch runs the kernels, a CPU batch their plain
versions.

Timing: a warm-up call outside the clock, then the best of ``n_rep``
calls, each closed by ``torch.cuda.synchronize`` (a no-op on the CPU). An
error raises: nothing is retried and no row is dropped.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..problems import QPProblem
from ..solver.dense import solve_batch
from ..solver.mixed import solve_mixed
from ..solver.warm_start import solve_warm
from ..testing.batch_gen import random_qp_batch
from ..testing.kkt import kkt_residual
from ..types import SolverOptions

__all__ = [
    "BenchResult",
    "time_batch",
    "bench_size_sweep",
    "bench_active_sweep",
    "bench_warm_start_trajectory",
    "bench_decompositions",
    "bench_structured_ik",
    "bench_scaling",
    "bench_box_single",
]


@dataclasses.dataclass
class BenchResult:
    name: str
    batch: int
    wall_s: float
    us_per_solve: float
    solves_per_sec: float
    mean_iterations: float
    max_kkt_residual: float
    success_rate: float
    kkt_pass_rate: float  # fraction with SUCCESS *and* KKT <= 1e-8

    def row(self) -> dict:
        return dataclasses.asdict(self)


def _sync(*devices) -> None:
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def _timeit(fn: Callable, devices: Sequence, n_rep: int = 3):
    """(the value of a warm-up call of ``fn``, the best wall seconds of
    ``n_rep`` further calls), each call closed by a sync of ``devices``."""
    out = fn()
    _sync(*devices)
    best = float("inf")
    for _ in range(n_rep):
        t0 = time.perf_counter()
        fn()
        _sync(*devices)
        best = min(best, time.perf_counter() - t0)
    return out, best


def _solver(solver: str) -> Callable:
    """The batched solve ``run(pbs, opt)`` behind a JAX solver name."""
    from ..solver import fast

    solvers = {"f64": solve_batch, "mixed": solve_mixed,
               "refined": fast.solve_refined,
               "pallas": fast.solve_refined_kernel,
               "pallas_rescued": fast.solve_refined_kernel_rescued}
    if solver not in solvers:
        raise ValueError(f"unknown solver {solver!r}, expected one of "
                         f"{tuple(solvers)}")
    return solvers[solver]


def _qp_batch(seed: int, batch: int, n: int, m: int, act_frac: float,
              device) -> QPProblem:
    """``random_qp_batch`` from a generator seeded with ``seed`` on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return random_qp_batch(gen, batch, n, m, act_frac=act_frac)


def _rate(mask: torch.Tensor) -> float:
    return float(mask.double().mean())


def time_batch(
    name: str,
    pbs: QPProblem,
    opt: SolverOptions = SolverOptions(max_iter=500),
    solver: str = "f64",
    n_rep: int = 3,
) -> BenchResult:
    """Time one batched solve on the batch's device (the warm-up call gives
    the statistics). ``max_kkt_residual`` is over SUCCESS lanes only."""
    run = _solver(solver)
    res, wall = _timeit(lambda: run(pbs, opt), [pbs.G.device], n_rep)
    batch = pbs.batch
    resid = kkt_residual(res.x, res.multipliers, pbs)
    ok = res.status == 0
    return BenchResult(
        name=name,
        batch=batch,
        wall_s=wall,
        us_per_solve=wall / batch * 1e6,
        solves_per_sec=batch / wall,
        mean_iterations=float(res.iterations.double().mean()),
        max_kkt_residual=float(torch.where(ok, resid, 0.0).max()),
        success_rate=_rate(ok),
        kkt_pass_rate=_rate(ok & (resid <= 1e-8)),
    )


def bench_size_sweep(
    sizes=(10, 25, 50, 75, 100),
    batch: int = 64,
    solver: str = "f64",
    seed: int = 0,
    device="cuda",
) -> list[BenchResult]:
    """Variables sweep at m = 2n (ref: Solvers.cpp size sweep 10-100 vars)."""
    out = []
    for n in sizes:
        pbs = _qp_batch(seed, batch, n, 2 * n, 0.3, device)
        out.append(time_batch(f"size/n={n}/m={2 * n}", pbs, solver=solver))
    return out


def bench_active_sweep(
    n: int = 50,
    m: int = 100,
    fracs=(0.0, 0.1, 0.3, 0.5, 0.8, 0.95),
    batch: int = 64,
    solver: str = "f64",
    seed: int = 0,
    device="cuda",
) -> list[BenchResult]:
    """Active-fraction sweep (ref: Solvers.cpp %active fixtures)."""
    out = []
    for fr in fracs:
        pbs = _qp_batch(seed, batch, n, m, fr, device)
        out.append(time_batch(f"active/{int(fr * 100)}%", pbs, solver=solver))
    return out


def bench_warm_start_trajectory(
    n: int = 20,
    m: int = 40,
    steps: int = 100,
    batch: int = 32,
    shift_scale: float = 0.02,
    seed: int = 0,
    solver: str = "f64",
    time_window: int = 20,
    device="cuda",
) -> dict:
    """Control-loop trajectory benchmark
    (ref: benchmarks/SolversWarmStart.cpp:31-59,162-169): a batch of QPs
    whose bounds drift a little each step; the warm solver carries the
    previous step's state. Reports mean iterations/step (step 0 excluded
    for the warm run: it is a cold solve) and us/solve, warm vs cold.

    ``solver="pallas"`` drives :func:`~jrlqp_tpu_torch.solver.fast.
    solve_refined_kernel_carry` step by step from the host (K1, then K4
    steps), against a cold :func:`~jrlqp_tpu_torch.solver.fast.
    solve_refined_kernel` per step; its time is the wall clock of the
    steps 2..``time_window`` (step 0 builds, step 1 settles), the same
    window for the warm and the cold run, scaled to ``steps``.
    ``solver="f64"`` runs a host loop of the J/R
    :func:`~jrlqp_tpu_torch.solver.warm_start.solve_warm` from the previous
    step's active set, against a cold ``solve_batch`` per step, each
    trajectory timed whole. The drifts are drawn once, before the loop."""
    opt = SolverOptions(max_iter=100, warm_start=True)
    base = _qp_batch(seed, batch, n, m, 0.4, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    drifts = shift_scale * torch.randn((steps, batch, m), generator=gen,
                                       dtype=base.l.dtype, device=device)

    def shifted(d):
        return dataclasses.replace(base, l=base.l + d, u=base.u + d)

    if solver == "pallas":
        from ..solver.fast import (
            solve_refined_kernel,
            solve_refined_kernel_carry,
        )

        def run_traj(warm: bool):
            carry = None
            its, sts, t0, t_win = [], [], None, None
            for s_i in range(steps):
                pbs = shifted(drifts[s_i])
                if warm:
                    res, carry = solve_refined_kernel_carry(pbs, carry, opt)
                else:
                    res = solve_refined_kernel(pbs, opt)
                _sync(device)
                if s_i == 1:
                    t0 = time.perf_counter()
                its.append(res.iterations)
                sts.append(res.status)
                if t0 is not None and s_i == min(steps - 1, time_window):
                    t_win = (time.perf_counter() - t0) / (s_i - 1 + 1e-12)
            return (torch.stack(its), torch.stack(sts),
                    t_win * steps if t_win is not None else 0.0)

        its_w, sts_w, t_w = run_traj(True)
        its_c, sts_c, t_c = run_traj(False)
    elif solver == "f64":
        def run_warm():
            hints = torch.zeros((batch, m + n), dtype=torch.int32,
                                device=device)
            its, sts = [], []
            for d in drifts:
                res = solve_warm(shifted(d), hints, opt)
                hints = res.active_set
                its.append(res.iterations)
                sts.append(res.status)
            return torch.stack(its), torch.stack(sts)

        def run_cold():
            res = [solve_batch(shifted(d), opt) for d in drifts]
            return (torch.stack([r.iterations for r in res]),
                    torch.stack([r.status for r in res]))

        (its_w, sts_w), t_w = _timeit(run_warm, [device])
        (its_c, sts_c), t_c = _timeit(run_cold, [device])
    else:
        raise ValueError(f"unknown solver {solver!r}, expected 'f64' or "
                         f"'pallas'")

    n_solves = steps * batch
    return dict(
        name=f"warm_start_trajectory/{solver}/n={n}/m={m}/steps={steps}",
        batch=batch,
        steps=steps,
        warm_mean_it=float(its_w[1:].double().mean()),
        cold_mean_it=float(its_c.double().mean()),
        warm_us_per_solve=t_w / n_solves * 1e6,
        cold_us_per_solve=t_c / n_solves * 1e6,
        warm_success=_rate(sts_w == 0),
        cold_success=_rate(sts_c == 0),
    )


def bench_scaling(
    mesh_sizes=(1, 2, 4, 8),
    n: int = 50,
    m: int = 100,
    per_device_batch: int = 256,
    engine: str = "f64",
    seed: int = 0,
    devices: Optional[Sequence] = None,
) -> list[dict]:
    """Weak-scaling capture over a device mesh (BASELINE.md scaling row):
    solves/s at each mesh size with a fixed per-device batch, through
    :func:`~jrlqp_tpu_torch.parallel.solve_sharded` (``fused_init`` for
    the "pallas" engine, K1). ``devices`` defaults to every CUDA card; a
    mesh size larger than the device count is skipped. CPU devices run
    only where the caller names them. Efficiency is relative to the
    smallest mesh run (perfect weak scaling = 1.0)."""
    from ..parallel.mesh import make_mesh, solve_sharded

    all_devs = make_mesh(devices=devices).devices
    rows = []
    base_rate = None
    for nd in mesh_sizes:
        if len(all_devs) < nd:
            continue
        mesh = make_mesh(devices=all_devs[:nd])
        dev0 = mesh.devices[0]
        platform = "gpu" if dev0.type == "cuda" else dev0.type
        batch = per_device_batch * nd
        pbs = _qp_batch(seed, batch, n, m, 0.3, dev0)
        (res, _), wall = _timeit(lambda: solve_sharded(
            pbs, SolverOptions(max_iter=150), mesh=mesh, engine=engine,
            fused_init=engine == "pallas"), mesh.devices)
        rate = batch / wall
        if base_rate is None:
            base_rate = rate / nd  # per-device rate at the smallest mesh
        rows.append(dict(
            name=f"scaling/{engine}/mesh={nd}/{platform}",
            mesh_size=nd,
            platform=platform,
            batch=batch,
            solves_per_sec=rate,
            us_per_solve=wall / batch * 1e6,
            efficiency=rate / (base_rate * nd),
            success_rate=_rate(res.status == 0),
        ))
    return rows


def bench_box_single(
    n: int = 16,
    batch: int = 1024,
    seed: int = 0,
    n_rep: int = 3,
    device="cuda",
) -> dict:
    """Box-and-single-constraint batch (BASELINE config 2 / ref
    benchmarks/BoxAndSingleConstraintSolver.cpp): 1k+ small
    min |x - x0|^2 s.t. c'x >= bl, box problems, through the closed-form
    :func:`~jrlqp_tpu_torch.solver.box_single.solve_box`; the JAX
    harness's numpy draws."""
    from ..solver.box_single import solve_box

    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((batch, n))
    c = rng.standard_normal((batch, n))
    xl = -np.abs(rng.standard_normal((batch, n))) - 0.1
    xu = np.abs(rng.standard_normal((batch, n))) + 0.1
    bl = (np.sum(c * np.clip(x0, xl, xu), axis=1)
          + rng.uniform(-0.5, 0.5, batch))
    args = [torch.from_numpy(v).to(device) for v in (x0, c, bl, xl, xu)]
    opt = SolverOptions(max_iter=3 * n)
    res, wall = _timeit(lambda: solve_box(*args, opt), [device], n_rep)
    return dict(
        name=f"box_single/n={n}",
        batch=batch,
        wall_s=wall,
        us_per_solve=wall / batch * 1e6,
        solves_per_sec=batch / wall,
        mean_iterations=float(res.iterations.double().mean()),
        success_rate=_rate(res.status == 0),
    )


def decomposition_inputs(nb: int, s: int, batch: int, seed: int = 0):
    """The numpy (diag, off) of :func:`bench_decompositions`: the JAX
    harness's draws, f64, diag (batch, nb, s, s) symmetric positive
    definite, off (batch, nb - 1, s, s)."""
    rng = np.random.default_rng(seed)
    diag = np.zeros((batch, nb, s, s))
    off = rng.standard_normal((batch, nb - 1, s, s))
    for b in range(batch):
        for i in range(nb):
            A = rng.standard_normal((s, s))
            diag[b, i] = A @ A.T + nb * s * np.eye(s)
    return diag, off


def bench_decompositions(
    nb: int = 9, s: int = 48, batch: int = 16, seed: int = 0,
    include_f64: bool = True, device="cuda",
) -> list[dict]:
    """Structured vs dense Cholesky timings (ref: benchmarks/Decomposition.cpp
    and the IK timing harness in tests/BlockGISolverTest.in.cpp:251-268).

    The ``_pallas`` rows are the kernels: K5 (``tri_block_llt``), K7
    (``block_arrow_llt``) and K5 + K6 on the shared identity
    (``block_llt.identity_rhs``: everything a solver init needs). The f64
    rows without the suffix are the composed chains
    (:mod:`jrlqp_tpu_torch.structured.blocks`); ``dense`` and ``dense_f32``
    are ``torch.linalg.cholesky`` of the dense matrix, the comparison.
    Rows carry ``speedup_vs_dense`` relative to the same-precision dense
    factor. The JAX harness's numpy draws."""
    from ..ops.cuda import block_llt
    from ..structured.blocks import (
        block_arrow_llt,
        tri_block_diag_llt,
        tri_block_to_dense,
    )

    diag, off = (torch.from_numpy(v).to(device)
                 for v in decomposition_inputs(nb, s, batch, seed))
    diag32, off32 = diag.float(), off.float()

    if include_f64:
        dense_in = tri_block_to_dense(diag, off)
        dense_in32 = dense_in.float()
    else:  # skip the f64 dense assembly (memory: B n^2 doubles)
        dense_in32 = tri_block_to_dense(diag32, off32)
    n = nb * s
    eye_b = block_llt.identity_rhs(batch, nb, s, device=diag.device)

    def tri_p_full(d, o):
        _, Lo, Li = block_llt.tri_block_llt(d, o)
        return block_llt.tri_block_solve(Lo, Li, eye_b)

    def seconds(fn):
        return _timeit(fn, [device])[1]

    t_dense32 = seconds(lambda: torch.linalg.cholesky(dense_in32))
    t_tri_p = seconds(lambda: block_llt.tri_block_llt(diag32, off32))
    t_arrow_p = seconds(lambda: block_llt.block_arrow_llt(diag32, off32))
    t_tri_pf = seconds(lambda: tri_p_full(diag32, off32))
    if include_f64:
        t_tri = seconds(lambda: tri_block_diag_llt(diag, off))
        t_arrow = seconds(lambda: block_arrow_llt(diag, off))
        t_dense = seconds(lambda: torch.linalg.cholesky(dense_in))

    def row(name, t, t_ref=None):
        r = dict(name=f"{name}/batch={batch}", ms=t / batch * 1e3)
        if t_ref is not None:
            r["speedup_vs_dense"] = t_ref / t
        return r

    rows = []
    if include_f64:
        rows += [
            row(f"llt/tri_block/nb={nb}/s={s}", t_tri, t_dense),
            row(f"llt/block_arrow/nb={nb}/s={s}", t_arrow, t_dense),
            row(f"llt/dense/n={n}", t_dense),
        ]
    rows += [
        row(f"llt/dense_f32/n={n}", t_dense32),
        row(f"llt/tri_block_pallas/nb={nb}/s={s}", t_tri_p, t_dense32),
        row(f"llt/block_arrow_pallas/nb={nb}/s={s}", t_arrow_p, t_dense32),
        row(f"llt+inv/tri_block_pallas_fused/nb={nb}/s={s}", t_tri_pf,
            t_dense32),
    ]
    return rows


def bench_structured_ik(
    nb: int = 9, s: int = 43, mc: int = 4, batch: int = 16, seed: int = 0,
    device="cuda",
) -> list[dict]:
    """Batched IK-shaped workload end-to-end through the structured fast
    path (ref workload: tests/BlockGISolverTest.in.cpp:172-271 'Sequential
    IK', 9 robots x 43 dof, inline timing at :251-268). Solves a batch of
    tri-block-diagonal QPs with block-diagonal constraints by
    :func:`~jrlqp_tpu_torch.structured.solve_structured_fast_batch` on the
    kernels K5 + K6 (``backend="auto"``, the ``structured_fast_pallas``
    row) and on the composed blocks (``"blocks"``, the
    ``structured_fast_xla`` row), and by the dense engine
    :func:`~jrlqp_tpu_torch.solver.fast.solve_refined` (``dense_fast``),
    reporting ms/solve and the agreement with the first row. The JAX
    harness's numpy draws."""
    from ..solver.fast import solve_refined
    from ..structured.containers import GType, StructuredC, StructuredG
    from ..structured.solver import (
        solve_structured_fast_batch,
        structured_qp_problem,
    )

    rng = np.random.default_rng(seed)
    n, m = nb * s, nb * mc
    diag = np.zeros((batch, nb, s, s))
    off = rng.standard_normal((batch, nb - 1, s, s))
    blocks = rng.standard_normal((batch, nb, mc, s))
    a = rng.standard_normal((batch, n))
    l_ = np.zeros((batch, m))
    u_ = np.zeros((batch, m))
    for b in range(batch):
        for i in range(nb):
            A = rng.standard_normal((s, s))
            diag[b, i] = A @ A.T + nb * s * np.eye(s)
        x0 = rng.uniform(-1, 1, n)
        Cd = np.zeros((m, n))
        for i in range(nb):
            Cd[i * mc:(i + 1) * mc, i * s:(i + 1) * s] = blocks[b, i]
        cx = Cd @ x0
        l_[b] = cx - rng.uniform(0.0, 0.5, m)
        u_[b] = cx + rng.uniform(0.0, 2.0, m)

    def on_device(v):
        return torch.from_numpy(v).to(device)

    sgs = StructuredG(diag=on_device(diag), off=on_device(off),
                      gtype=int(GType.TRI_BLOCK_DIAGONAL))
    scs = StructuredC(blocks=on_device(blocks))
    a_b, l_b, u_b = on_device(a), on_device(l_), on_device(u_)
    opt = SolverOptions(max_iter=200)
    pbs = structured_qp_problem(sgs, a_b, scs, l_b, u_b)

    def batched(backend):
        return lambda: solve_structured_fast_batch(
            sgs, a_b, scs, l_b, u_b, opt=opt, backend=backend)

    rows = []
    ref_x = None
    for name, fn in [
        ("structured_fast_pallas", batched("auto")),
        ("structured_fast_xla", batched("blocks")),
        ("dense_fast", lambda: solve_refined(pbs, opt)),
    ]:
        res, t = _timeit(fn, [device])
        row = dict(name=f"ik/{name}/nb={nb}/s={s}/batch={batch}",
                   batch=batch,
                   ms_per_solve=t / batch * 1e3,
                   solves_per_sec=batch / t,
                   success_rate=_rate(res.status == 0))
        if ref_x is None:
            ref_x = res.x
        else:
            row["max_diff_vs_pallas"] = float((res.x - ref_x).abs().max())
        rows.append(row)
    return rows
