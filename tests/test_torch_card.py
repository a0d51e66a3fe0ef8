"""The port's kernels (K1-K14) on a CUDA card, held against their plain
PyTorch versions on the same card; the launch counts of the structured
path, the compact-slot path, the trajectory capture and the rescue; the
box solve, the sharded solve on one card and on several (its shards at the
same time, by CUDA events) and K3 at the corpus's largest
bucket; K1 at the size sweep's largest row, the compacted solve and the
harness's kernel rows; K10 (the J/R engine's loop) and K11 (the
explicit-form engine's loop) against their plain versions on each lane
kind, and a lane alone against its batch; the
default device; the lanes of the miss census
(``tests/data/missed_lanes_port.npz`` and ``missed_lanes_jax.npz``), each
solved alone by its path's kernel and plain version to its recorded
outcome; the numpy batch generators that the CPU tests share; and the
program's spans on the benchmark's three paths (every host sync a
``jrlqp.sync.*`` span, the stages covering the call, the loop span holding
its kernel; an IK warm step one K12 and one K11 launch and no host read)
and on a warm step of the dense control loop (one K4 launch, its stages
covering the call).

This file imports neither jax nor the JAX package, so it runs on a machine
with a card and no jax:

    python -m pytest --noconftest tests/test_torch_card.py -m cuda

Without a card every test here skips.
"""
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from jrlqp_tpu_torch import (
    SolverOptions,
    capture_kernel_trajectory,
    no_retrace,
    problem_from_numpy,
    solve_batch,
    solve_box,
    solve_refined_kernel_compact,
    solve_refined_kernel_compacted,
    solve_refined_kernel_rescued,
    stack_problems,
)
from jrlqp_tpu_torch.bench import bench_warm_start_trajectory, time_batch
from jrlqp_tpu_torch.ops.cuda import (
    block_llt,
    fast_loop,
    gi_kernel,
    struct_refine,
)
from jrlqp_tpu_torch.parallel import make_mesh, shard_batch, solve_sharded
from jrlqp_tpu_torch.parallel import mesh as mesh_mod
from jrlqp_tpu_torch.solver import dense, fast
from jrlqp_tpu_torch.structured import (
    GType,
    solve_structured_fast_batch,
    solve_structured_fast_carry,
    structured_from_numpy,
    structured_qp_problem,
)
from jrlqp_tpu_torch.structured import solver as ssolver
from jrlqp_tpu_torch.testing import (
    ProblemCharacteristics,
    fast_parting,
    k1_replay,
    miss_census,
    order_exact,
    random_problem,
    shard_timeline,
)
from jrlqp_tpu_torch.testing.batch_gen import random_qp_batch
from jrlqp_tpu_torch.testing.ik_gen import ik_batch, ik_step
from jrlqp_tpu_torch.testing.kkt import kkt_residual
from jrlqp_tpu_torch.utils import spans


def np_qp_batch(seed, batch, n, m, act_frac):
    """Numpy counterpart of random_qp_batch: G = A A^T / n + I, bounds
    around C x0 for an interior x0, the first act_frac*min(n, m) rows
    tight."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, n, n))
    G = A @ A.transpose(0, 2, 1) / n + np.eye(n)
    G = 0.5 * (G + G.transpose(0, 2, 1))
    C = rng.standard_normal((batch, m, n))
    x0 = rng.uniform(-1.0, 1.0, (batch, n))
    cx = np.einsum("bij,bj->bi", C, x0)
    off_l = rng.uniform(0.01, 1.0, (batch, m))
    off_u = rng.uniform(0.01, 1.0, (batch, m))
    tight = np.arange(m) < int(act_frac * min(n, m))
    return dict(G=G, a=rng.standard_normal((batch, n)), C=C,
                l=cx - np.where(tight, 0.0, 3.0 * off_l), u=cx + 3.0 * off_u,
                xl=np.full((batch, n), -np.inf),
                xu=np.full((batch, n), np.inf))


def drifted(d, scale, seed):
    """Batch ``d`` with l and u shifted together by scale * N(0, 1): the
    next step of a control-loop trajectory (G and C unchanged)."""
    shift = scale * np.random.default_rng(seed).standard_normal(
        d["l"].shape)
    return dict(d, l=d["l"] + shift, u=d["u"] + shift)


def _eq_fixed(d):
    d["l"][:, 0] = d["u"][:, 0]          # constraint 0 equality
    d["l"][:, 3] = d["u"][:, 3]          # constraint 3 equality
    d["xl"][:, 2] = d["xu"][:, 2] = 0.41  # variable 2 fixed


def _eq_lane_mix(d):
    d["l"][1, 2] = d["u"][1, 2]           # lane 1 only: equality
    d["xl"][3, 0] = d["xu"][3, 0] = -0.2  # lane 3 only: fixed variable


def _non_spd(d):
    n = d["G"].shape[1]
    d["G"][2] = np.diag([1.0] * (n - 1) + [-1.0])


# the batch kinds of tests/test_pallas_kernel.py
# name: (seed, batch, n, m, act_frac, max_iter, edit)
CASES = {
    "n8_m12": (0, 6, 8, 12, 0.4, 60, None),
    "n13_m7": (1, 4, 13, 7, 0.4, 60, None),
    "eq_fixed": (21, 6, 9, 6, 0.3, 80, _eq_fixed),
    "eq_lane_mix": (22, 4, 8, 10, 0.4, 80, _eq_lane_mix),
    "vertex_touch": (41, 12, 4, 16, 0.9, 120, None),
    "non_spd": (18, 4, 8, 12, 0.3, 60, _non_spd),
}


# (seed, batch, n, m, act_frac): batches whose kernel carry has a lane with
# a free slot before an active one
HOLES = {"holes_n8": (0, 16, 8, 16, 0.9), "holes_n10": (2, 16, 10, 20, 0.5)}


def make_case(name):
    """(numpy f64 arrays, max_iter) of a named batch."""
    seed, batch, n, m, act_frac, max_iter, edit = CASES[name]
    d = np_qp_batch(seed, batch, n, m, act_frac)
    if edit is not None:
        edit(d)
    return d, max_iter


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(6, 8), (50, 56)])
def test_chol_inv_b_kernel_matches_plain(cuda_device, n, s):
    d = np_qp_batch(9, 64, n, 1, 0.0)
    A = np.tile(np.eye(s), (64, 1, 1))
    A[:, :n, :n] = d["G"]
    A[1, n - 1, n - 1] = -1.0                 # one non-SPD block
    A = torch.from_numpy(A.astype(np.float32)).to(cuda_device)
    before = spans.counter("launch.chol_inv_b")
    L, Li, pd = block_llt.chol_inv_b(A)
    torch.cuda.synchronize()
    assert spans.counter("launch.chol_inv_b") == before + 1
    Lp = block_llt.chol_b_plain(A)
    Lip = block_llt.tri_inv_b_plain(Lp)
    assert torch.equal(pd, block_llt.posdef_plain(Lp)) and not bool(pd[1])
    torch.testing.assert_close(L[pd], Lp[pd], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(Li[pd], Lip[pd], rtol=1e-4, atol=1e-5)


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


def _k2_blocks(s):
    """64 f32 blocks of size s: G = A A^T / n + I of width n = min(s, 50),
    identity-padded to s as K1 pads G; block 1 not SPD, block 2 not
    symmetric."""
    n = min(s, 50)
    d = np_qp_batch(9 + s, 64, n, 1, 0.0)
    A = np.tile(np.eye(s), (64, 1, 1))
    A[:, :n, :n] = d["G"]
    A[1, n - 1, n - 1] = -1.0
    A[2] += 0.01 * np.random.default_rng(s).standard_normal((s, s))
    return torch.from_numpy(A.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [56, 43, 13])
def test_chol_inv_b_kernel_is_order_exact(cuda_device, s):
    # K2's L and L^-1 bit for bit against the same sums in the same order
    A = _k2_blocks(s)
    L, Li, pd = block_llt.chol_inv_b(A.to(cuda_device))
    torch.cuda.synchronize()
    L_ref, Li_ref = order_exact.k2_order_exact(A)
    assert not bool(pd[1]) and bool(pd[0])
    assert torch.equal(_bits(L), _bits(L_ref))
    assert torch.equal(_bits(Li), _bits(Li_ref))


@pytest.mark.cuda
def test_gi_fused_prologue_is_order_exact(cuda_device):
    # K1 at iteration cap 0: its K = [H0 | 0] with H0 = L^-T L^-1 summed
    # k ascending from max(i, j), x0 = -H0 a as one FMA chain per row,
    # and tr0, all bit for bit against the same loops here (L^-1 from
    # K2's own order); a non-SPD lane keeps H0 = I and x0 = 0
    d = np_qp_batch(31, 64, 50, 100, 0.3)
    d["G"][3] = np.diag([1.0] * 49 + [-1.0])
    pb = _f32_problem(d, cuda_device)
    ins, (n, m) = gi_kernel.prepare(pb)
    x, _, _, _, scal, K, tr0 = gi_kernel._gi_fused_cuda_raw(*ins, n, m, 0)
    torch.cuda.synchronize()
    G, a = ins[0].cpu(), ins[6].cpu()
    B, np_, _ = G.shape
    L, X = order_exact.k2_order_exact(G)
    pd = block_llt.posdef_plain(L)
    assert not bool(pd[3]) and int(pd.sum()) == B - 1
    idx = torch.arange(np_)
    first = torch.maximum(idx[:, None], idx[None, :])
    H = torch.zeros(B, np_, np_)
    for k in range(np_):
        H = torch.where(first <= k, H + X[:, k, :, None] * X[:, k, None, :],
                        H)
    H = torch.where(pd[:, None, None], H, torch.eye(np_))
    acc = torch.zeros(B, np_)
    for j in range(np_):
        acc = order_exact.fma32(H[:, :, j], a[:, j:j + 1].expand(B, np_),
                                acc)
    x_ref = torch.where(pd[:, None], -acc, 0.0)
    tr = torch.zeros(B)
    for k in range(np_):
        tr = tr + H[:, k, k]
    assert torch.equal(_bits(K[:, :, :np_]), _bits(H))
    assert bool((K[:, :, np_:] == 0).all())
    assert torch.equal(_bits(x), _bits(x_ref))
    assert torch.equal(_bits(tr0), _bits(torch.clamp_min(tr, 1e-30)))
    assert scal[:, 1].tolist() == [0] * B


def _assert_kernel_matches_plain(ours, ref):
    for k in ("term", "it", "q", "status", "aorder"):
        assert torch.equal(ours[k], ref[k]), k
    for k in ("x", "u", "H", "Ns"):
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=1e-4)


def _f32_problem(d, device):
    return problem_from_numpy(**{k: v.astype(np.float32)
                                 for k, v in d.items()}, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_gi_fused_kernel_matches_plain(cuda_device, name):
    d, max_iter = make_case(name)
    pb = _f32_problem(d, cuda_device)
    before = spans.counter("launch.K1")
    ours = gi_kernel.run_loop_fused(pb, max_iter)
    torch.cuda.synchronize()
    assert spans.counter("launch.K1") == before + 1
    _assert_kernel_matches_plain(ours, gi_kernel.gi_fused_plain(pb, max_iter))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_k1_order_solve_is_the_kernel(cuda_device, name):
    # K1's whole solve replayed on the CPU in K1's own order
    # (testing.k1_replay) on batches with equalities, fixed variables, a
    # non-SPD G and vertices of many rows: every lane's f32 state bit for
    # bit
    d, max_iter = make_case(name)
    ours = gi_kernel.run_loop_fused(_f32_problem(d, cuda_device), max_iter)
    torch.cuda.synchronize()
    for i in range(d["G"].shape[0]):
        raw = k1_replay.k1_order_solve({k: v[i] for k, v in d.items()},
                                       max_iter, 1)["raw"]
        for k in k1_replay.STATE_KEYS:
            assert np.array_equal(np.asarray(raw[k]),
                                  ours[k][i].cpu().numpy()), (i, k)
        assert np.array_equal(raw["x"].view(np.int32),
                              ours["x"][i].cpu().numpy().view(np.int32)), i


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_gi_loop_kernel_matches_plain(cuda_device, name):
    # K3 from the warm init of the cold active set, every second hint
    # cleared
    d, max_iter = make_case(name)
    cold = fast.solve_refined_kernel(problem_from_numpy(**d,
                                                        device=cuda_device),
                                     SolverOptions(max_iter=max_iter))
    hints = cold.active_set.clone()
    hints[:, ::2] = 0
    pb = _f32_problem(d, cuda_device)
    opt32 = SolverOptions(max_iter=max_iter, warm_start=True).with_(
        dtype=torch.float32, zero_z_threshold=1e-6)
    state0 = fast._init_fast_warm(pb, hints, opt32)
    before = spans.counter("launch.K3")
    ours = gi_kernel.run_loop(pb, state0, max_iter)
    torch.cuda.synchronize()
    assert spans.counter("launch.K3") == before + 1
    _assert_kernel_matches_plain(
        ours, gi_kernel.gi_loop_plain(pb, state0, max_iter))


@pytest.mark.cuda
@pytest.mark.parametrize("name,scale", [(k, 0.02) for k in CASES]
                         + [("n8_m12", 0.5)])
def test_gi_warm_kernel_matches_plain(cuda_device, name, scale):
    # K4 from the carry of a cold solve, on the drifted problem
    d, max_iter = make_case(name)
    _, carry = fast.solve_refined_kernel_carry(
        problem_from_numpy(**d, device=cuda_device), None,
        SolverOptions(max_iter=max_iter))
    pb = _f32_problem(drifted(d, scale, 7), cuda_device)
    co = (carry.H, carry.Ns, carry.status, carry.aorder, carry.q)
    before = spans.counter("launch.K4")
    ours = gi_kernel.run_warm_loop(pb, *co, max_iter)
    torch.cuda.synchronize()
    assert spans.counter("launch.K4") == before + 1
    _assert_kernel_matches_plain(
        ours, gi_kernel.gi_warm_plain(pb, *co, max_iter))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_solve_on_card_matches_cpu(cuda_device, name):
    d, max_iter = make_case(name)
    opt = SolverOptions(max_iter=max_iter)
    pb = problem_from_numpy(**d, device=cuda_device)
    res = fast.solve_refined_kernel(pb, opt, ir_steps=1)
    ref = fast.solve_refined_kernel(problem_from_numpy(**d, device="cpu"), opt, ir_steps=1)
    assert torch.equal(res.status.cpu(), ref.status)
    assert torch.equal(res.iterations.cpu(), ref.iterations)
    torch.testing.assert_close(res.x.cpu(), ref.x, rtol=0, atol=1e-7)
    ok = res.status == 0
    resid = kkt_residual(res.x, res.multipliers, pb)
    assert bool((resid[ok] <= 1e-8).all())


# K5-K8: (name, batch, nb, s) x kind; the tolerance is relative to the
# largest entry, as the kernels sum in another order than the plain versions
STRUCT_SHAPES = [("small", 8, 3, 8), ("ik", 64, 9, 43)]
STRUCT_KINDS = ["tri", "tri_lower", "arrow_down", "arrow_up"]


def struct_err(ours, ref):
    """max |ours - ref| / max(1, max |ref|)."""
    return float((ours - ref).abs().max() / ref.abs().max().clamp_min(1.0))


def struct_kernel_pairs(kind, diag, off):
    """[(name, kernel output, plain output)] of the factorization and the
    solve on the identity for one kind of chain; the kernels launch once
    each."""
    B, nb, s, _ = diag.shape
    n = nb * s
    eye = torch.eye(n, dtype=diag.dtype, device=diag.device)
    r = eye.reshape(1, nb, s, n).expand(B, nb, s, n)
    if kind.startswith("tri"):
        fac = block_llt.tri_block_llt(diag, off)
        fac_p = block_llt.tri_block_llt_plain(diag, off)
        lower = kind == "tri_lower"
        y = block_llt.tri_block_solve(fac[1], fac[2], r, lower_only=lower)
        y_p = block_llt.tri_block_solve_plain(fac[1], fac[2], r,
                                              lower_only=lower)
    else:
        up = kind == "arrow_up"
        fac = block_llt.block_arrow_llt(diag, off, up=up)
        fac_p = block_llt.block_arrow_llt_plain(diag, off, up=up)
        y = block_llt.block_arrow_solve(fac[1], fac[2], r, up=up)
        y_p = block_llt.block_arrow_solve_plain(fac[1], fac[2], r, up=up)
    return list(zip(("L_diag", "L_off", "Linv_diag", "y"), (*fac, y),
                    (*fac_p, y_p)))


def _struct_counts():
    return (spans.counter("launch.K5"), spans.counter("launch.K6"),
            spans.counter("launch.K7"), spans.counter("launch.K8"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STRUCT_KINDS)
@pytest.mark.parametrize("shape", STRUCT_SHAPES, ids=lambda t: t[0])
def test_struct_kernels_match_plain(cuda_device, shape, kind):
    _, B, nb, s = shape
    d = ik_batch(B, nb=nb, s=s, mc=2, seed=nb + s)
    diag = torch.from_numpy(d["diag"].astype(np.float32)).to(cuda_device)
    off = torch.from_numpy(d["off"].astype(np.float32)).to(cuda_device)
    before = _struct_counts()
    pairs = struct_kernel_pairs(kind, diag, off)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_struct_counts(), before)]
    assert launched == ([1, 1, 0, 0] if kind.startswith("tri")
                        else [0, 0, 1, 1])
    for name, ours, ref in pairs:
        assert ours.shape == ref.shape, name
        assert struct_err(ours, ref) <= 1e-5, name


# (B, nb, s): the IK shape's block size and chain, a chain of 16 heads, one
# of 70 blocks, an odd block wider than the IK one and the widest block
FACTOR_SHAPES = [(16, 3, 13), (8, 9, 43), (4, 17, 8), (2, 70, 8),
                 (3, 3, 61), (2, 3, 96)]


def _factor_inputs(B, nb, s):
    """f32 (diag, off) of an IK batch: problem 0's first diagonal block is
    not bitwise symmetric; problem 1's block 1 and last block are not SPD
    (their last pivot is clamped)."""
    d = ik_batch(B, nb=nb, s=s, mc=2, seed=11 * nb + s)
    diag, off = d["diag"].astype(np.float32), d["off"].astype(np.float32)
    rng = np.random.default_rng(s)
    diag[0, 0] += 0.01 * rng.standard_normal((s, s)).astype(np.float32)
    diag[1, min(1, nb - 1), s - 1, s - 1] = -1.0
    diag[1, nb - 1, s - 1, s - 1] = -1.0
    return torch.from_numpy(diag), torch.from_numpy(off)


@pytest.mark.cuda
@pytest.mark.parametrize("B,nb,s", FACTOR_SHAPES)
def test_tri_llt_kernel_is_order_exact(cuda_device, B, nb, s):
    # K5's L_diag, L_off and Linv_diag bit for bit against the same sums in
    # the same order on the CPU
    diag, off = _factor_inputs(B, nb, s)
    before = spans.counter("launch.K5")
    ours = block_llt.tri_block_llt(diag.to(cuda_device), off.to(cuda_device))
    torch.cuda.synchronize()
    assert spans.counter("launch.K5") == before + 1
    ref = order_exact.k5_order_exact(diag, off)
    assert not bool(block_llt.posdef_plain(ref[0][1, -1:]).any())
    for name, o, r in zip(("L_diag", "L_off", "Linv_diag"), ours, ref):
        assert o.shape == r.shape, name
        assert torch.equal(_bits(o), _bits(r)), name


@pytest.mark.cuda
@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("B,nb,s", FACTOR_SHAPES)
def test_arrow_llt_kernel_is_order_exact(cuda_device, B, nb, s, up):
    # K7's outputs bit for bit against the same sums in the same order: the
    # heads, then the Schur sum head by head in order
    diag, off = _factor_inputs(B, nb, s)
    before = spans.counter("launch.K7")
    ours = block_llt.block_arrow_llt(diag.to(cuda_device),
                                     off.to(cuda_device), up=up)
    torch.cuda.synchronize()
    assert spans.counter("launch.K7") == before + 1
    ref = order_exact.k7_order_exact(diag, off, up=up)
    for name, o, r in zip(("L_diag", "L_side", "Linv_diag"), ours, ref):
        assert o.shape == r.shape, name
        assert torch.equal(_bits(o), _bits(r)), name


@pytest.mark.cuda
def test_factor_config_fits_the_ik_batch_in_one_wave(cuda_device):
    # K5 and K7 keep 8 problems per SM at the IK block size, so an IK batch
    # of 1024 is resident at once on an H100's 132 SMs
    for entry in ("jrlqp_tri_block_llt", "jrlqp_block_arrow_llt"):
        cfg = block_llt.factor_config(entry, 43)
        assert cfg["threads"] == 128 and cfg["blocks_per_sm"] >= 8, cfg


def _ik_problem(d, gtype, device):
    sg, sc = structured_from_numpy(diag=d["diag"], off=d["off"],
                                   gtype=gtype, blocks=d["blocks"],
                                   device=device)
    a, l, u = (torch.from_numpy(d[k]).to(device) for k in ("a", "l", "u"))
    return sg, a, sc, l, u


@pytest.mark.cuda
@pytest.mark.parametrize("gtype", list(GType))
def test_structured_launch_counts_and_cpu_parity(cuda_device, gtype):
    # a cold batch launches the factorization and the solve once each and
    # no GI kernel of K1-K9 (its loop is one K11 launch:
    # test_fast_paths_launch_k11_once); a warm carry step launches none of
    # them
    d = ik_batch(6, nb=3, s=8, mc=2, seed=5)
    opt = SolverOptions(max_iter=200)
    before = _struct_counts()
    gi_before = (spans.counter("launch.K1"), spans.counter("launch.K3"),
                 spans.counter("launch.K4"))
    res, carry = solve_structured_fast_carry(
        *_ik_problem(d, gtype, cuda_device), None, opt=opt)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_struct_counts(), before)]
    tri = gtype == GType.TRI_BLOCK_DIAGONAL
    assert launched == ([1, 1, 0, 0] if tri else [0, 0, 1, 1])
    ref = solve_structured_fast_batch(*_ik_problem(d, gtype, "cpu"), opt=opt)
    assert torch.equal(res.status.cpu(), ref.status)
    assert torch.equal(res.iterations.cpu(), ref.iterations)
    assert torch.equal(res.active_set.cpu(), ref.active_set)
    torch.testing.assert_close(res.x.cpu(), ref.x, rtol=0, atol=1e-7)
    before = _struct_counts()
    step = _ik_problem(ik_step(d, 0.02, np.random.default_rng(1)), gtype,
                       cuda_device)
    res_w, _ = solve_structured_fast_carry(*step, carry, opt=opt)
    torch.cuda.synchronize()
    assert _struct_counts() == before
    assert (spans.counter("launch.K1"), spans.counter("launch.K3"),
            spans.counter("launch.K4")) == gi_before
    assert bool((res_w.status == 0).all())
    resid = kkt_residual(res_w.x, res_w.multipliers,
                         structured_qp_problem(*step))
    assert float(resid.max()) <= 1e-8


def _assert_close_scaled(ours, ref, keys=("x", "u", "H", "Ns"), tol=1e-4):
    """Integer state equal; float state within tol * max(1, |lane|)."""
    for k in ("term", "it", "q", "status", "aorder"):
        assert torch.equal(ours[k], ref[k]), k
    for k in keys:
        err = (ours[k] - ref[k]).abs().flatten(1).amax(dim=1)
        mag = ref[k].abs().flatten(1).amax(dim=1).clamp_min(1.0)
        assert float((err / mag).max()) <= tol, k


def _opt32(max_iter):
    return SolverOptions(max_iter=max_iter).with_(dtype=torch.float32,
                                                  zero_z_threshold=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_gi_compact_kernel_matches_plain(cuda_device, name):
    # K9 from the torch cold init, on the batch kinds of the Pallas tests
    d, max_iter = make_case(name)
    pb = _f32_problem(d, cuda_device)
    state0 = fast._init_fast(pb, _opt32(max_iter))
    before = spans.counter("launch.K9")
    ours = gi_kernel.run_loop_compact(pb, state0, max_iter)
    torch.cuda.synchronize()
    assert spans.counter("launch.K9") == before + 1
    _assert_kernel_matches_plain(
        ours, gi_kernel.gi_compact_plain(pb, state0, max_iter))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(10, 20), (50, 100)])
def test_gi_compact_kernel_matches_plain_sized(cuda_device, n, m):
    # the headline width and a small one; then a capped run resumed from
    # its state, pending candidate (skip1 = 1) included
    d = np_qp_batch(n + m, 64, n, m, 0.3)
    pb = _f32_problem(d, cuda_device)
    state0 = fast._init_fast(pb, _opt32(150))
    before = spans.counter("launch.K9")
    ours = gi_kernel.run_loop_compact(pb, state0, 150)
    torch.cuda.synchronize()
    assert spans.counter("launch.K9") == before + 1
    _assert_close_scaled(ours, gi_kernel.gi_compact_plain(pb, state0, 150))
    for cap in range(2, 100):     # the first cap that leaves a lane pending
        capped = fast._state_from_kernel_out(
            gi_kernel.run_loop_compact(pb, state0, cap), pb.batch)
        if bool((capped.skip1 & (capped.term == 4)).any()):
            break
    assert bool((capped.skip1 & (capped.term == 4)).any())
    capped = dataclasses.replace(capped, term=torch.where(
        capped.term == 4, -1, capped.term).to(torch.int32))
    _assert_close_scaled(gi_kernel.run_loop_compact(pb, capped, 150),
                         gi_kernel.gi_compact_plain(pb, capped, 150))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,n,m", [
    ("K1", 5, 3), ("K1", 31, 7), ("K1", 64, 200), ("K1", 100, 60),
    ("K9", 5, 3), ("K9", 31, 7), ("K9", 64, 200), ("K9", 100, 60),
    ("K3", 31, 7), ("K4", 31, 7)])
def test_gi_kernels_match_plain_ragged(cuda_device, kernel, n, m):
    # where the kernels' 2-D thread maps have edges: a row of K narrower
    # than a warp's float4 groups (n=5), m < n, more float4 column groups
    # than lanes (np2 = 144 and 208, mp = 200), and n=100, near the largest
    # layout one block holds
    d = np_qp_batch(n * m + 3, 64, n, m, 0.3)
    max_iter = 300
    pb = _f32_problem(d, cuda_device)
    if kernel == "K1":
        args, count = (pb, max_iter), "launch.K1"
        run, plain = gi_kernel.run_loop_fused, gi_kernel.gi_fused_plain
    elif kernel == "K9":
        args = (pb, fast._init_fast(pb, _opt32(max_iter)), max_iter)
        count = "launch.K9"
        run, plain = gi_kernel.run_loop_compact, gi_kernel.gi_compact_plain
    elif kernel == "K3":
        cold = fast.solve_refined_kernel(
            problem_from_numpy(**d, device=cuda_device),
            SolverOptions(max_iter=max_iter))
        hints = cold.active_set.clone()
        hints[:, ::2] = 0
        opt32 = SolverOptions(max_iter=max_iter, warm_start=True).with_(
            dtype=torch.float32, zero_z_threshold=1e-6)
        args = (pb, fast._init_fast_warm(pb, hints, opt32), max_iter)
        count = "launch.K3"
        run, plain = gi_kernel.run_loop, gi_kernel.gi_loop_plain
    else:
        _, carry = fast.solve_refined_kernel_carry(
            problem_from_numpy(**d, device=cuda_device), None,
            SolverOptions(max_iter=max_iter))
        pb = _f32_problem(drifted(d, 0.02, 7), cuda_device)
        args = (pb, carry.H, carry.Ns, carry.status, carry.aorder, carry.q,
                max_iter)
        count = "launch.K4"
        run, plain = gi_kernel.run_warm_loop, gi_kernel.gi_warm_plain
    before = spans.counter(count)
    ours = run(*args)
    torch.cuda.synchronize()
    assert spans.counter(count) == before + 1
    _assert_close_scaled(ours, plain(*args))


def _warm_kernel_and_plain(pb, carry, max_iter):
    """K4 and its plain version on the same inputs, from a carry in the
    kernels' own layout; K4 launches once."""
    ins, (n, m) = gi_kernel.prepare_warm_carry(pb, carry.raw, carry.q,
                                               carry.reset, carry.first)
    before = spans.counter("launch.K4")
    ours = gi_kernel.postprocess(
        gi_kernel._gi_warm_cuda_raw(*ins, n, m, max_iter), n, m)
    torch.cuda.synchronize()
    assert spans.counter("launch.K4") == before + 1
    return ours, gi_kernel.postprocess(
        gi_kernel._gi_warm_plain_raw(*ins, n, m, max_iter), n, m)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.02, 0.5])
@pytest.mark.parametrize("n,m", [(5, 3), (31, 7), (64, 200), (100, 60)])
def test_gi_warm_kernel_from_kernel_carry_ragged(cuda_device, n, m, scale):
    # K4 from the carry as the entry point returns it (K1's own K, status
    # and aorder, the padded G and C^T), at the shapes where the thread maps
    # have edges
    d = np_qp_batch(n * m + 3, 64, n, m, 0.3)
    max_iter = 300
    _, carry = fast.solve_refined_kernel_carry(
        problem_from_numpy(**d, device=cuda_device), None,
        SolverOptions(max_iter=max_iter))
    assert carry.raw is not None
    pb = problem_from_numpy(**drifted(d, scale, 7), device=cuda_device)
    ours, ref = _warm_kernel_and_plain(pb, carry, max_iter)
    if scale == 0.02:
        _assert_close_scaled(ours, ref)
    else:
        # far from the carry a lane runs ~100 iterations, and at (64, 200)
        # a few lanes end LINEAR_DEPENDENCY_DETECTED at a degenerate vertex
        # on a path that one rounding decides: there the plain version
        # itself goes three ways on the card, on the CPU and in f64, while
        # the kernel kept the bits it had before its redesign (PERF.md,
        # section 6). So every lane ends alike, at least 90% of the lanes
        # end SUCCESS, and only a failed lane may differ: a lane that ends
        # SUCCESS has the plain version's integer state, its f32 state
        # within 1e-3 (100 iterations of f32 updates, not two), and after
        # the f64 refinement it has the plain version's x and passes the
        # gate wherever the plain version's lane does (a warm lane may end
        # SUCCESS above the KKT limit in both)
        assert torch.equal(ours["term"], ref["term"])
        ok = ours["term"] == 0
        assert float(ok.double().mean()) >= 0.9
        _assert_close_scaled({k: v[ok] for k, v in ours.items()},
                             {k: v[ok] for k, v in ref.items()}, tol=1e-3)
        res, res_p = (fast._refine_batch(
            pb, fast._state_from_kernel_out(o, pb.batch), 3)
            for o in (ours, ref))
        gate, gate_p = ((r.status == 0)
                        & (kkt_residual(r.x, r.multipliers, pb) <= 1e-8)
                        for r in (res, res_p))
        assert bool((gate | ~gate_p)[ok].all())
        assert float(gate[ok].double().mean()) >= 0.95
        assert float((res.x - res_p.x)[ok].abs().max()) <= 1e-7
    # the step from the five plain tensors is the same step
    plain_carry = gi_kernel.run_warm_loop(
        _f32_problem(drifted(d, scale, 7), cuda_device), carry.H, carry.Ns,
        carry.status, carry.aorder, carry.q, max_iter)
    for k in ours:
        assert torch.equal(ours[k], plain_carry[k]), k


def released(d, by=10.0):
    """Batch ``d`` with every lower bound moved down by ``by``: the
    constraints a solve of ``d`` holds at their lower bound come free, so a
    warm step from its carry deactivates them at entry."""
    return dict(d, l=d["l"] - by)


@pytest.mark.cuda
def test_gi_warm_kernel_every_lane_deactivates(cuda_device):
    d = np_qp_batch(5, 64, 12, 20, 0.4)
    max_iter = 200
    _, carry = fast.solve_refined_kernel_carry(
        problem_from_numpy(**d, device=cuda_device), None,
        SolverOptions(max_iter=max_iter))
    pb = problem_from_numpy(**released(d), device=cuda_device)
    entry, _ = _warm_kernel_and_plain(pb, carry, 0)   # the prologue alone
    assert bool((entry["it"] >= 1).all())
    ours, ref = _warm_kernel_and_plain(pb, carry, max_iter)
    _assert_close_scaled(ours, ref)
    assert bool((ours["term"] == 0).all())


def _solve_rhs(kind, B, nb, s, k, device):
    n = nb * s
    if kind == "identity":
        r = torch.eye(n, max(n, k), device=device)[:, :k]
        return r.reshape(1, nb, s, k).expand(B, nb, s, k).contiguous()
    g = torch.Generator(device="cpu").manual_seed(1000 * s + 10 * nb + k)
    return torch.randn((B, nb, s, k), generator=g).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 64, 65, 387])
@pytest.mark.parametrize("nb", [2, 9])
@pytest.mark.parametrize("s", [8, 43])
def test_struct_solves_match_plain_widths(cuda_device, s, nb, k):
    # K6 (with lower_only) and K8 (down and up) at rhs widths on and off
    # the tile edges, the identity (whose zero tiles the kernels skip) and a
    # dense rhs; 1e-5 relative to the largest entry
    B = 16
    d = ik_batch(B, nb=nb, s=s, mc=2, seed=nb + s)
    diag = torch.from_numpy(d["diag"].astype(np.float32)).to(cuda_device)
    off = torch.from_numpy(d["off"].astype(np.float32)).to(cuda_device)
    tri = block_llt.tri_block_llt(diag, off)
    arrows = {up: block_llt.block_arrow_llt(diag, off, up=up)
              for up in (False, True)}
    for kind in ("identity", "dense"):
        r = _solve_rhs(kind, B, nb, s, k, cuda_device)
        before = _struct_counts()
        pairs = [(f"K6 lower_only={lo}",
                  block_llt.tri_block_solve(tri[1], tri[2], r, lo),
                  block_llt.tri_block_solve_plain(tri[1], tri[2], r, lo))
                 for lo in (False, True)]
        pairs += [(f"K8 up={up}",
                   block_llt.block_arrow_solve(f[1], f[2], r, up=up),
                   block_llt.block_arrow_solve_plain(f[1], f[2], r, up=up))
                  for up, f in arrows.items()]
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(_struct_counts(), before)]
        assert launched == [0, 2, 0, 2]
        for name, ours, ref in pairs:
            assert ours.shape == ref.shape, (name, kind)
            assert bool(torch.isfinite(ours).all()), (name, kind)
            assert struct_err(ours, ref) <= 1e-5, (name, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("lower_only", [False, True])
@pytest.mark.parametrize("kind", ["shared_identity", "identity", "dense",
                                  "tail"])
def test_tri_solve_at_the_ik_shape_matches_plain(cuda_device, kind,
                                                 lower_only):
    # K6 at the IK shape (nb = 9, s = 43, k = n = 387): the identity as the
    # structured path hands it over (one padded buffer for the batch) and
    # as an unpadded copy, a dense rhs, and one nonzero in its last block
    # row alone (every forward result above it zero); 1e-5 relative to the
    # largest entry
    B, nb, s = 16, 9, 43
    n = nb * s
    d = ik_batch(B, nb=nb, s=s, mc=4, seed=5)
    diag = torch.from_numpy(d["diag"].astype(np.float32)).to(cuda_device)
    off = torch.from_numpy(d["off"].astype(np.float32)).to(cuda_device)
    _, Lo, Li = block_llt.tri_block_llt(diag, off)
    if kind == "shared_identity":
        r = block_llt.identity_rhs(B, nb, s, device=cuda_device)
    else:
        r = _solve_rhs("dense" if kind == "tail" else kind, B, nb, s, n,
                       cuda_device)
        if kind == "tail":
            r[:, :-1] = 0.0
    before = spans.counter("launch.K6")
    y = block_llt.tri_block_solve(Lo, Li, r, lower_only)
    ref = block_llt.tri_block_solve_plain(Lo, Li, r, lower_only)
    torch.cuda.synchronize()
    assert spans.counter("launch.K6") == before + 1
    assert y.shape == (B, nb, s, n) and bool(torch.isfinite(y).all())
    assert struct_err(y, ref) <= 1e-5
    if kind == "shared_identity":
        eye = _solve_rhs("identity", B, nb, s, n, cuda_device)
        assert torch.equal(y, block_llt.tri_block_solve(Lo, Li, eye,
                                                        lower_only))
    if kind == "tail" and lower_only:
        assert bool((y[:, :-1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["identity", "dense", "tail"])
def test_struct_solves_match_plain_long_chain(cuda_device, kind):
    # a chain of 70 blocks, more than the 64 whose skipped zero tiles the
    # solves remember: with the identity as rhs most forward steps meet a
    # zero tile, beyond block 64 too; "tail" is nonzero in the last block
    # row alone, so every earlier forward result is zero
    B, nb, s = 4, 70, 8
    k = nb * s
    d = ik_batch(B, nb=nb, s=s, mc=2, seed=nb + s)
    diag = torch.from_numpy(d["diag"].astype(np.float32)).to(cuda_device)
    off = torch.from_numpy(d["off"].astype(np.float32)).to(cuda_device)
    tri = block_llt.tri_block_llt(diag, off)
    arrows = {up: block_llt.block_arrow_llt(diag, off, up=up)
              for up in (False, True)}
    r = _solve_rhs("dense" if kind == "tail" else kind, B, nb, s, k,
                   cuda_device)
    if kind == "tail":
        r[:, :-1] = 0.0
    # the outputs come from torch.empty: leave the allocator's blocks full
    # of NaN, so a result that is never written shows
    for _ in range(4):
        torch.full_like(r, float("nan"))
    pairs = [(f"K6 lower_only={lo}",
              block_llt.tri_block_solve(tri[1], tri[2], r, lo),
              block_llt.tri_block_solve_plain(tri[1], tri[2], r, lo))
             for lo in (False, True)]
    pairs += [(f"K8 up={up}",
               block_llt.block_arrow_solve(f[1], f[2], r, up=up),
               block_llt.block_arrow_solve_plain(f[1], f[2], r, up=up))
              for up, f in arrows.items()]
    torch.cuda.synchronize()
    for name, ours, ref in pairs:
        assert bool(torch.isfinite(ours).all()), name
        assert struct_err(ours, ref) <= 1e-5, name


MISSED_LANE_FILES = {
    which: pathlib.Path(__file__).parent / "data" / f"missed_lanes_{which}.npz"
    for which in ("port", "jax")}


def _missed_lane_cases():
    """One case per lane of the two census files (both must be present),
    and the gate on the main path's lane 11415 (K1 misses it)."""
    cases = []
    for which, path in MISSED_LANE_FILES.items():
        cases += [pytest.param(which, miss_census.lane_id(r), "recorded",
                               id=f"{which}-{miss_census.lane_id(r)}")
                  for r in miss_census.load_lanes(str(path))[0]]
    cases.append(pytest.param(
        "port", "headline-0-11415", "gate", id="main-path-lane-11415-gate",
        marks=pytest.mark.xfail(strict=True, reason=(
            "a shared f32 deviation, not a fault of K1 (ROADMAP queue 3c): "
            "at its 61st iteration K1 finds constraint 95 at a slack of "
            "-1.4e-6 and activates it, where the f64 solution leaves it "
            "+8.9e-7 (3.7 f32 ulps of C x) and the JAX package's fused "
            "kernel +6.9e-7; the refined result stalls at a KKT residual of "
            "7.0e-8. On 131,072 headline lanes per package (seeds 0-7) K1 "
            "misses 10 and the JAX package's fused kernel 8 of its own "
            "draws; each passes about half of the other's misses (5 of 10, "
            "4 of 8) and misses the rest the same way"))))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("which, lane, check", _missed_lane_cases())
def test_missed_lane_on_card(cuda_device, which, lane, check):
    # a lane of tests/data/missed_lanes_{port,jax}.npz alone on the card:
    # its path's kernel (K1, K3 or K9) and the kernel's plain version give
    # the status, iterations, pass or fail and active set the census
    # recorded; tests/test_torch_missed_lanes.py holds the same lanes
    # against the JAX package on the CPU
    lanes = miss_census.load_lanes(str(MISSED_LANE_FILES[which]))[0]
    rec = next(r for r in lanes if miss_census.lane_id(r) == lane)
    got = miss_census.solve_alone(rec, cuda_device)
    if check == "gate":
        assert got["kernel"]["passed"]
        return
    for w in ("kernel", "plain"):
        want = rec["outcomes"][f"{w}_card_alone"]
        assert ((got[w]["status"], got[w]["iterations"], got[w]["passed"])
                == (want["status"], want["iterations"], want["passed"])), w
        np.testing.assert_array_equal(got[w]["active_set"],
                                      want["active_set"], err_msg=w)


def _launches():
    return (spans.counter("launch.K1"), spans.counter("launch.K3"),
            spans.counter("launch.K4"), spans.counter("launch.K9"))


def _assert_same_result(res, ref, x_tol=1e-7):
    assert torch.equal(res.status.cpu(), ref.status)
    assert torch.equal(res.iterations.cpu(), ref.iterations)
    assert torch.equal(res.active_set.cpu(), ref.active_set)
    torch.testing.assert_close(res.x.cpu(), ref.x, rtol=0, atol=x_tol)


@pytest.mark.cuda
def test_compact_path_launches_k9_once(cuda_device):
    d, max_iter = make_case("eq_fixed")
    opt = SolverOptions(max_iter=max_iter)
    before = _launches()
    res = solve_refined_kernel_compact(
        problem_from_numpy(**d, device=cuda_device), opt)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [0, 0, 0, 1]
    _assert_same_result(res, solve_refined_kernel_compact(
        problem_from_numpy(**d, device="cpu"), opt))


@pytest.mark.cuda
def test_capture_kernel_trajectory_launches_k9_per_cap(cuda_device):
    d, _ = make_case("n8_m12")
    one = {k: v[:1] for k, v in d.items()}
    opt = SolverOptions(max_iter=30)
    before = spans.counter("launch.K9")
    traj = capture_kernel_trajectory(
        problem_from_numpy(**one, device=cuda_device), opt, n_iters=6)
    torch.cuda.synchronize()
    assert spans.counter("launch.K9") == before + 6
    ref = capture_kernel_trajectory(problem_from_numpy(**one, device="cpu"),
                                    opt, n_iters=6)
    for k in ("q", "it", "term"):
        assert torch.equal(traj[k].cpu(), ref[k]), k
    torch.testing.assert_close(traj["x"].cpu(), ref["x"], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_rescued_batch_on_card(cuda_device):
    # act_frac 0.95: the f32 first stage (K3) fails some lanes, the f64 J/R
    # engine on the card solves them again
    d = np_qp_batch(2, 24, 12, 24, 0.95)
    opt = SolverOptions(max_iter=120)
    pb = problem_from_numpy(**d, device=cuda_device)
    before = _launches()
    res = solve_refined_kernel_rescued(pb, opt)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [0, 1, 0, 0]
    assert bool((res.status == 0).all())
    assert float(kkt_residual(res.x, res.multipliers, pb).max()) <= 1e-8
    _assert_same_result(res, solve_refined_kernel_rescued(
        problem_from_numpy(**d, device="cpu"), opt), x_tol=1e-8)


@pytest.mark.cuda
def test_kernels_run_on_a_second_card(cuda_device):
    # the runtime launches on its current device: a batch on card 1 must
    # still be solved there (K1, K3, K5+K6), equal to card 0's results
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    second = torch.device("cuda", 1)
    d, max_iter = make_case("n8_m12")
    opt = SolverOptions(max_iter=max_iter)
    for fused in (True, False):
        res = fast.solve_refined_kernel(
            problem_from_numpy(**d, device=second), opt, fused_init=fused)
        assert res.x.device == second
        ref = fast.solve_refined_kernel(
            problem_from_numpy(**d, device=cuda_device), opt,
            fused_init=fused)
        _assert_same_result(res, dataclasses.replace(
            ref, **{f.name: getattr(ref, f.name).cpu()
                    for f in dataclasses.fields(ref)}), x_tol=0.0)
    k = ik_batch(4, nb=3, s=8, mc=2, seed=3)
    out = []
    for dev in (second, cuda_device):
        sg, sc = structured_from_numpy(diag=k["diag"], off=k["off"],
                                       gtype=GType.TRI_BLOCK_DIAGONAL,
                                       blocks=k["blocks"], device=dev)
        a, lo, up = (torch.from_numpy(k[v]).to(dev) for v in "alu")
        out.append(solve_structured_fast_batch(sg, a, sc, lo, up,
                                               opt=SolverOptions()))
    assert torch.equal(out[0].status.cpu(), out[1].status.cpu())
    assert torch.equal(out[0].x.cpu(), out[1].x.cpu())


@pytest.mark.cuda
def test_default_device_is_the_card(cuda_device):
    d, _ = make_case("n8_m12")
    assert problem_from_numpy(**d).G.device == torch.device("cuda", 0)
    k = ik_batch(2, nb=2, s=3, mc=1, seed=0)
    sg, sc = structured_from_numpy(diag=k["diag"], off=k["off"],
                                   gtype=GType.TRI_BLOCK_DIAGONAL,
                                   blocks=k["blocks"])
    assert sg.diag.device == sc.blocks.device == torch.device("cuda", 0)


@pytest.mark.cuda
def test_no_retrace_across_shapes_on_card(cuda_device):
    opt = SolverOptions(max_iter=60)
    solve_refined_kernel_compact(problem_from_numpy(
        **make_case("n8_m12")[0], device=cuda_device), opt)
    with no_retrace():
        for name in ("n8_m12", "n13_m7", "eq_fixed"):
            pb = problem_from_numpy(**make_case(name)[0], device=cuda_device)
            fast.solve_refined_kernel(pb, opt)
            solve_refined_kernel_compact(pb, opt)


def np_box_batch(seed, batch, n):
    """Batches (x0, c, bl, xl, xu) of box-and-one-constraint problems, the
    constraint cutting the box on odd lanes (the generator of
    tests/test_box_single.py)."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (batch, n))
    r1, r2 = rng.uniform(-1, 1, (2, batch, n))
    xl, xu = np.minimum(r1, r2), np.maximum(r1, r2)
    c = rng.uniform(-1, 1, (batch, n))
    corner_lo = np.where(c > 0, xl, xu)
    corner_hi = np.where(c > 0, xu, xl)
    d1 = (c * np.clip(x0, xl, xu)).sum(axis=1)
    act = 0.5 * d1 + 0.5 * (c * corner_hi).sum(axis=1)
    bl = np.where(np.arange(batch) % 2 == 1, act,
                  (c * corner_lo).sum(axis=1))
    return x0, c, bl, xl, xu


@pytest.mark.cuda
def test_solve_box_on_card_matches_cpu(cuda_device):
    arrs = np_box_batch(5, 256, 16)
    res = solve_box(*[torch.from_numpy(a).to(cuda_device) for a in arrs])
    ref = solve_box(*[torch.from_numpy(a) for a in arrs])
    assert res.x.device == cuda_device
    _assert_same_result(res, ref, x_tol=1e-12)
    torch.testing.assert_close(res.multipliers.cpu(), ref.multipliers,
                               rtol=0, atol=1e-12)


def _solve_engine(pb, opt, engine, fused_init):
    if engine == "pallas":
        return fast.solve_refined_kernel(pb, opt, fused_init=fused_init)
    if engine == "refined":
        return fast.solve_refined(pb, opt)
    return solve_batch(pb, opt)


@pytest.mark.cuda
@pytest.mark.parametrize("engine,fused_init", [("f64", False),
                                               ("pallas", False),
                                               ("pallas", True),
                                               ("refined", False)])
@pytest.mark.parametrize("shards", [1, 4])
def test_solve_sharded_on_card(cuda_device, engine, fused_init, shards):
    # four shards on one card run one after another on its one worker:
    # the launch counts stay exact, and every lane is bit for bit its
    # shard's alone
    d = np_qp_batch(6, 64, 12, 24, 0.3)
    pb = problem_from_numpy(**d, device=cuda_device)
    opt = SolverOptions(max_iter=100)
    mesh = make_mesh(devices=[cuda_device] * shards)
    before = _launches()
    res, stats = solve_sharded(pb, opt, mesh=mesh, engine=engine,
                               fused_init=fused_init)
    torch.cuda.synchronize()
    grew = [a - b for a, b in zip(_launches(), before)]
    if engine == "pallas":
        # one K1 (fused) or K3 launch per shard, nothing else
        assert grew == ([shards, 0, 0, 0] if fused_init
                        else [0, shards, 0, 0])
    else:
        assert grew == [0, 0, 0, 0]
    ref = _solve_engine(pb, opt, engine, fused_init)
    _assert_same_result(res, dataclasses.replace(
        ref, **{f.name: getattr(ref, f.name).cpu()
                for f in dataclasses.fields(ref)}), x_tol=1e-10)
    alone = [_solve_engine(shard, opt, engine, fused_init)
             for shard in shard_batch(pb, mesh)]
    for f in dataclasses.fields(res):
        assert torch.equal(getattr(res, f.name),
                           torch.cat([getattr(r, f.name) for r in alone])), \
            f.name
    it = res.iterations.long()
    assert (stats.total_iterations, stats.n_success, stats.max_iterations) \
        == (int(it.sum()), int((res.status == 0).sum()), int(it.max()))


@pytest.mark.cuda
def test_first_use_from_four_threads_loads_the_kernels_once(cuda_device):
    # a fresh process whose first kernel use is four threads solving at
    # once, as the workers of a four-card sharded solve do: the library is
    # built or loaded once, and each K1 launch is counted
    code = (
        "from concurrent.futures import ThreadPoolExecutor\n"
        "import torch\n"
        "from jrlqp_tpu_torch import SolverOptions, solve_refined_kernel\n"
        "from jrlqp_tpu_torch.utils import spans\n"
        "from jrlqp_tpu_torch.testing.batch_gen import random_qp_batch\n"
        "dev = torch.device('cuda', 0)\n"
        "gen = torch.Generator(device=dev).manual_seed(0)\n"
        "pb = random_qp_batch(gen, 256, 12, 24, 0.3, dtype=torch.float32,\n"
        "                     device=dev).with_dtype(torch.float64)\n"
        "opt = SolverOptions(max_iter=100)\n"
        "with ThreadPoolExecutor(4) as ex:\n"
        "    res = list(ex.map(lambda _: solve_refined_kernel(pb, opt),\n"
        "                      range(4)))\n"
        "torch.cuda.synchronize()\n"
        "assert all(torch.equal(r.x, res[0].x) for r in res)\n"
        "print(spans.counter('library.load'), spans.counter('launch.K1'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["1", "4"], out.stdout


def _headline_chunks(cards, batch, device):
    """One chunk of ``batch`` headline problems (n=50, m=100, made in f32,
    solved in f64) per card, chunk c drawn from seed c."""
    def chunk(c):
        gen = torch.Generator(device=device).manual_seed(c)
        return random_qp_batch(gen, batch, 50, 100, 0.3, dtype=torch.float32,
                               device=device).with_dtype(torch.float64)
    return [chunk(c) for c in range(cards)]


@pytest.mark.cuda
def test_shards_run_at_the_same_time_on_several_cards(cuda_device):
    # K1 on every card of a mesh of up to four: by CUDA events per shard
    # (testing.shard_timeline), every shard's kernel runs while every
    # other's does, and the lanes equal each card's chunk solved alone
    cards = min(torch.cuda.device_count(), 4)
    if cards < 2:
        pytest.skip("needs two CUDA devices")
    mesh = make_mesh(cards)
    opt = SolverOptions(max_iter=150)
    chunks = _headline_chunks(cards, 8192, cuda_device)
    pbs = stack_problems(chunks)
    solve_sharded(pbs, opt, mesh=mesh, engine="pallas", fused_init=True)
    before = _launches()
    with shard_timeline.record() as tl:
        res, stats = solve_sharded(pbs, opt, mesh=mesh, engine="pallas",
                                   fused_init=True)
    assert [a - b for a, b in zip(_launches(), before)] == [cards, 0, 0, 0]
    ov = tl.overlap()
    assert sorted(sh["device"] for sh in tl.shards) == [
        str(d) for d in mesh.devices]
    assert ov["shards_with_kernels"] == cards and ov["common_ms"] > 0, (
        ov, [(sh["device"], sh["start_ms"], sh["kernels"])
             for sh in tl.shards])
    alone = [fast.solve_refined_kernel(c, opt) for c in chunks]
    for f in dataclasses.fields(res):
        assert torch.equal(getattr(res, f.name),
                           torch.cat([getattr(r, f.name) for r in alone])), \
            f.name
    assert stats.n_success == int((res.status == 0).sum())


@pytest.mark.cuda
def test_solve_sharded_on_a_side_stream(cuda_device, monkeypatch):
    # the caller solves on a stream of its own, on which the input is
    # written only after a long sleep: every shard's engine call runs on
    # the caller's current stream of its card and of the input's card, and
    # the lanes are each card's chunk solved alone
    cards = min(torch.cuda.device_count(), 4)
    mesh = make_mesh(cards)
    opt = SolverOptions(max_iter=150)
    chunks = _headline_chunks(cards, 2048, cuda_device)
    pbs = stack_problems(chunks)
    # solved first, so that no first build or load of the kernels waits
    # out the sleep below
    alone = [fast.solve_refined_kernel(c, opt) for c in chunks]
    late = dataclasses.replace(pbs, **{
        f.name: torch.full_like(getattr(pbs, f.name), float("nan"))
        for f in dataclasses.fields(pbs)})
    torch.cuda.synchronize()
    solve_shard, seen = mesh_mod._solve_shard, []

    def noting(pb, *args):
        dev = pb.G.device
        seen.append((dev, torch.cuda.current_stream(dev),
                     torch.cuda.current_stream(cuda_device)))
        return solve_shard(pb, *args)

    monkeypatch.setattr(mesh_mod, "_solve_shard", noting)
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        want = {d: torch.cuda.current_stream(d) for d in mesh.devices}
        torch.cuda._sleep(1_000_000_000)
        for f in dataclasses.fields(pbs):
            getattr(late, f.name).copy_(getattr(pbs, f.name))
        res, stats = solve_sharded(late, opt, mesh=mesh, engine="pallas",
                                   fused_init=True)
    torch.cuda.synchronize()
    assert want[mesh.devices[0]] == side and len(seen) == cards
    for dev, on_card, on_input_card in seen:
        assert on_card == want[dev] and on_input_card == side, dev
    for f in dataclasses.fields(res):
        assert torch.equal(getattr(res, f.name),
                           torch.cat([getattr(r, f.name) for r in alone])), \
            f.name
    assert stats.n_success == int((res.status == 0).sum()) > 0


def np_large_bucket(seed, batch, generator="headline"):
    """``batch`` problems of the LARGE_SPECS shapes (tests/test_corpus.py)
    n = 128, m = 100 and n = 96, m = 80, padded to the corpus bucket
    (128, 128), where K3 runs at (np, mp) = (136, 128). ``"headline"``
    draws them as ``np_qp_batch`` does (cond(G) ≈ 5); ``"random_problem"``
    as the corpus test does (G = AᵀA of a square Gaussian A: cond(G)
    1e5–1e8, beyond what the f32 loop resolves)."""
    rng = np.random.default_rng(seed)
    pbs = []
    for i in range(batch):
        n, m, n_act, bounds = ((96, 80, 30, False) if i % 2 else
                               (128, 100, 40, True))
        if generator == "headline":
            d = {k: v[0] for k, v in np_qp_batch(
                int(rng.integers(1 << 31)), 1, n, m, 0.3).items()}
            if bounds:
                d["xl"], d["xu"] = np.full(n, -2.0), np.full(n, 2.0)
            d["objcst"] = 0.0
        else:
            d = random_problem(ProblemCharacteristics(
                n_var=n, n_obj=n, n_ineq=m, n_strong_act_ineq=n_act,
                bounds=bounds, n_strong_act_bounds=1 if bounds else 0),
                rng).to_qp_arrays()
        pbs.append(problem_from_numpy(
            **{k: np.asarray(v)[None] for k, v in d.items()}, device="cpu"))
    return stack_problems(pbs, 128, 128)


@pytest.mark.cuda
def test_gi_loop_kernel_at_the_largest_corpus_bucket(cuda_device):
    # K3 from the torch cold init at (np, mp) = (136, 128), one block per
    # SM: the same path as its plain version on every lane, float state
    # within 1e-4 x max(1, |lane|)
    lib = gi_kernel._build.library()
    assert lib.jrlqp_gi_smem_bytes(136, 128) <= gi_kernel._SMEM_LIMIT
    pb = np_large_bucket(8, 64).to(cuda_device).with_dtype(torch.float32)
    state0 = fast._init_fast(pb, _opt32(400))
    before = spans.counter("launch.K3")
    ours = gi_kernel.run_loop(pb, state0, 400)
    torch.cuda.synchronize()
    assert spans.counter("launch.K3") == before + 1
    ref = gi_kernel.gi_loop_plain(pb, state0, 400)
    _assert_close_scaled(ours, ref)
    assert bool((ours["term"] == 0).all())


@pytest.mark.cuda
def test_rescued_corpus_bucket_on_card(cuda_device):
    # the corpus generator's problems at the (128, 128) bucket: cond(G) up
    # to 1e8, so the f32 stage (one K3 launch) misses about half the lanes
    # (and its path there follows the summation order: the plain version
    # on the card and on the CPU part on most of them); the f64 rescue
    # must end every lane SUCCESS at KKT <= 1e-8, as on the CPU
    pb = np_large_bucket(8, 16, "random_problem")
    opt = SolverOptions(max_iter=400)
    before = _launches()
    res = solve_refined_kernel_rescued(pb.to(cuda_device), opt)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [0, 1, 0, 0]
    assert bool((res.status == 0).all())
    resid = kkt_residual(res.x, res.multipliers, pb.to(cuda_device))
    assert float(resid.max()) <= 1e-8
    ref = solve_refined_kernel_rescued(pb, opt)
    assert torch.equal(res.status.cpu(), ref.status)


def _assert_same_set_scaled(ours, ref, tol=1e-4):
    """The same active constraints per lane, in any slot order; x, H and,
    with the slots put in constraint order, u and the rows of N* within
    tol * max(1, |lane|)."""
    so, sr = ours["aorder"].sort(dim=1), ref["aorder"].sort(dim=1)
    assert torch.equal(so.values, sr.values), "aorder as a set"
    active = sr.values >= 0

    def by_constraint(d, srt, k):
        v = d[k]
        if k == "u":
            return torch.where(active, v.gather(1, srt.indices), 0)
        idx = srt.indices[:, :, None].expand(-1, -1, v.shape[2])
        return torch.where(active[:, :, None], v.gather(1, idx), 0)

    for k in ("x", "H", "u", "Ns"):
        a, b = ((by_constraint(ours, so, k), by_constraint(ref, sr, k))
                if k in ("u", "Ns") else (ours[k], ref[k]))
        err = (a - b).abs().flatten(1).amax(dim=1)
        mag = b.abs().flatten(1).amax(dim=1).clamp_min(1.0)
        assert float((err / mag).max()) <= tol, k


@pytest.mark.cuda
def test_gi_fused_kernel_at_the_size_sweep_top(cuda_device):
    # K1 at n = 100, m = 200, the largest row of the harness's size sweep:
    # one block per SM. Against its plain version on 256 lanes: the same
    # status, iterations and active set on every lane. Among 200
    # constraints two violations can tie within f32 rounding, and the two
    # versions' sums then add them in the other order (one lane of 256 in
    # each of three seeds on an H100, at an iteration past 100); so the
    # activation order may differ on at most 1% of the lanes, and the
    # per-slot state (u, the rows of N*) is compared with its slots in
    # constraint order. x, H, u and N* within 1e-4 x max(1, |lane|).
    lib = gi_kernel._build.library()
    smem = lib.jrlqp_gi_smem_bytes(gi_kernel._round_up(101, 8), 200)
    assert smem <= gi_kernel._SMEM_LIMIT
    assert gi_kernel.residency("jrlqp_gi_fused", 100, 200)[1] >= 1
    B = 256
    pb = _f32_problem(np_qp_batch(100, B, 100, 200, 0.3), cuda_device)
    before = spans.counter("launch.K1")
    ours = gi_kernel.run_loop_fused(pb, 500)
    torch.cuda.synchronize()
    assert spans.counter("launch.K1") == before + 1
    ref = gi_kernel.gi_fused_plain(pb, 500)
    for k in ("term", "it", "q", "status"):
        assert torch.equal(ours[k], ref[k]), k
    assert int((ours["aorder"] != ref["aorder"]).any(dim=1).sum()) <= B // 100
    _assert_same_set_scaled(ours, ref)
    assert float((ours["term"] == 0).double().mean()) >= 0.99


@pytest.mark.cuda
def test_compacted_solve_matches_one_k3_launch(cuda_device):
    # the compacted solve (K3 to 67 of 150 iterations, then K3 on the lanes
    # that hit the cap) against one K3 launch (fused_init=False) on 1024
    # lanes of the headline width: the same status, iterations and active
    # set on every lane, x within 1e-9
    pb = problem_from_numpy(**np_qp_batch(150, 1024, 50, 100, 0.3),
                            device=cuda_device)
    opt = SolverOptions(max_iter=150)
    before = _launches()
    res = solve_refined_kernel_compacted(pb, opt, phase1_frac=0.45)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [0, 2, 0, 0]
    ref = fast.solve_refined_kernel(pb, opt, fused_init=False)
    assert torch.equal(res.status, ref.status)
    assert torch.equal(res.iterations, ref.iterations)
    assert torch.equal(res.active_set, ref.active_set)
    torch.testing.assert_close(res.x, ref.x, rtol=0, atol=1e-9)
    assert int((res.iterations > 67).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("solver,count", [("pallas", "launch.K1"),
                                          ("pallas_rescued", "launch.K3")])
def test_time_batch_pallas_rows_launch_their_kernel(cuda_device, solver,
                                                    count):
    # a warm-up call and n_rep timed calls, each one launch of the kernel
    pb = problem_from_numpy(**np_qp_batch(7, 256, 20, 40, 0.3),
                            device=cuda_device)
    before = spans.counter(count)
    row = time_batch("t", pb, SolverOptions(max_iter=150), solver=solver,
                     n_rep=2)
    assert spans.counter(count) == before + 3
    assert row.kkt_pass_rate >= 0.99 and row.max_kkt_residual <= 1e-8
    assert row.wall_s > 0


@pytest.mark.cuda
def test_warm_start_trajectory_runs_k4_steps(cuda_device):
    # the "pallas" trajectory: one cold K1 step and steps - 1 K4 steps for
    # the warm run, a K1 solve per step for the cold one
    before = _launches()
    row = bench_warm_start_trajectory(n=20, m=40, steps=4, batch=256,
                                      solver="pallas", time_window=3,
                                      device=cuda_device)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [5, 0, 3, 0]
    assert row["warm_success"] >= 0.99 and row["cold_success"] >= 0.99
    assert row["warm_mean_it"] < row["cold_mean_it"]


# ---- K10, the J/R engine's loop ----

def jr_card_batch(n, m, batch, seed):
    """The lane kinds of tests/test_torch_jr_kernel.py at (n, m): a quarter
    each of act_frac 0.3 (adds), 0.9 (removals; q reaches n where m >= n),
    equality rows and fixed variables (the replay), and the box
    [-0.6, 0.6]^n on every variable (all lanes when m = 0), then one lane
    with G = I that ends INFEASIBLE in exact arithmetic (m >= 1): x_0 >= 1
    against x_0 <= -1."""
    k = batch // 4
    parts = [np_qp_batch(seed + i, k, n, m, af)
             for i, af in enumerate((0.3, 0.9, 0.5, 0.5))]
    if m > 0:
        parts[2]["l"][::2, 0] = parts[2]["u"][::2, 0]
    parts[2]["xl"][1::3, 2] = parts[2]["xu"][1::3, 2] = 0.3
    for p in parts[3:] if m > 0 else parts:
        p["xl"][:] = np.maximum(p["xl"], -0.6)
        p["xu"][:] = np.minimum(p["xu"], 0.6)
    if m > 0:
        lane = dict(G=np.eye(n)[None], a=np.zeros((1, n)),
                    C=np.zeros((1, m, n)), l=np.full((1, m), -np.inf),
                    u=np.full((1, m), np.inf), xl=np.full((1, n), -np.inf),
                    xu=np.full((1, n), np.inf))
        lane["C"][0, 0, 0], lane["l"][0, 0] = 1.0, 1.0
        if m > 1:
            lane["C"][0, 1, 0], lane["u"][0, 1] = 1.0, -1.0
        else:
            lane["xu"][0, 0] = -1.0
        parts.append(lane)
    return {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}


def _jr_opt(dtype, **kw):
    if dtype == torch.float32:
        kw = {"zero_z_threshold": 1e-6, **kw}
    return SolverOptions(dtype=dtype, **kw)


def _same_lanes(a, b):
    return ((a.term == b.term) & (a.it == b.it)
            & (a.status == b.status).all(dim=1))


def _deciding_margins(pb, state, opt):
    """At a state where K10 and the plain version part on their next
    iteration: the selection's violation (its test: < 0), the steps t1 and
    t2 with their relative gap (full step where t2 <= t1) and |z| over the
    zero-z threshold (a primal step where > 1), from the plain version's
    own functions on the lane."""
    sel_idx, sel_st, viol = dense._select_violated(pb, state.x, state.status)
    skip = state.skip1
    idx = torch.where(skip, state.sc_idx, sel_idx)
    st = torch.where(skip, state.sc_status, sel_st)
    k = torch.arange(pb.n + 1, device=state.x.device)[None, :]
    u = torch.where(~skip[:, None] & (k == state.q.long()[:, None]), 0.0,
                    state.u)
    st1 = dataclasses.replace(state, u=u, sc_idx=idx, sc_status=st)
    nplus, _, z, r = dense._compute_step(pb, state.J, state.R, state.q, idx,
                                         st)
    t1, t2, _, _ = dense._step_length(pb, st1, opt, nplus, z, r, u)
    t1, t2 = float(t1[0]), float(t2[0])
    return {"viol": float(viol[0]), "t1": t1, "t2": t2,
            "t_gap": (abs(t1 - t2) / max(abs(t1), abs(t2), 1e-300)
                      if np.isfinite([t1, t2]).all() else float("inf")),
            "znorm_over_threshold": float(torch.linalg.vector_norm(z))
            / opt.zero_z_threshold}


def _parting(pb, st0, opt, lane):
    """(first iteration at which K10 and the plain version part on
    ``lane``, the deciding margins there), the lane solved alone."""
    one = pb._map(lambda t: t[lane:lane + 1])
    s1 = dataclasses.replace(st0, **{f.name: getattr(st0, f.name)[
        lane:lane + 1] for f in dataclasses.fields(st0)})

    def at(cap):
        o = opt.with_(max_iter=cap)
        a, b = dense.run_loop(one, s1, o), dense.jr_loop_plain(one, s1, o)
        return (bool(_same_lanes(a, b).all()) and torch.equal(a.q, b.q)
                and torch.equal(a.aorder, b.aorder)), b

    lo, hi = int(s1.it[0]), opt.max_iter
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if at(mid)[0] else (lo, mid)
    return hi, _deciding_margins(one, at(lo)[1], opt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("m", [0, 1, 100, 128])
@pytest.mark.parametrize("n", [10, 50, 128])
def test_jr_loop_kernel_matches_plain(cuda_device, n, m, dtype):
    # f64: the same status, iterations and active set on every lane, x
    # within 1e-10 max(1, |x|) (the same algorithm in another summation
    # order); f32: the same on >= 0.99 of the lanes, x within 1e-3 max(1,
    # |x|); each lane that parts printed with its first parting iteration
    # and deciding margins
    batch = 64 if dtype == torch.float64 else 256
    d = jr_card_batch(n, m, batch, seed=n + m)
    pb = problem_from_numpy(**d, device=cuda_device).with_dtype(dtype)
    for opt in (_jr_opt(dtype, max_iter=4 * n + m),
                _jr_opt(dtype, max_iter=5)):
        st0 = dense.init_state(pb, opt)
        before = spans.counter("launch.K10")
        got = dense.run_loop(pb, st0, opt)
        torch.cuda.synchronize()
        assert spans.counter("launch.K10") == before + 1
        want = dense.jr_loop_plain(pb, st0, opt)
        same = _same_lanes(got, want)
        parting = torch.nonzero(~same)[:, 0].tolist()
        for lane in parting:
            print(f"n={n} m={m} {dtype} max_iter={opt.max_iter} lane {lane}"
                  f": {_parting(pb, st0, opt, lane)}")
        # x is held where it is an answer: an INFEASIBLE lane is held by
        # its status, iterations and active set alone, as the CPU tests
        # hold one (its last iterate rounds apart by up to ~1e-10 at
        # n = 128)
        answer = same & (want.term != 3)
        rel = ((got.x - want.x).abs().amax(dim=1)
               / want.x.abs().amax(dim=1).clamp_min(1.0))
        err = float(rel[answer].max())
        print(f"n={n} m={m} {dtype} max_iter={opt.max_iter}: "
              f"{len(parting)} of {batch + (m > 0)} lanes part, max |x err| "
              f"/ max(1, |x|) {err!r} (with the INFEASIBLE lanes "
              f"{float(rel[same].max())!r})")
        if dtype == torch.float64:
            assert parting == [] and err <= 1e-10, err
        else:
            assert float(same.double().mean()) >= 0.99 and err <= 1e-3, err
    terms = set(want.term.tolist())
    assert 3 in terms or m == 0            # the INFEASIBLE lane
    assert 4 in terms                       # the cap of 5 iterations


@pytest.mark.cuda
def test_jr_loop_kernel_lane_alone_equals_its_batch(cuda_device):
    # a lane's result is a function of its own inputs: alone, or in
    # another place of another batch, it is bit for bit the same
    pb = problem_from_numpy(**np_qp_batch(31, 1024, 50, 100, 0.3),
                            device=cuda_device)
    opt = SolverOptions(max_iter=150)
    st0 = dense.init_state(pb, opt)
    out = dense.run_loop(pb, st0, opt)
    rev = torch.arange(99, -1, -1, device=cuda_device)
    out_rev = dense.run_loop(pb._map(lambda t: t[rev]), dataclasses.replace(
        st0, **{f.name: getattr(st0, f.name)[rev]
                for f in dataclasses.fields(st0)}), opt)
    for i in (0, 1, 57, 511, 1023):
        alone = dense.run_loop(
            pb._map(lambda t: t[i:i + 1]), dataclasses.replace(
                st0, **{f.name: getattr(st0, f.name)[i:i + 1]
                        for f in dataclasses.fields(st0)}), opt)
        for f in dataclasses.fields(out):
            assert torch.equal(getattr(alone, f.name)[0],
                               getattr(out, f.name)[i]), (i, f.name)
            if i < 100:
                assert torch.equal(getattr(out_rev, f.name)[99 - i],
                                   getattr(out, f.name)[i]), (i, f.name)


@pytest.mark.cuda
def test_solve_batch_launches_k10_once(cuda_device):
    # the torch init, then one K10 launch and no f32 kernel; an empty batch
    # launches nothing; the hooked loop (on_pass) launches nothing either
    d, max_iter = make_case("eq_fixed")
    opt = SolverOptions(max_iter=max_iter)
    pb = problem_from_numpy(**d, device=cuda_device)
    before, k10 = _launches(), spans.counter("launch.K10")
    res = solve_batch(pb, opt)
    torch.cuda.synchronize()
    assert spans.counter("launch.K10") == k10 + 1 and _launches() == before
    _assert_same_result(res, solve_batch(problem_from_numpy(**d,
                                                            device="cpu"),
                                         opt), x_tol=1e-10)
    empty = solve_batch(pb._map(lambda t: t[:0]), opt)
    assert empty.x.shape == (0, pb.n)
    assert spans.counter("launch.K10") == k10 + 1
    dense.run_loop(pb, dense.init_state(pb, opt), opt,
                   on_pass=lambda a, b: None)
    assert spans.counter("launch.K10") == k10 + 1


@pytest.mark.cuda
def test_jr_loop_kernel_linear_dependency(cuda_device):
    # a full step onto a normal dependent on the active set (possible only
    # with zero_z_threshold < 0): LINEAR_DEPENDENCY_DETECTED, as the plain
    # version, in exact arithmetic on an axis-aligned lane
    n, m = 5, 3
    d = dict(G=np.eye(n)[None], a=np.zeros((1, n)), C=np.zeros((1, m, n)),
             l=np.full((1, m), -np.inf), u=np.full((1, m), np.inf),
             xl=np.full((1, n), -np.inf), xu=np.full((1, n), np.inf))
    d["a"][0, 0], d["xl"][0, 0] = 1.0, 0.0
    d["C"][0, 0, 0], d["l"][0, 0] = 0.1, 0.05
    opt = SolverOptions(zero_z_threshold=-1.0)
    for dev in (cuda_device, "cpu"):
        res = solve_batch(problem_from_numpy(**d, device=dev), opt)
        assert int(res.status[0]) == 5 and int(res.iterations[0]) == 2


# ---- K11, the explicit-form engine's loop ----

def _fast_opt(dtype, **kw):
    if dtype == torch.float32:
        kw = {"zero_z_threshold": 1e-6, **kw}
    return SolverOptions(dtype=dtype, **kw)


def _fast_against_plain(pb, st0, opt, label, x_tol, max_parted=0,
                        max_split=0):
    """K11 against its plain version from ``st0``
    (``fast_parting.against_plain``): the state passed in unchanged; the
    same status, iterations, active count and active set on every lane but
    at most ``max_parted`` (the count the runs on an H100 showed for the
    batch), each parting lane printed with its first parting iteration and
    both sides' deciding margins there, witnessed by
    ``fast_parting.near_ties`` (in f64 only a vertex; in f32 a margin
    within the two sides' measured rounding: the same algorithm in another
    summation order can flip only a test that rounding decides), and with
    sound outcomes on both sides (``fast_parting.outcomes``: the same
    class of end, or both refined to KKT <= 1e-8 and the same objective)
    on all but at most ``max_split`` lanes, each parted at a vertex, where
    one side ends with an answer and the other with none (on the same
    draws the JAX package's own loop splits so from the plain version,
    ``test_torch_fast_loop.py::test_jax_splits_answers_at_f32_vertices``);
    x within ``x_tol`` max(1, |x|) on the lanes whose x is an
    answer, and in f32 with m > 0 within 1e-7 after three steps of f64
    refinement on every same lane that ends SUCCESS and refines to KKT <=
    1e-8 in both. Returns (K11's state, the plain version's, the same
    lanes)."""
    keep = {f.name: getattr(st0, f.name).clone()
            for f in dataclasses.fields(st0)}
    before = spans.counter("launch.K11")
    cmp = fast_parting.against_plain(pb, st0, opt)
    torch.cuda.synchronize()
    # the comparison's own bisection launches K11 once per step
    assert spans.counter("launch.K11") > before
    for k, v in keep.items():
        assert torch.equal(getattr(st0, k), v), f"the input's {k} changed"
    got, want, same = cmp["k11"], cmp["plain"], cmp["same"]
    for lane, part in cmp["partings"].items():
        print(f"{label} lane {lane}: {part}")
    # f32 with general rows (the KKT oracle needs m > 0): the refinement
    # solve_refined runs
    ok = same & (want.term == 0) & (st0.x.dtype == torch.float32) & (pb.m > 0)
    if bool(ok.any()):
        pb64 = pb.with_dtype(torch.float64)
        exact = functools.partial(fast._DenseProducts, pb64, exact=True)
        rk, rp = (fast._refine_batch(pb64, st, 3, exact)
                  for st in (got, want))
        for r in (rk, rp):
            ok &= kkt_residual(r.x, r.multipliers, pb64) <= 1e-8
    ref_err = float((rk.x - rp.x).abs().amax(dim=1)[ok].max()) \
        if bool(ok.any()) else 0.0
    err = cmp["rel_x_err"]
    parts = cmp["partings"]
    print(f"{label}: {len(parts)} of {len(same)} lanes part (at most "
          f"{max_parted}), outcomes "
          f"{sorted({str(p['outcome']['terms']) for p in parts.values()})}, "
          f"max |x err| / max(1, |x|) {err!r} on {int(cmp['answer'].sum())} "
          f"lanes, refined {ref_err!r} on {int(ok.sum())}")
    assert [lane for lane, part in parts.items()
            if not part["near_ties"]] == []
    split = [lane for lane, part in parts.items()
             if not part["outcome"]["sound"]]
    print(f"{label}: split outcomes (at most {max_split}) on lanes {split}")
    assert all("vertex" in parts[lane]["near_ties"] for lane in split)
    assert len(split) <= max_split, (split, max_split)
    assert len(parts) <= max_parted, (len(parts), max_parted)
    assert err <= x_tol and ref_err <= 1e-7, (err, ref_err)
    return got, want, same


def _fast_tol(dtype):
    # x within 1e-10 max(1, |x|) in f64 (the same algorithm in another
    # summation order), 1e-3 in f32, as K10's
    return 1e-10 if dtype == torch.float64 else 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_fast_loop_kernel_matches_plain_headline(cuda_device, dtype):
    # the headline set (n = 50, m = 100, act_frac 0.3) at 1024 lanes
    pb = problem_from_numpy(**np_qp_batch(0, 1024, 50, 100, 0.3),
                            device=cuda_device).with_dtype(dtype)
    opt = _fast_opt(dtype, max_iter=150)
    _, _, same = _fast_against_plain(pb, fast._init_fast(pb, opt), opt,
                                     f"headline {dtype}", _fast_tol(dtype))
    assert bool(same.all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("m", [0, 1, 100])
@pytest.mark.parametrize("n", [10, 50, 128])
def test_fast_loop_kernel_matches_plain(cuda_device, n, m, dtype):
    # each lane kind of jr_card_batch (act_frac 0.3 and 0.9, equalities
    # and fixed variables, a box, an exactly INFEASIBLE lane), uncapped
    # and capped at 5 iterations. Where m >= n, lanes reach a vertex (q =
    # n), where H is zero in exact arithmetic and the engine's tests read
    # its rounding noise: such lanes part from the plain version (as the
    # JAX package's XLA loop parts from it on the CPU), each at a witnessed
    # near tie
    batch = 64 if dtype == torch.float64 else 256
    d = jr_card_batch(n, m, batch, seed=n + m + 7)
    pb = problem_from_numpy(**d, device=cuda_device).with_dtype(dtype)
    # the uncapped lanes that parted on an H100 (none at m < n or capped),
    # and of them those whose ends split into an answer and none
    parted = {torch.float64: {10: 9, 50: 4, 128: 4},
              torch.float32: {10: 66, 50: 52, 128: 32}}[dtype][n] * (m == 100)
    split = 6 * (dtype == torch.float32 and n == 10 and m == 100)
    for opt, most, most_split in (
            (_fast_opt(dtype, max_iter=4 * n + m), parted, split),
            (_fast_opt(dtype, max_iter=5), 0, 0)):
        _, want, _ = _fast_against_plain(
            pb, fast._init_fast(pb, opt), opt,
            f"n={n} m={m} {dtype} max_iter={opt.max_iter}", _fast_tol(dtype),
            most, most_split)
    terms = set(want.term.tolist())
    assert 4 in terms                       # the cap of 5 iterations
    assert 3 in terms or m == 0             # the INFEASIBLE lane


def _ik_state(d, device, gtype=GType.TRI_BLOCK_DIAGONAL):
    """(f32 problem, options, cold state) of the structured path on the IK
    draws ``d``: H = G^-1 by K5 + K6, then the torch init."""
    sg, a, sc, lo, up = _ik_problem(d, gtype, device)
    opt = SolverOptions(max_iter=200)
    _, pb32, opt32 = ssolver._problems(sg, a, sc, lo, up, None, None, opt)
    H, posdef = ssolver._structured_inverse_kernel_batch(
        sg.diag.float(), sg.off.float(), sg.gtype)
    eye = torch.eye(pb32.n, device=H.device)
    H = torch.where(posdef[:, None, None], H, eye)
    x = torch.where(posdef[:, None], -fast._bmv(H, pb32.a), 0.0)
    return pb32, opt32, fast._init_fast_from_ops(pb32, H, x, posdef, opt32)


@pytest.mark.cuda
def test_fast_loop_kernel_at_the_ik_shape(cuda_device):
    # the IK cold batch (n = 387, m = 36, 256 threads a block) at 1024
    # lanes, then one carried warm step from K11's own final state
    d = ik_batch(1024, seed=3)
    pb, opt, st0 = _ik_state(d, cuda_device)
    got, _, _ = _fast_against_plain(pb, st0, opt, "IK cold", 1e-3)
    step = ik_step(d, 0.02, np.random.default_rng(4))
    sg, a, sc, lo, up = _ik_problem(step, GType.TRI_BLOCK_DIAGONAL,
                                    cuda_device)
    _, pb2, _ = ssolver._problems(sg, a, sc, lo, up, None, None, opt)
    st_w = fast._init_fast_from_carry(pb2, got.H, got.Ns, got.status,
                                      got.aorder, got.q)
    _fast_against_plain(pb2, st_w, opt, "IK warm step", 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_fast_loop_kernel_resumes_a_pending_candidate(cuda_device, dtype):
    # lanes capped right after a partial step keep their candidate (skip1);
    # set RUNNING again, K11 resumes them without a selection
    pb = problem_from_numpy(**np_qp_batch(5, 256, 30, 60, 0.9),
                            device=cuda_device).with_dtype(dtype)
    opt = _fast_opt(dtype, max_iter=150)
    st0 = fast._init_fast(pb, opt)
    mid = fast.fast_loop_plain(pb, st0, opt.with_(max_iter=6))
    capped = mid.term == 4
    assert bool((capped & mid.skip1).any())
    mid = dataclasses.replace(mid, term=torch.where(capped, -1, mid.term).to(
        torch.int32))
    _fast_against_plain(pb, mid, opt, f"pending {dtype}", _fast_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_fast_loop_kernel_from_warm_hints(cuda_device, dtype):
    # the hint init that solve_fast_warm runs (_init_fast_warm: H and N*
    # from the hinted set, rows of N* from q on zero) on the headline set
    # at 1024 lanes: the solved active sets with one active row dropped on
    # the even lanes and an inactive row hinted at its lower bound on the
    # odd ones; then solve_fast_warm launches K11 once
    pb = problem_from_numpy(**np_qp_batch(11, 1024, 50, 100, 0.3),
                            device=cuda_device).with_dtype(dtype)
    opt = _fast_opt(dtype, max_iter=150, warm_start=True)
    hints = fast.fast_loop_plain(pb, fast._init_fast(pb, opt), opt
                                 ).status.clone()
    act = hints[:, :pb.m] != 0
    first_on = act.long().argmax(dim=1)
    first_off = (~act).long().argmax(dim=1)
    rows = torch.arange(pb.batch, device=cuda_device)
    even = rows % 2 == 0
    hints[rows[even], first_on[even]] = 0
    hints[rows[~even], first_off[~even]] = 1       # LOWER
    st0 = fast._init_fast_warm(pb, hints, opt)
    assert int(st0.q.min()) > 0
    assert bool((st0.Ns[torch.arange(pb.n, device=cuda_device)[None, :]
                        >= st0.q[:, None].long()] == 0).all())
    _fast_against_plain(pb, st0, opt, f"warm hints {dtype}",
                        _fast_tol(dtype))
    k11 = spans.counter("launch.K11")
    fast.solve_fast_warm(pb, hints, opt)
    torch.cuda.synchronize()
    assert spans.counter("launch.K11") == k11 + 1


def _lanes_of(st, idx):
    return dataclasses.replace(st, **{f.name: getattr(st, f.name)[idx]
                                      for f in dataclasses.fields(st)})


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["headline", "ik"])
def test_fast_loop_kernel_lane_alone_equals_its_batch(cuda_device, shape):
    # a lane's result is a function of its own inputs: alone, or in
    # another place of another batch, it is bit for bit the same (128
    # threads a block at the headline width, 256 at the IK width)
    if shape == "headline":
        pb = problem_from_numpy(**np_qp_batch(31, 1024, 50, 100, 0.3),
                                device=cuda_device).with_dtype(torch.float32)
        opt = _fast_opt(torch.float32, max_iter=150)
        st0 = fast._init_fast(pb, opt)
        lanes = (0, 1, 57, 511, 1023)
    else:
        pb, opt, st0 = _ik_state(ik_batch(64, seed=8), cuda_device)
        lanes = (0, 5, 63)
    B = pb.batch
    out = fast._run_loop(pb, st0, opt)
    rev = torch.arange(B - 1, -1, -1, device=cuda_device)
    out_rev = fast._run_loop(pb._map(lambda t: t[rev]),
                                  _lanes_of(st0, rev), opt)
    for i in lanes:
        alone = fast._run_loop(pb._map(lambda t: t[i:i + 1]),
                                    _lanes_of(st0, slice(i, i + 1)), opt)
        for f in dataclasses.fields(out):
            assert torch.equal(getattr(alone, f.name)[0],
                               getattr(out, f.name)[i]), (i, f.name)
            assert torch.equal(getattr(out_rev, f.name)[B - 1 - i],
                               getattr(out, f.name)[i]), (i, f.name)


@pytest.mark.cuda
def test_fast_paths_launch_k11_once(cuda_device):
    # solve_refined, solve_fast and the structured cold batch and warm step
    # run the loop as one K11 launch (the structured cold batch besides K5
    # and K6 once each); the tracer's hooked loop and an empty batch launch
    # nothing
    d, max_iter = make_case("eq_fixed")
    opt = SolverOptions(max_iter=max_iter)
    pb = problem_from_numpy(**d, device=cuda_device)
    for solve in (fast.solve_refined, fast.solve_fast):
        before, k11 = _launches(), spans.counter("launch.K11")
        res = solve(pb, opt)
        torch.cuda.synchronize()
        assert spans.counter("launch.K11") == k11 + 1 and _launches() == before
        _assert_same_result(res, solve(problem_from_numpy(**d, device="cpu"),
                                       opt), x_tol=1e-10)
    k11 = spans.counter("launch.K11")
    empty = fast.solve_refined(pb._map(lambda t: t[:0]), opt)
    assert empty.x.shape == (0, pb.n) and spans.counter("launch.K11") == k11
    st0 = fast._init_fast(pb, opt)
    fast._run_loop(pb, st0, opt, on_pass=lambda a, b: None)
    assert spans.counter("launch.K11") == k11
    k = ik_batch(4, nb=3, s=8, mc=2, seed=3)
    struct, k11 = _struct_counts(), spans.counter("launch.K11")
    res, carry = solve_structured_fast_carry(
        *_ik_problem(k, GType.TRI_BLOCK_DIAGONAL, cuda_device), None,
        opt=SolverOptions(max_iter=200))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_struct_counts(), struct)] == [1, 1, 0, 0]
    assert spans.counter("launch.K11") == k11 + 1
    step = ik_step(k, 0.02, np.random.default_rng(1))
    solve_structured_fast_carry(
        *_ik_problem(step, GType.TRI_BLOCK_DIAGONAL, cuda_device), carry,
        opt=SolverOptions(max_iter=200))
    torch.cuda.synchronize()
    assert spans.counter("launch.K11") == k11 + 2


@pytest.mark.cuda
def test_fast_loop_config_fits_the_ik_batch_in_one_wave(cuda_device):
    # 256 threads from n = 256 on; the C and Python shared-memory sizes
    # agree; 8 blocks of the IK shape (f32) fit an SM, so 1024 lanes are
    # resident at once on an H100's 132 SMs
    for n, m, dt in ((50, 100, torch.float32), (387, 36, torch.float32),
                     (387, 36, torch.float64)):
        cfg = fast_loop.fast_loop_config(n, m, dt)
        print(n, m, dt, cfg)
        assert cfg["threads"] == (256 if n >= 256 else 128)
        assert cfg["smem_bytes"] == fast_loop.fast_loop_smem_bytes(
            n, m, 8 if dt == torch.float64 else 4)
    assert fast_loop.fast_loop_config(387, 36)["blocks_per_sm"] >= 8


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@functools.lru_cache(maxsize=1)
def _ik_cold_onchip(device):
    """The IK cold batch at 1024 lanes (its state after the init) and the
    streamed instance's final state from it."""
    pb, opt, st0 = _ik_state(ik_batch(1024, seed=3), device)
    return pb, opt, st0, fast_loop._launch(
        "jrlqp_fast_loop_f32", pb, st0, opt, fast._dep_eps(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("start, n, m, cluster", [
    ("cold", 387, 36, 3), ("warm step", 387, 36, 3), ("hints", 387, 36, 3),
    ("lane kinds", 387, 36, 3), ("lane kinds", 300, 20, 2),
    ("lane kinds", 480, 36, 5), ("lane kinds", 600, 36, 8)])
def test_fast_loop_onchip_equals_streamed_bit_for_bit(cuda_device, start, n,
                                                      m, cluster):
    # K11's two instances through their C entry points at the IK shape (n =
    # 387, m = 36, f32: clusters of 3 blocks on chip): the same bits in x,
    # f, u, H, N*, status, aorder and the scalars from the IK cold batch's
    # state, from a carried warm step off K11's final state (most lanes end
    # at their first selection: their H is never loaded and comes back as
    # it went in), from the hint init's state on the IK batch (rows hinted
    # wrongly), and from jr_card_batch's lane kinds (the box lanes' bound
    # candidates and removals, equality rows, fixed variables, the
    # INFEASIBLE lane) drawn at the IK shape and at a width of each other
    # source the instance is compiled from (10, 16 and 20 columns a lane)
    pb, opt, st0, cold = _ik_cold_onchip(cuda_device)
    plan = fast_loop.fast_loop_plan(n, m, torch.float32)
    assert (plan["instance"], plan["cluster"]) == ("onchip", cluster)
    if start == "warm step":
        d = ik_batch(1024, seed=3)
        sg, a, sc, lo, up = _ik_problem(ik_step(d, 0.02,
                                                np.random.default_rng(4)),
                                        GType.TRI_BLOCK_DIAGONAL, cuda_device)
        _, pb, _ = ssolver._problems(sg, a, sc, lo, up, None, None, opt)
        st0 = fast._init_fast_from_carry(pb, cold.H, cold.Ns, cold.status,
                                         cold.aorder, cold.q)
    elif start == "hints":
        hints = cold.status.clone()
        act = hints[:, :pb.m] != 0
        rows = torch.arange(pb.batch, device=cuda_device)
        even = rows % 2 == 0
        hints[rows[even], act.long().argmax(dim=1)[even]] = 0
        hints[rows[~even], (~act).long().argmax(dim=1)[~even]] = 1  # LOWER
        opt = opt.with_(warm_start=True)
        st0 = fast._init_fast_warm(pb, hints, opt)
        assert int(st0.q.min()) > 0
    elif start == "lane kinds":
        batch = 256 if n == 387 else 64
        pb = problem_from_numpy(**jr_card_batch(n, m, batch, seed=n + 25),
                                device=cuda_device).with_dtype(torch.float32)
        opt = _fast_opt(torch.float32, max_iter=800)
        st0 = fast._init_fast(pb, opt)
    dep = fast._dep_eps(torch.float32)
    streamed = (cold if start == "cold" else fast_loop._launch(
        "jrlqp_fast_loop_f32", pb, st0, opt, dep))
    onchip = fast_loop._launch("jrlqp_fast_loop_onchip_f32", pb, st0, opt,
                               dep, plan["cluster"])
    torch.cuda.synchronize()
    for f in dataclasses.fields(onchip):
        assert torch.equal(_bits(getattr(onchip, f.name)),
                           _bits(getattr(streamed, f.name))), (start, f.name)
    its = onchip.it - st0.it
    removals = (its - (onchip.q - st0.q)) // 2
    print(f"{start} n={n}: iterations {int(its.sum())}, lanes without a "
          f"step {int((its == 0).sum())}, removals {int(removals.sum())}")
    if start == "warm step":
        still = its == 0
        assert int(still.sum()) > pb.batch // 2
        assert torch.equal(_bits(onchip.H[still]), _bits(st0.H[still]))
    if start == "lane kinds":
        assert int((removals > 0).sum()) > 0
    # the engine's dispatch launches the on-chip instance, counted twice
    k11, on = spans.counter("launch.K11"), spans.counter("launch.K11.onchip")
    out = fast._run_loop(pb, st0, opt)
    torch.cuda.synchronize()
    assert (spans.counter("launch.K11"), spans.counter("launch.K11.onchip")) \
        == (k11 + 1, on + 1)
    assert torch.equal(_bits(out.H), _bits(onchip.H))


@pytest.mark.cuda
def test_fast_loop_onchip_config_fits_a_cluster(cuda_device):
    # the on-chip instance at the IK shape: 256 threads, the Python plan's
    # shared bytes a block under a block's 232,448 B, clusters of 3 that the
    # card can hold resident, no spills
    cfg = fast_loop.fast_loop_config(387, 36, torch.float32, "onchip")
    print(cfg)
    plan = fast_loop.fast_loop_plan(387, 36, torch.float32)
    assert cfg["threads"] == 256 and cfg["cluster"] == plan["cluster"] == 3
    assert cfg["smem_bytes"] == plan["smem_bytes"] < 232448
    assert cfg["active_clusters"] > 0 and cfg["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("c_kind", ["blocks", "dense"])
@pytest.mark.parametrize("gtype", list(GType))
@pytest.mark.parametrize("shape", [(3, 8, 2, 6), (9, 43, 4, 64)],
                         ids=["small", "ik"])
def test_struct_refine_kernels_match_plain(cuda_device, shape, gtype,
                                           c_kind):
    # K13 and K14 against their plain versions on the same card tensors: a
    # structured state's slots, the start from the loop's x and
    # multipliers, then one step's products and update
    nb, s, mc, B = shape
    d = ik_batch(B, nb=nb, s=s, mc=mc, seed=nb + s + int(gtype))
    sg, a, sc, lo, up = _ik_problem(d, gtype, cuda_device)
    if c_kind == "dense":
        sc = sc.to_dense()
    pbs, _, _, st = ssolver._solve_structured_states(
        sg, a, sc, lo, up, None, None, SolverOptions(max_iter=200), "auto")
    seen = []
    fast._refine_batch(pbs, st, 0, products=lambda sl: seen.append(sl) or
                       fast._DenseProducts(pbs, sl))
    ops = ssolver._BlockProducts(sg, sc, seen[0])
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    u, v, r, dlam = (torch.randn(pbs.a.shape, generator=gen,
                                 device=cuda_device) for _ in range(4))
    args = (ops.diag, ops.off, ops.gtype)
    t, g = struct_refine.struct_gmul(*args, u, v, r)
    t_p, g_p = struct_refine.struct_gmul_plain(*args, u, v, r)
    torch.testing.assert_close(g, g_p, rtol=1e-13, atol=1e-13)
    torch.testing.assert_close(t, t_p, rtol=1e-6, atol=1e-5)
    _, g1 = struct_refine.struct_gmul(*args, None, v, None)
    torch.testing.assert_close(g1, g_p, rtol=1e-13, atol=1e-13)
    tail = (ops.C, ops.mc, ops.idx, ops.sgn, ops.a, ops.b)
    state = tuple(torch.zeros_like(ops.a) for _ in range(5))
    state_p = tuple(z.clone() for z in state)
    lam32 = torch.where(seen[0].valid, st.u[:, :pbs.n], 0.0).contiguous()
    for dx, dl, dy in ((st.x.contiguous(), lam32, g1), (v, dlam, g)):
        res = struct_refine.struct_update(*tail, dx, dl, dy, state)
        res_p = struct_refine.struct_update_plain(*tail, dx, dl, dy,
                                                  state_p)
        for got, want in zip(state, state_p):
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
        for got, want in zip(res, res_p):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("gtype", list(GType))
@pytest.mark.parametrize("nb, s", [(3, 97), (2, 150)])
def test_struct_gmul_takes_blocks_wider_than_its_threads(cuda_device, nb, s,
                                                         gtype):
    # K13 past the structured factor's block limit of 96 and past 128 (2 s
    # rows over 256 threads), against its plain version
    gen = torch.Generator(device=cuda_device).manual_seed(nb * s)
    B = 5

    def randn(*shape, dtype=torch.float64):
        return torch.randn(shape, generator=gen, device=cuda_device,
                           dtype=dtype)

    diag, off = randn(B, nb, s, s), randn(B, nb - 1, s, s)
    u, v, r = (randn(B, nb * s, dtype=torch.float32) for _ in range(3))
    before = spans.counter("launch.K13")
    t, g = struct_refine.struct_gmul(diag, off, int(gtype), u, v, r)
    _, g1 = struct_refine.struct_gmul(diag, off, int(gtype), None, v, None)
    assert spans.counter("launch.K13") == before + 2
    t_p, g_p = struct_refine.struct_gmul_plain(diag, off, int(gtype), u, v,
                                               r)
    torch.testing.assert_close(g, g_p, rtol=1e-13, atol=1e-12)
    torch.testing.assert_close(g1, g_p, rtol=1e-13, atol=1e-12)
    torch.testing.assert_close(t, t_p, rtol=1e-6, atol=1e-4)


@pytest.mark.cuda
def test_structured_refinement_at_the_ik_shape(cuda_device):
    # the IK cold batch (1024 x 387) and a warm step from its carry: the
    # refinement on the structure raises the peak of allocated memory by
    # less than one (B, n, n) f32 tensor, and its lanes pass SUCCESS with
    # KKT <= 1e-8 at least as often as the dense refinement's on the same
    # states; refine.structured reads 1 a call
    d = ik_batch(1024, seed=3)
    opt = SolverOptions(max_iter=200)
    cold = _ik_problem(d, GType.TRI_BLOCK_DIAGONAL, cuda_device)
    pbs, pb32, opt32, st = ssolver._solve_structured_states(
        *cold, None, None, opt, "auto")
    step = _ik_problem(ik_step(d, 0.02, np.random.default_rng(3)),
                       GType.TRI_BLOCK_DIAGONAL, cuda_device)
    pbs_w, pb32_w, _ = ssolver._problems(*step, None, None, opt)
    st_w = fast._run_loop(pb32_w, fast._init_fast_from_carry(
        pb32_w, st.H, st.Ns, st.status, st.aorder, st.q), opt32)
    B, n = pbs.a.shape

    def refined(refine):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = refine()
        torch.cuda.synchronize()
        return res, torch.cuda.max_memory_allocated() - base

    def passes(res, pb):
        kkt = kkt_residual(res.x, res.multipliers, pb)
        return int(((res.status == 0) & (kkt <= 1e-8)).sum())

    for name, args, pb, states in (("cold", cold, pbs, st),
                                   ("warm", step, pbs_w, st_w)):
        sg, _, sc, _, _ = args
        ours, rise = refined(lambda: ssolver._refine_structured(
            pb, sg, sc, states, 3))
        dense, rise_dense = refined(lambda: fast._refine_batch(pb, states,
                                                               3))
        print(name, rise, rise_dense, passes(ours, pb), passes(dense, pb))
        assert rise < B * n * n * 4, name
        assert passes(ours, pb) >= passes(dense, pb), name
    spans.reset("refine.structured")
    solve_structured_fast_batch(*cold, opt=opt)
    assert spans.counter("refine.structured") == 1


def _k12_against_plain(pb, carry, name):
    """K12's state from ``carry`` (H, N*, status, aorder, q) against its
    plain version's on the card: one launch; status, aorder, q, it, term
    and the pending candidate equal; x, u, f and hscale within 2e-5 and H
    and N* within 1e-6 of max(1, |lane|): the f32 dot products' sums run
    in another order, over n terms (on an H100 the widest read 1.5e-6 and
    1.2e-7, at the IK shape and on the ragged carries). Returns the plain
    state."""
    before = spans.counter("launch.K12")
    got = fast._init_carry(pb, *carry)
    torch.cuda.synchronize()
    assert spans.counter("launch.K12") == before + 1, name
    want = fast._init_fast_from_carry(pb, *carry)
    for k in ("status", "aorder", "q", "it", "term", "skip1", "sc_idx",
              "sc_status"):
        assert torch.equal(getattr(got, k), getattr(want, k)), (name, k)
    errs = {}
    for k in ("x", "u", "f", "hscale", "H", "Ns"):
        g, w = (getattr(s, k).reshape(pb.batch, -1) for s in (got, want))
        errs[k] = float(((g - w).abs().amax(dim=1)
                         / w.abs().amax(dim=1).clamp_min(1.0)).max())
    print(name, "deactivations", torch.bincount(want.it).tolist(), errs)
    for k, tol in (("x", 2e-5), ("u", 2e-5), ("f", 2e-5), ("hscale", 2e-5),
                   ("H", 1e-6), ("Ns", 1e-6)):
        assert errs[k] <= tol, (name, k, errs[k])
    return want


@pytest.mark.cuda
def test_carry_init_kernel_matches_plain_at_the_ik_shape(cuda_device):
    # K12 from a real carry at the benchmark cell ik9x43-track's shape
    # (1,024 problems of n = 387, m = 36): K11's final states of the IK
    # cold batch, then a step drifted by 0.02 on most lanes and by 0.5 on
    # every eighth, so that lanes deactivate none, one and three or more
    # slots
    d = ik_batch(1024, seed=3)
    pb, opt, st0 = _ik_state(d, cuda_device)
    got = fast._run_loop(pb, st0, opt)
    rng = np.random.default_rng(4)
    step, wide = ik_step(d, 0.02, rng), ik_step(d, 0.5, rng)
    for k in ("a", "l", "u"):
        step[k][::8] = wide[k][::8]
    sg, a, sc, lo, up = _ik_problem(step, GType.TRI_BLOCK_DIAGONAL,
                                    cuda_device)
    _, pb2, _ = ssolver._problems(sg, a, sc, lo, up, None, None, opt)
    want = _k12_against_plain(
        pb2, (got.H, got.Ns, got.status, got.aorder, got.q), "IK")
    assert bool((want.it == 0).any() and (want.it == 1).any()
                and (want.it >= 3).any())


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.02, 0.5])
@pytest.mark.parametrize("name", list(HOLES))
def test_carry_init_kernel_matches_plain_on_ragged_carries(cuda_device, name,
                                                           scale):
    # K12 from K1's carries, whose slots hold holes, on drifted bounds
    seed, B, n, m, act_frac = HOLES[name]
    d = np_qp_batch(seed, B, n, m, act_frac)
    _, carry = fast.solve_refined_kernel_carry(
        problem_from_numpy(**d, device=cuda_device), None,
        SolverOptions(max_iter=100))
    ao = carry.aorder
    assert bool(((ao[:, :-1] < 0) & (ao[:, 1:] >= 0)).any())
    d2 = {k: v.astype(np.float32) for k, v in drifted(d, scale, 3).items()}
    want = _k12_against_plain(
        problem_from_numpy(**d2, device=cuda_device),
        (carry.H, carry.Ns, carry.status, carry.aorder, carry.q),
        f"{name} drift {scale}")
    if scale == 0.5:
        assert int(want.it.sum()) > 0


@pytest.mark.cuda
def test_carry_init_kernel_takes_float32_only(cuda_device):
    d = np_qp_batch(0, 4, 8, 16, 0.5)
    pb = problem_from_numpy(**d, device=cuda_device)
    _, carry = fast.solve_refined_kernel_carry(pb, None,
                                               SolverOptions(max_iter=100))
    args = (carry.H, carry.Ns, carry.status, carry.aorder, carry.q)
    with pytest.raises(TypeError, match="float32"):
        fast._init_carry(pb, *args)             # a float64 problem
    with pytest.raises(RuntimeError, match="no kernel"):
        fast._init_carry(pb.with_dtype(torch.float32)._map(
            lambda t: t.to("meta")), *(t.to("meta") for t in args))


def _benchmark_paths(device):
    """The three paths of the benchmark's cells at their sizes, each a
    function that makes one call: the dense main path (16,384 problems of
    n = 50, K1), the IK cold batch and an IK warm step (1,024 problems of
    n = 387, K5 + K6 and K11; the step from a cold step's carry)."""
    gen = torch.Generator(device=device).manual_seed(19)
    pb = random_qp_batch(gen, 16384, 50, 100, 0.3, dtype=torch.float32,
                         device=device).with_dtype(torch.float64)
    d = ik_batch(1024, seed=19)
    cold = _ik_problem(d, GType.TRI_BLOCK_DIAGONAL, device)
    step = _ik_problem(ik_step(d, 0.02, np.random.default_rng(19)),
                       GType.TRI_BLOCK_DIAGONAL, device)
    opt_ik = SolverOptions(max_iter=200)
    _, carry = solve_structured_fast_carry(*cold, None, opt=opt_ik)
    return {
        "dense": lambda: fast.solve_refined_kernel(
            pb, SolverOptions(max_iter=150), ir_steps=1),
        "ik_cold": lambda: solve_structured_fast_batch(*cold, opt=opt_ik),
        "ik_track": lambda: solve_structured_fast_carry(*step, carry,
                                                        opt=opt_ik)}


def _recorded_call(solve):
    """The spans of one recorded call of ``solve`` (after a warm-up)."""
    solve()
    torch.cuda.synchronize()
    spans.clear()
    with spans.recording():
        solve()
    torch.cuda.synchronize()
    (call,) = spans.recorded()
    return call


@pytest.mark.cuda
def test_every_host_sync_of_the_benchmark_paths_is_a_sync_span(cuda_device):
    # under torch's sync debug mode each synchronizing operation warns: on
    # each path exactly as often as the call opens jrlqp.sync.* spans
    import warnings

    for name, solve in _benchmark_paths(cuda_device).items():
        solve()
        torch.cuda.synchronize()
        spans.clear()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with spans.recording():
                    solve()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in seen if "called a synchronizing CUDA operation"
                 in str(w.message)]
        (call,) = spans.recorded()
        opened = [s.name for s in call if s.name.startswith("jrlqp.sync.")]
        print(name, len(syncs), opened)
        assert len(syncs) == len(opened), (
            name, opened, [f"{w.filename}:{w.lineno}" for w in syncs])
        if name == "ik_track":             # the carry init is one K12
            assert opened == []


@pytest.mark.cuda
def test_an_ik_warm_step_launches_k12_once_and_reads_nothing_back(
        cuda_device):
    # the warm step of ik9x43-track's path: one K12 and one K11 launch a
    # step, and no jrlqp.sync.* span
    step = _benchmark_paths(cuda_device)["ik_track"]
    step()
    torch.cuda.synchronize()
    spans.reset("launch")
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    assert spans.counter("launch.K12") == 3
    assert spans.counter("launch.K11") == 3
    call = _recorded_call(step)
    assert [s.name for s in call if s.name.startswith("jrlqp.sync.")] == []


@pytest.mark.cuda
def test_the_stages_cover_the_call_on_the_card(cuda_device):
    # the device spans of the root's children sum to within 3% of the
    # root's own device span: the stages leave no device time out
    for name, solve in _benchmark_paths(cuda_device).items():
        call = _recorded_call(solve)
        root = call[0]
        stages = sum(s.device_ms for s in call if s.parent is root)
        print(name, root.device_ms, stages,
              {s.stage: round(s.device_ms, 3) for s in call
               if s.parent is root})
        assert root.device is not None and root.device.type == "cuda"
        assert abs(stages - root.device_ms) <= 0.03 * root.device_ms, name


@pytest.mark.cuda
def test_the_loop_span_holds_its_kernel(cuda_device, tmp_path):
    # one call under torch.profiler and spans.recording(): the loop stage's
    # device span is at least the loop kernel's own time (K1 on the dense
    # path, K11 on the IK cold batch), and the spans are user annotations
    # of the trace
    kernels = {"dense": "gi_fused_kernel", "ik_cold": "fast_loop_kernel"}
    paths = _benchmark_paths(cuda_device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, kernel in kernels.items():
        paths[name]()
        torch.cuda.synchronize()
        spans.clear()
        with torch.profiler.profile(activities=acts) as prof, \
                spans.recording():
            paths[name]()
            torch.cuda.synchronize()
        (call,) = spans.recorded()
        (loop,) = [s for s in call if s.name == "jrlqp.loop"]
        path = tmp_path / f"{name}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        k_us = sum(float(e["dur"]) for e in events
                   if e.get("cat") == "kernel" and kernel in e["name"])
        notes = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
        print(name, loop.device_ms, k_us / 1e3)
        assert k_us > 0 and {s.name for s in call} <= notes
        assert loop.device_ms >= 0.999 * k_us / 1e3 - 1e-3, name


def _dense_track_step(device):
    """One warm step of the dense control loop at the benchmark cell
    ``dense50-track``'s shape (16,384 problems of n = 50, m = 100, 40% of
    the rows tight, one refinement step): the step of a drifted problem
    from a cold step's carry."""
    gen = torch.Generator(device=device).manual_seed(22)
    pb = random_qp_batch(gen, 16384, 50, 100, 0.4, dtype=torch.float32,
                         device=device).with_dtype(torch.float64)
    kw = dict(generator=gen, dtype=torch.float64, device=device)
    da = 0.02 * torch.randn(pb.a.shape, **kw)
    db = 0.02 * torch.randn(pb.l.shape, **kw)
    step = dataclasses.replace(pb, a=pb.a + da, l=pb.l + db, u=pb.u + db)
    opt = SolverOptions(max_iter=150)
    _, carry = fast.solve_refined_kernel_carry(pb, None, opt, ir_steps=1)
    return lambda: fast.solve_refined_kernel_carry(step, carry, opt,
                                                   ir_steps=1)


@pytest.mark.cuda
def test_a_dense_warm_step_is_one_k4_launch_inside_its_stages(cuda_device):
    # one warm step: one K4 launch and no K1; as many synchronizing
    # operations as jrlqp.sync.* spans; and its prepare, loop, remap and
    # refine stages cover the call's device span within 5%
    import warnings

    step = _dense_track_step(cuda_device)
    step()
    torch.cuda.synchronize()
    spans.reset("launch")
    spans.clear()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with spans.recording():
                step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = spans.counts("launch")
    assert launches.get("launch.K4") == 1 and not launches.get("launch.K1")
    syncs = [w for w in seen if "called a synchronizing CUDA operation"
             in str(w.message)]
    (call,) = spans.recorded()
    opened = [s.name for s in call if s.name.startswith("jrlqp.sync.")]
    root = call[0]
    stages = [s for s in call if s.parent is root]
    by_stage = {}
    for s in stages:
        by_stage[s.stage] = by_stage.get(s.stage, 0.0) + s.device_ms
    print(launches, opened, root.device_ms, by_stage)
    assert len(syncs) == len(opened), (
        opened, [f"{w.filename}:{w.lineno}" for w in syncs])
    assert set(by_stage) == {"prepare", "loop", "remap", "refine"}
    assert abs(sum(by_stage.values()) - root.device_ms) <= \
        0.05 * root.device_ms


@pytest.mark.cuda
def test_gi_warm_kernel_takes_the_cold_state_on_flagged_lanes(cuda_device):
    # K4 with every other lane flagged for reset: those lanes start from
    # the cold step's state, as its plain version does, and their step is
    # the step from the cold carry itself, bit for bit
    d = np_qp_batch(11, 64, 12, 20, 0.4)
    max_iter = 200
    opt = SolverOptions(max_iter=max_iter)
    _, cold = fast.solve_refined_kernel_carry(
        problem_from_numpy(**d, device=cuda_device), None, opt)
    _, carry = fast.solve_refined_kernel_carry(
        problem_from_numpy(**drifted(d, 0.02, 3), device=cuda_device), cold,
        opt)
    pb = problem_from_numpy(**drifted(d, 0.02, 4), device=cuda_device)
    reset = (torch.arange(64, device=cuda_device) % 2).to(torch.int32)
    ins, (n, m) = gi_kernel.prepare_warm_carry(pb, carry.raw, carry.q,
                                               reset, cold.first)
    ours = gi_kernel.postprocess(
        gi_kernel._gi_warm_cuda_raw(*ins, n, m, max_iter), n, m)
    _assert_close_scaled(ours, gi_kernel.postprocess(
        gi_kernel._gi_warm_plain_raw(*ins, n, m, max_iter), n, m))
    ins_c, _ = gi_kernel.prepare_warm_carry(pb, cold.raw, cold.q,
                                            torch.zeros_like(reset),
                                            cold.first)
    from_cold = gi_kernel.postprocess(
        gi_kernel._gi_warm_cuda_raw(*ins_c, n, m, max_iter), n, m)
    odd = reset.bool()
    for k in ours:
        assert torch.equal(ours[k][odd], from_cold[k][odd]), k
