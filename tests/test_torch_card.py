"""The port's kernels (K1-K9) on a CUDA card, held against their plain
PyTorch versions on the same card; the launch counts of the structured
path, the compact-slot path, the trajectory capture and the rescue; the
box solve, the sharded solve on one card and K3 at the corpus's largest
bucket; K1 at the size sweep's largest row, the compacted solve and the
harness's kernel rows; the default device; and the numpy batch generators that the CPU
tests share.

This file imports neither jax nor the JAX package, so it runs on a machine
with a card and no jax:

    python -m pytest --noconftest tests/test_torch_card.py -m cuda

Without a card every test here skips.
"""
import dataclasses
import pathlib

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
from jrlqp_tpu_torch.ops.cuda import block_llt, gi_kernel
from jrlqp_tpu_torch.parallel import make_mesh, solve_sharded
from jrlqp_tpu_torch.solver import fast
from jrlqp_tpu_torch.structured import (
    GType,
    solve_structured_fast_batch,
    solve_structured_fast_carry,
    structured_from_numpy,
    structured_qp_problem,
)
from jrlqp_tpu_torch.testing import (
    ProblemCharacteristics,
    order_exact,
    random_problem,
)
from jrlqp_tpu_torch.testing.ik_gen import ik_batch, ik_step
from jrlqp_tpu_torch.testing.kkt import kkt_residual


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
    before = block_llt.launches
    L, Li, pd = block_llt.chol_inv_b(A)
    torch.cuda.synchronize()
    assert block_llt.launches == before + 1
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
    before = gi_kernel.launches
    ours = gi_kernel.run_loop_fused(pb, max_iter)
    torch.cuda.synchronize()
    assert gi_kernel.launches == before + 1
    _assert_kernel_matches_plain(ours, gi_kernel.gi_fused_plain(pb, max_iter))


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
    before = gi_kernel.loop_launches
    ours = gi_kernel.run_loop(pb, state0, max_iter)
    torch.cuda.synchronize()
    assert gi_kernel.loop_launches == before + 1
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
    before = gi_kernel.warm_launches
    ours = gi_kernel.run_warm_loop(pb, *co, max_iter)
    torch.cuda.synchronize()
    assert gi_kernel.warm_launches == before + 1
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
    return (block_llt.tri_llt_launches, block_llt.tri_solve_launches,
            block_llt.arrow_llt_launches, block_llt.arrow_solve_launches)


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
    before = block_llt.tri_llt_launches
    ours = block_llt.tri_block_llt(diag.to(cuda_device), off.to(cuda_device))
    torch.cuda.synchronize()
    assert block_llt.tri_llt_launches == before + 1
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
    before = block_llt.arrow_llt_launches
    ours = block_llt.block_arrow_llt(diag.to(cuda_device),
                                     off.to(cuda_device), up=up)
    torch.cuda.synchronize()
    assert block_llt.arrow_llt_launches == before + 1
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
    # no GI kernel; a warm carry step launches nothing
    d = ik_batch(6, nb=3, s=8, mc=2, seed=5)
    opt = SolverOptions(max_iter=200)
    before = _struct_counts()
    gi_before = (gi_kernel.launches, gi_kernel.loop_launches,
                 gi_kernel.warm_launches)
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
    assert (gi_kernel.launches, gi_kernel.loop_launches,
            gi_kernel.warm_launches) == gi_before
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
    before = gi_kernel.compact_launches
    ours = gi_kernel.run_loop_compact(pb, state0, max_iter)
    torch.cuda.synchronize()
    assert gi_kernel.compact_launches == before + 1
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
    before = gi_kernel.compact_launches
    ours = gi_kernel.run_loop_compact(pb, state0, 150)
    torch.cuda.synchronize()
    assert gi_kernel.compact_launches == before + 1
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
        args, count = (pb, max_iter), "launches"
        run, plain = gi_kernel.run_loop_fused, gi_kernel.gi_fused_plain
    elif kernel == "K9":
        args = (pb, fast._init_fast(pb, _opt32(max_iter)), max_iter)
        count = "compact_launches"
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
        count = "loop_launches"
        run, plain = gi_kernel.run_loop, gi_kernel.gi_loop_plain
    else:
        _, carry = fast.solve_refined_kernel_carry(
            problem_from_numpy(**d, device=cuda_device), None,
            SolverOptions(max_iter=max_iter))
        pb = _f32_problem(drifted(d, 0.02, 7), cuda_device)
        args = (pb, carry.H, carry.Ns, carry.status, carry.aorder, carry.q,
                max_iter)
        count = "warm_launches"
        run, plain = gi_kernel.run_warm_loop, gi_kernel.gi_warm_plain
    before = getattr(gi_kernel, count)
    ours = run(*args)
    torch.cuda.synchronize()
    assert getattr(gi_kernel, count) == before + 1
    _assert_close_scaled(ours, plain(*args))


def _warm_kernel_and_plain(pb, carry, max_iter):
    """K4 and its plain version on the same inputs, from a carry in the
    kernels' own layout; K4 launches once."""
    ins, (n, m) = gi_kernel.prepare_warm_carry(pb, carry.raw, carry.q)
    before = gi_kernel.warm_launches
    ours = gi_kernel.postprocess(
        gi_kernel._gi_warm_cuda_raw(*ins, n, m, max_iter), n, m)
    torch.cuda.synchronize()
    assert gi_kernel.warm_launches == before + 1
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
    before = block_llt.tri_solve_launches
    y = block_llt.tri_block_solve(Lo, Li, r, lower_only)
    ref = block_llt.tri_block_solve_plain(Lo, Li, r, lower_only)
    torch.cuda.synchronize()
    assert block_llt.tri_solve_launches == before + 1
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


@pytest.mark.cuda
@pytest.mark.xfail(strict=True, reason=(
    "a fault of K1 on the card that no change to its arithmetic alone "
    "repairs (ROADMAP queue 3, PERF.md section 6): K1 and its plain version "
    "take the same 60 steps, but rounding leaves K1's x with constraint 95 "
    "at a slack of -1.4e-6 (the plain versions +1.1e-6 and +1.2e-6, the f64 "
    "vertex +8.9e-7), so K1 activates it in a 61st iteration and the "
    "refined result stalls at a KKT residual of 7.0e-8; each of the eleven "
    "variants of K1's sums that were tried and pass this lane fails another "
    "lane of the same four batches, as the plain version does (lane 9832)"))
def test_main_path_lane_on_card(cuda_device):
    # lane 11415 of the headline batch, the one lane in 16384 that misses the
    # main path's gate; tests/test_torch_main_path_lane.py holds the same
    # arrays against the JAX package on the CPU, where every path passes
    path = pathlib.Path(__file__).parent / "data" / "main_path_lane_11415.npz"
    z = np.load(path)
    pb = problem_from_numpy(**{k: z[k] for k in ("G", "a", "C", "l", "u",
                                                 "xl", "xu")},
                            device=cuda_device)
    res = fast.solve_refined_kernel(pb, SolverOptions(max_iter=150),
                                    ir_steps=1)
    assert res.status.tolist() == [0]
    assert float(kkt_residual(res.x, res.multipliers, pb).max()) <= 1e-8


def _launches():
    return (gi_kernel.launches, gi_kernel.loop_launches,
            gi_kernel.warm_launches, gi_kernel.compact_launches)


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
    before = gi_kernel.compact_launches
    traj = capture_kernel_trajectory(
        problem_from_numpy(**one, device=cuda_device), opt, n_iters=6)
    torch.cuda.synchronize()
    assert gi_kernel.compact_launches == before + 6
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


@pytest.mark.cuda
@pytest.mark.parametrize("engine,fused_init", [("f64", False),
                                               ("pallas", False),
                                               ("pallas", True)])
@pytest.mark.parametrize("shards", [1, 4])
def test_solve_sharded_on_card(cuda_device, engine, fused_init, shards):
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
    ref = (fast.solve_refined_kernel(pb, opt, fused_init=fused_init)
           if engine == "pallas" else solve_batch(pb, opt))
    _assert_same_result(res, dataclasses.replace(
        ref, **{f.name: getattr(ref, f.name).cpu()
                for f in dataclasses.fields(ref)}), x_tol=1e-10)
    it = res.iterations.long()
    assert (stats.total_iterations, stats.n_success, stats.max_iterations) \
        == (int(it.sum()), int((res.status == 0).sum()), int(it.max()))


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
    before = gi_kernel.loop_launches
    ours = gi_kernel.run_loop(pb, state0, 400)
    torch.cuda.synchronize()
    assert gi_kernel.loop_launches == before + 1
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
    before = gi_kernel.launches
    ours = gi_kernel.run_loop_fused(pb, 500)
    torch.cuda.synchronize()
    assert gi_kernel.launches == before + 1
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
@pytest.mark.parametrize("solver,count", [("pallas", "launches"),
                                          ("pallas_rescued",
                                           "loop_launches")])
def test_time_batch_pallas_rows_launch_their_kernel(cuda_device, solver,
                                                    count):
    # a warm-up call and n_rep timed calls, each one launch of the kernel
    pb = problem_from_numpy(**np_qp_batch(7, 256, 20, 40, 0.3),
                            device=cuda_device)
    before = getattr(gi_kernel, count)
    row = time_batch("t", pb, SolverOptions(max_iter=150), solver=solver,
                     n_rep=2)
    assert getattr(gi_kernel, count) == before + 3
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
