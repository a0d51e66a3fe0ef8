"""The structured entry points' refinement on the structure: G's products by
its f64 blocks, the active normals' by C's rows (a StructuredC or a dense
C), every increment in f64 (``structured.solver._BlockProducts`` and the
plain versions of K13 and K14), against the dense refinement of the same
f32 states (``fast._DenseProducts``), at the IK generator's small
shapes."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from jrlqp_tpu_torch import SolverOptions
from jrlqp_tpu_torch.ops.cuda import struct_refine
from jrlqp_tpu_torch.solver import fast
from jrlqp_tpu_torch.structured import (
    GType,
    StructuredC,
    solve_structured_fast,
    solve_structured_fast_batch,
    solve_structured_fast_carry,
    structured_from_numpy,
)
from jrlqp_tpu_torch.structured import solver as ssolver
from jrlqp_tpu_torch.testing.ik_gen import ik_batch, ik_step
from jrlqp_tpu_torch.testing.kkt import kkt_residual
from jrlqp_tpu_torch.utils import spans

torch.set_num_threads(1)

NB, S, MC, B = 3, 8, 2, 5
SHAPES = [(NB, S, MC, B), (4, 16, 3, 16)]
C_KINDS = ["blocks", "dense"]
f64 = torch.float64


def _args(d, gtype, c_kind="blocks"):
    sg, sc = structured_from_numpy(diag=d["diag"], off=d["off"], gtype=gtype,
                                   blocks=d["blocks"], device="cpu")
    if c_kind == "dense":
        sc = sc.to_dense()
    return sg, torch.from_numpy(d["a"]), sc, torch.from_numpy(d["l"]), \
        torch.from_numpy(d["u"])


def _states(shape, gtype, c_kind="blocks", seed=None):
    """(args, dense f64 problem, the loop's final f32 states)."""
    nb, s, mc, b = shape
    d = ik_batch(b, nb=nb, s=s, mc=mc,
                 seed=int(gtype) + 1 if seed is None else seed)
    args = _args(d, gtype, c_kind)
    pbs, _, _, st = ssolver._solve_structured_states(
        *args, None, None, SolverOptions(max_iter=200), "auto")
    return args, pbs, st


def _slots(pbs, st):
    """The refinement's own slots of the states ``st``."""
    seen = []

    def keep(slots):
        seen.append(slots)
        return fast._DenseProducts(pbs, slots)

    fast._refine_batch(pbs, st, 0, products=keep)
    return seen[0]


def _close(got, want, rel):
    scale = max(float(want.abs().max()), 1e-300)
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.parametrize("gtype", list(GType))
def test_block_g_products_equal_the_dense_ones(gtype):
    # K13's plain version: f32(G u) - r and G v in f64 by G's blocks in one
    # pass, or G v alone, against the dense G
    d = ik_batch(B, nb=NB, s=S, mc=MC, seed=int(gtype) + 21)
    sg = _args(d, gtype)[0]
    G = sg.to_dense()
    gen = torch.Generator().manual_seed(7)
    u, v, r = (torch.randn((B, NB * S), generator=gen) for _ in range(3))
    t, g = struct_refine.struct_gmul(sg.diag, sg.off, int(gtype), u, v, r)
    assert t.dtype == torch.float32 and g.dtype == f64
    _close(g, fast._bmv(G, v.double()), 1e-13)
    torch.testing.assert_close(
        t, fast._bmv(G, u.double()).float() - r, rtol=0, atol=0)
    none, g1 = struct_refine.struct_gmul(sg.diag, sg.off, int(gtype), None,
                                         v, None)
    assert none is None and torch.equal(g1, g)


@pytest.mark.parametrize("c_kind", C_KINDS)
@pytest.mark.parametrize("gtype", list(GType))
def test_block_normal_products_equal_the_dense_ones(gtype, c_kind):
    # the tracked quantities after the start and after one step, against
    # the dense f64 products of the same x and lam: G x, N^T x from C's
    # rows, N lam = C^T mu_c + mu_b
    (sg, _, sc, _, _), pbs, st = _states(SHAPES[1], gtype, c_kind)
    slots = _slots(pbs, st)
    assert bool(slots.valid.any()) and bool((~slots.is_b & slots.valid).any())
    rows = slots.rows(pbs.C.to(f64))                # N^T, (B, n, n)
    blk = ssolver._BlockProducts(sg, sc, slots)
    dense = fast._DenseProducts(pbs, slots, exact=True)
    gen = torch.Generator().manual_seed(3)
    x32 = torch.randn(pbs.a.shape, generator=gen)
    lam32 = torch.where(slots.valid, torch.randn(pbs.a.shape, generator=gen),
                        0.0)
    r_blk = blk.start(x32, lam32)
    r_dense = dense.start(x32, lam32)
    dx = torch.randn(pbs.a.shape, generator=gen)
    dlam = torch.randn(pbs.a.shape, generator=gen)
    for step in range(2):
        x, lam, y, ntx, w = blk.state
        assert torch.equal(x, dense.x) and torch.equal(lam, dense.lam)
        for got, want in [(y, fast._bmv(pbs.G, x)), (y, dense.y),
                          (ntx, fast._bmv(rows, x)), (ntx, dense.ntx),
                          (w, fast._bmtv(rows, lam)), (w, dense.w)]:
            assert got.dtype == f64
            _close(got, want, 1e-13)
        for got, want in zip(r_blk, r_dense):
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        if step == 0:
            t = blk.correction(x32, dx, r_blk[0])
            torch.testing.assert_close(
                t, dense.correction(x32, dx, r_blk[0]), rtol=1e-5,
                atol=1e-5)
            r_blk, r_dense = blk.advance(dx, dlam), dense.advance(dx, dlam)


@pytest.mark.parametrize("c_kind", C_KINDS)
@pytest.mark.parametrize("gtype", list(GType))
@pytest.mark.parametrize("shape", SHAPES, ids=["small", "wider"])
def test_structured_refinement_against_the_dense_one(shape, gtype, c_kind):
    # on the same f32 states: the same ends, x to 1e-9, and a largest KKT
    # residual no larger than the dense refinement's f32 increments leave
    (sg, _, sc, _, _), pbs, st = _states(shape, gtype, c_kind)
    dense = fast._refine_batch(pbs, st, 3)
    ours = ssolver._refine_structured(pbs, sg, sc, st, 3)
    for k in ("status", "iterations", "active_set"):
        assert torch.equal(getattr(ours, k), getattr(dense, k)), k
    assert bool((ours.status == 0).all())
    torch.testing.assert_close(ours.x, dense.x, rtol=0, atol=1e-9)
    k_ours = float(kkt_residual(ours.x, ours.multipliers, pbs).max())
    k_dense = float(kkt_residual(dense.x, dense.multipliers, pbs).max())
    print(shape, gtype.name, c_kind, k_ours, k_dense)
    assert k_ours <= k_dense


class _Largest(TorchDispatchMode):
    """The largest tensor any op makes: of its outputs, those that are not
    a view of an input."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {a.untyped_storage().data_ptr()
               for a in list(args) + list((kwargs or {}).values())
               if isinstance(a, torch.Tensor)}
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if (isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() not in ins):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("c_kind", C_KINDS)
def test_structured_refinement_makes_no_square_operand(c_kind):
    # the dense refinement makes (B, n, n) tensors (f32 G, the normals);
    # the structured one makes none, whatever C's form
    (sg, _, sc, _, _), pbs, st = _states(SHAPES[1], GType.TRI_BLOCK_DIAGONAL,
                                         c_kind)
    b, n = pbs.a.shape
    with _Largest() as dense:
        fast._refine_batch(pbs, st, 3)
    with _Largest() as ours:
        ssolver._refine_structured(pbs, sg, sc, st, 3)
    assert dense.numel >= b * n * n
    assert ours.numel < b * n * n // 4, ours.numel


def test_refine_structured_counts_once_per_structured_call():
    d = ik_batch(B, nb=NB, s=S, mc=MC, seed=5)
    args = _args(d, GType.TRI_BLOCK_DIAGONAL)
    opt = SolverOptions(max_iter=200)
    spans.reset("refine.structured")
    solve_structured_fast_batch(*args, opt=opt)
    assert spans.counter("refine.structured") == 1
    _, carry = solve_structured_fast_carry(*args, None, opt=opt)
    assert spans.counter("refine.structured") == 2
    step = _args(ik_step(d, 0.02, np.random.default_rng(5)),
                 GType.TRI_BLOCK_DIAGONAL)
    solve_structured_fast_carry(*step, carry, opt=opt)
    assert spans.counter("refine.structured") == 3
    sg, a, sc, lo, up = args
    one = dataclasses.replace(sg, diag=sg.diag[0], off=sg.off[0])
    solve_structured_fast(one, a[0], StructuredC(blocks=sc.blocks[0]),
                          lo[0], up[0], opt=opt)
    assert spans.counter("refine.structured") == 4
    # the dense callers refine through the dense products
    pbs = ssolver.structured_qp_problem(*args)
    fast.solve_refined_kernel(pbs, opt)
    fast.solve_refined(pbs, opt)
    assert spans.counter("refine.structured") == 4
