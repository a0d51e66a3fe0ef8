"""The structured layer's linear algebra: the port's composed blocks
(``jrlqp_tpu_torch.structured.blocks``) against the JAX package's in f64,
the plain versions of K5-K8 against the Pallas kernels in interpret mode
in f32, the containers, and the IK generator against the JAX benchmark's.
Inputs are made with numpy and shared by both packages."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu.ops.pallas import block_llt as jbl
from jrlqp_tpu.structured import blocks as jblocks
from jrlqp_tpu.structured.containers import StructuredC as JStructuredC
from jrlqp_tpu_torch.ops.cuda import block_llt
from jrlqp_tpu_torch.structured import (
    GType,
    StructuredG,
    blocks,
    structured_from_numpy,
)
from jrlqp_tpu_torch.testing.ik_gen import ik_batch
from jrlqp_tpu_torch.utils import spans

torch.set_num_threads(1)

KINDS = ["tri", "arrow_down", "arrow_up"]


def _chain(nb, s, seed, batch=3):
    d = ik_batch(batch, nb=nb, s=s, mc=2, seed=seed)
    return d["diag"], d["off"]


def _jax_factor(kind, diag, off):
    """Per-problem JAX factor, stacked: (L_diag, L_off)."""
    outs = []
    for D, O in zip(diag, off):
        if kind == "tri":
            outs.append(jblocks.tri_block_diag_llt(jnp.asarray(D),
                                                   jnp.asarray(O)))
        else:
            outs.append(jblocks.block_arrow_llt(jnp.asarray(D),
                                                jnp.asarray(O),
                                                up=kind == "arrow_up"))
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(2)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nb,s", [(3, 8), (4, 5)])
def test_blocks_match_jax_f64(nb, s, kind):
    diag, off = _chain(nb, s, nb * 10 + s)
    up = kind == "arrow_up"
    Ld, Lo, ok = (blocks.tri_block_diag_llt(torch.from_numpy(diag),
                                            torch.from_numpy(off))
                  if kind == "tri" else
                  blocks.block_arrow_llt(torch.from_numpy(diag),
                                         torch.from_numpy(off), up=up))
    assert bool(ok.all())
    jLd, jLo = _jax_factor(kind, diag, off)
    np.testing.assert_allclose(Ld.numpy(), jLd, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Lo.numpy(), jLo, rtol=0, atol=1e-12)
    rng = np.random.default_rng(nb + s)
    B = diag.shape[0]
    for r in (rng.standard_normal((B, nb, s)),
              rng.standard_normal((B, nb, s, 4))):
        tr = torch.from_numpy(r)
        if kind == "tri":
            ours = [blocks.tri_block_l_solve(Ld, Lo, tr),
                    blocks.tri_block_lt_solve(Ld, Lo, tr)]
            ref = [[jblocks.tri_block_l_solve(jLd[b], jLo[b], r[b]),
                    jblocks.tri_block_lt_solve(jLd[b], jLo[b], r[b])]
                   for b in range(B)]
        else:
            ours = [blocks.block_arrow_l_solve(Ld, Lo, tr, up=up),
                    blocks.block_arrow_lt_solve(Ld, Lo, tr, up=up)]
            ref = [[jblocks.block_arrow_l_solve(jLd[b], jLo[b], r[b], up=up),
                    jblocks.block_arrow_lt_solve(jLd[b], jLo[b], r[b],
                                                 up=up)]
                   for b in range(B)]
        for i in range(2):
            np.testing.assert_allclose(
                ours[i].numpy(), np.stack([np.asarray(x[i]) for x in ref]),
                rtol=0, atol=1e-12)
    dense = (blocks.tri_block_to_dense(torch.from_numpy(diag),
                                       torch.from_numpy(off))
             if kind == "tri" else
             blocks.block_arrow_to_dense(torch.from_numpy(diag),
                                         torch.from_numpy(off), up=up))
    jdense = [jblocks.tri_block_to_dense(D, O) if kind == "tri" else
              jblocks.block_arrow_to_dense(D, O, up=up)
              for D, O in zip(diag, off)]
    np.testing.assert_array_equal(dense.numpy(), np.stack(jdense))


def test_blocks_flag_a_non_spd_lane():
    # jnp's Cholesky makes NaN, torch's leaves a finite partial factor:
    # ok comes from info == 0 over all blocks
    diag, off = _chain(3, 4, 3)
    diag[1, 1] -= 3 * 3 * 4 * np.eye(4)
    for kind in KINDS:
        fac = (blocks.tri_block_diag_llt if kind == "tri" else
               lambda d, o: blocks.block_arrow_llt(d, o, kind == "arrow_up"))
        _, _, ok = fac(torch.from_numpy(diag), torch.from_numpy(off))
        assert ok.tolist() == [True, False, True], kind
        jLd, _ = _jax_factor(kind, diag, off)
        assert np.isfinite(jLd).all(axis=(1, 2, 3)).tolist() == ok.tolist()


def _rel_close(ours, ref, tol=1e-5):
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["tri", "tri_lower", "arrow_down",
                                  "arrow_up"])
@pytest.mark.parametrize("nb,s", [(3, 8), (5, 16), (4, 5)])
def test_kernel_plain_matches_pallas_interpret(nb, s, kind):
    diag, off = _chain(nb, s, nb + s, batch=3)
    diag, off = diag.astype(np.float32), off.astype(np.float32)
    n = nb * s
    B = diag.shape[0]
    r = np.random.default_rng(s).standard_normal((B, nb, s, 7)).astype(
        np.float32)
    eye = np.broadcast_to(np.eye(n, dtype=np.float32).reshape(1, nb, s, n),
                          (B, nb, s, n))
    td, to = torch.from_numpy(diag), torch.from_numpy(off)
    up = kind == "arrow_up"
    if kind.startswith("tri"):
        ours = block_llt.tri_block_llt_plain(td, to)
        ref = jbl.tri_block_llt_pallas(jnp.asarray(diag), jnp.asarray(off),
                                       interpret=True)
    else:
        ours = block_llt.block_arrow_llt_plain(td, to, up=up)
        ref = jbl.block_arrow_llt_pallas(jnp.asarray(diag), jnp.asarray(off),
                                         up=up, interpret=True)
    for o, j in zip(ours, ref):
        _rel_close(o.numpy(), np.asarray(j))
    for rhs in (r, eye):
        tr = torch.from_numpy(np.ascontiguousarray(rhs))
        if kind.startswith("tri"):
            lower = kind == "tri_lower"
            y = block_llt.tri_block_solve_plain(ours[1], ours[2], tr, lower)
            jy = jbl.tri_block_solve_pallas(ref[1], ref[2], jnp.asarray(rhs),
                                            interpret=True, lower_only=lower)
        else:
            y = block_llt.block_arrow_solve_plain(ours[1], ours[2], tr, up)
            jy = jbl.block_arrow_solve_pallas(ref[1], ref[2],
                                              jnp.asarray(rhs), up=up,
                                              interpret=True)
        _rel_close(y.numpy(), np.asarray(jy))


def test_kernel_plain_solves_against_dense():
    # G^-1 r of the plain K6/K8 against the dense f64 inverse, and L^-1 r
    # of lower_only against the dense factor
    diag, off = _chain(4, 6, 11)
    for kind in KINDS:
        up = kind == "arrow_up"
        td, to = (torch.from_numpy(v.astype(np.float32)) for v in (diag, off))
        G = (blocks.tri_block_to_dense(torch.from_numpy(diag),
                                       torch.from_numpy(off))
             if kind == "tri" else
             blocks.block_arrow_to_dense(torch.from_numpy(diag),
                                         torch.from_numpy(off), up=up))
        eye = torch.eye(24).reshape(1, 4, 6, 24).expand(3, 4, 6, 24)
        if kind == "tri":
            _, Lo, Li = block_llt.tri_block_llt_plain(td, to)
            H = block_llt.tri_block_solve_plain(Lo, Li, eye)
            Linv = block_llt.tri_block_solve_plain(Lo, Li, eye,
                                                   lower_only=True)
            Lref = torch.linalg.inv(torch.linalg.cholesky(G))
            torch.testing.assert_close(Linv.reshape(3, 24, 24).double(),
                                       Lref, rtol=0, atol=1e-6)
        else:
            _, Lo, Li = block_llt.block_arrow_llt_plain(td, to, up=up)
            H = block_llt.block_arrow_solve_plain(Lo, Li, eye, up=up)
        torch.testing.assert_close(H.reshape(3, 24, 24).double(),
                                   torch.linalg.inv(G), rtol=0, atol=1e-6)


def test_kernel_wrappers_on_cpu_are_the_plain_versions():
    diag, off = _chain(3, 8, 2)
    td, to = (torch.from_numpy(v.astype(np.float32)) for v in (diag, off))
    eye = torch.eye(24).reshape(1, 3, 8, 24).expand(3, 3, 8, 24)
    fac = block_llt.tri_block_llt(td, to)
    for a, b in zip(fac, block_llt.tri_block_llt_plain(td, to)):
        assert torch.equal(a, b)
    assert torch.equal(block_llt.tri_block_solve(fac[1], fac[2], eye, True),
                       block_llt.tri_block_solve_plain(fac[1], fac[2], eye,
                                                       True))
    afac = block_llt.block_arrow_llt(td, to, up=True)
    for a, b in zip(afac, block_llt.block_arrow_llt_plain(td, to, up=True)):
        assert torch.equal(a, b)
    assert torch.equal(
        block_llt.block_arrow_solve(afac[1], afac[2], eye, up=True),
        block_llt.block_arrow_solve_plain(afac[1], afac[2], eye, up=True))
    assert (spans.counter("launch.K5"), spans.counter("launch.K6"),
            spans.counter("launch.K7"),
            spans.counter("launch.K8")) == (0, 0, 0, 0)


def test_kernel_wrappers_check_inputs():
    td = torch.eye(4).expand(2, 3, 4, 4)
    to = torch.zeros((2, 2, 4, 4))
    with pytest.raises(RuntimeError, match="no kernel"):
        block_llt.tri_block_llt(td.to("meta"), to.to("meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        block_llt.block_arrow_solve(to.to("meta"), td.to("meta"),
                                    td.to("meta"))
    with pytest.raises(TypeError):
        block_llt.block_arrow_llt(td.double(), to.double())
    with pytest.raises(ValueError):
        block_llt.tri_block_llt(td, to[:, :1])
    with pytest.raises(ValueError):
        block_llt.tri_block_solve(to, td, torch.zeros((2, 3, 5, 2)))


def test_containers_round_trip_and_match_jax():
    d = ik_batch(2, nb=3, s=4, mc=2, seed=9)
    sg, sc = structured_from_numpy(diag=d["diag"], off=d["off"],
                                   gtype=GType.BLOCK_ARROW_UP,
                                   blocks=d["blocks"], device="cpu")
    for t, k in ((sg.diag, "diag"), (sg.off, "off"), (sc.blocks, "blocks")):
        assert t.numpy().dtype == d[k].dtype
        assert t.numpy().tobytes() == d[k].tobytes(), k
    assert (sg.nb, sg.s, sg.n, sc.mc, sc.m) == (3, 4, 12, 2, 6)
    C = sc.to_dense()
    jC = [np.asarray(JStructuredC(blocks=jnp.asarray(b)).to_dense())
          for b in d["blocks"]]
    np.testing.assert_array_equal(C.numpy(), np.stack(jC))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 12)))
    torch.testing.assert_close(sc.transpose_mult(x),
                               torch.einsum("bij,bj->bi", C, x))
    fac = sg.llt()
    G = sg.to_dense()
    torch.testing.assert_close(fac.solve(x), torch.linalg.solve(G, x),
                               rtol=0, atol=1e-13)
    J0 = fac.inverse_transpose()
    torch.testing.assert_close(J0 @ J0.transpose(1, 2), torch.linalg.inv(G),
                               rtol=0, atol=1e-13)
    with pytest.raises(ValueError, match="gtype"):
        StructuredG(diag=sg.diag, off=sg.off, gtype="tri_block_diagonal")


def test_ik_generator_matches_the_jax_benchmark_fixture():
    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
            / "capture_ik_trajectory.py")
    spec = importlib.util.spec_from_file_location("capture_ik_trajectory",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sgs, a, scs, l, u = mod.make_fixture(2, seed=4)
    d = ik_batch(2, seed=4)
    for ours, ref in ((d["diag"], sgs.diag), (d["off"], sgs.off),
                      (d["blocks"], scs.blocks), (d["a"], a), (d["l"], l),
                      (d["u"], u)):
        np.testing.assert_array_equal(ours, np.asarray(ref))
