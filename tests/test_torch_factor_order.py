"""The order-exact references of K5 and K7
(``jrlqp_tpu_torch.testing.order_exact``), which the card tests hold the
kernels to bit for bit, against the JAX package's Pallas kernels in
interpret mode and the port's plain versions (1e-5 relative to the largest
entry: the Pallas kernels pad s to 8 and every version sums in its own
order); and the property that K5's and K7's half products rest on: the
lower half of an order-exact symmetric product, mirrored, is the full
product bit for bit. Inputs are made with numpy and shared by both
packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from jrlqp_tpu.ops.pallas import block_llt as jbl
from jrlqp_tpu_torch.ops.cuda import block_llt
from jrlqp_tpu_torch.testing import order_exact
from jrlqp_tpu_torch.testing.ik_gen import ik_batch

torch.set_num_threads(1)

# (nb, s): every nb of {2, 3, 9, 17} and every s of {5, 8, 13}
SHAPES = [(2, 13), (3, 8), (9, 5), (17, 8), (9, 13), (3, 5)]


def _chain(nb, s, seed, batch=3):
    """f32 (diag, off) of an IK batch; problem 1's first diagonal block is
    not bitwise symmetric."""
    d = ik_batch(batch, nb=nb, s=s, mc=2, seed=seed)
    diag, off = d["diag"].astype(np.float32), d["off"].astype(np.float32)
    rng = np.random.default_rng(seed)
    diag[1, 0] += 0.01 * rng.standard_normal((s, s)).astype(np.float32)
    return diag, off


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(1.0, np.abs(ref).max()))


def _check(name, ours, refs):
    for tag, ref in refs.items():
        for what, o, r in zip(("L_diag", "L_off", "Linv_diag"), ours, ref):
            r = np.asarray(r)
            assert o.shape == r.shape, (name, tag, what)
            assert _rel_err(o.numpy(), r) <= 1e-5, (name, tag, what)


@pytest.mark.parametrize("nb,s", SHAPES)
def test_k5_order_exact_matches_pallas_and_plain(nb, s):
    diag, off = _chain(nb, s, 7 * nb + s)
    td, to = torch.from_numpy(diag), torch.from_numpy(off)
    ours = order_exact.k5_order_exact(td, to)
    _check("K5", ours, {
        "pallas": jbl.tri_block_llt_pallas(jnp.asarray(diag),
                                           jnp.asarray(off), interpret=True),
        "plain": block_llt.tri_block_llt_plain(td, to)})


@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("nb,s", SHAPES)
def test_k7_order_exact_matches_pallas_and_plain(nb, s, up):
    diag, off = _chain(nb, s, 5 * nb + s)
    td, to = torch.from_numpy(diag), torch.from_numpy(off)
    ours = order_exact.k7_order_exact(td, to, up=up)
    _check("K7", ours, {
        "pallas": jbl.block_arrow_llt_pallas(jnp.asarray(diag),
                                             jnp.asarray(off), up=up,
                                             interpret=True),
        "plain": block_llt.block_arrow_llt_plain(td, to, up=up)})


def test_order_exact_factor_parts():
    # the references' pieces: S'_i is the triangular chain (no term of
    # L_i^-1's zero half), the Schur term of K7 sums the heads in order
    diag, off = _chain(4, 6, 3)
    td, to = torch.from_numpy(diag), torch.from_numpy(off)
    Ld, Lo, Li = order_exact.k5_order_exact(td, to)
    L0, X0 = order_exact.k2_order_exact(td[:, 0])
    assert torch.equal(Ld[:, 0], L0) and torch.equal(Li[:, 0], X0)
    assert torch.equal(Lo[:, 0], order_exact.chain_nt(to[:, 0], X0, True))
    a1 = td[:, 1] - order_exact.chain_nt(Lo[:, 0], Lo[:, 0])
    assert torch.equal(Ld[:, 1], order_exact.k2_order_exact(a1)[0])
    _, Bs, _ = order_exact.k7_order_exact(td, to)
    acc = torch.zeros(3, 6, 6)
    for i in range(3):
        acc = acc + order_exact.chain_nt(Bs[:, i], Bs[:, i])
    Ld7, _, _ = order_exact.k7_order_exact(td, to)
    assert torch.equal(Ld7[:, -1], order_exact.k2_order_exact(
        td[:, -1] - acc)[0])


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), s=st.integers(1, 24),
       scale=st.sampled_from([1e-20, 1.0, 1e18]))
def test_symmetric_chain_lower_half_mirrored_is_the_product(seed, s, scale):
    # the design of K5's S'S'^T and K7's B B^T: only the outputs on and
    # below the diagonal are computed, the rest read mirrored
    rng = np.random.default_rng(seed)
    P = (scale * rng.standard_normal((2, s, s))).astype(np.float32)
    P[:, :, rng.integers(0, s)] = 0.0        # a zero column: signed zeros
    M = order_exact.chain_nt(torch.from_numpy(P), torch.from_numpy(P))
    low = torch.tril(M)
    mirrored = low + torch.tril(M, -1).mT
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
    assert torch.equal(bits(mirrored), bits(M))
    assert torch.equal(bits(M), bits(M.mT))
