"""K2: the port's block Cholesky / triangular inverse against the Pallas
device helpers ``_chol_b`` and ``_tri_inv_b`` (plain jnp functions), on
identity-padded f32 blocks with one non-SPD block."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu.ops.pallas.block_llt import _chol_b, _tri_inv_b
from jrlqp_tpu_torch.ops.cuda import block_llt
from jrlqp_tpu_torch.utils import spans

torch.set_num_threads(1)


def _blocks(seed, P, n, s):
    """(P, s, s) f32 SPD blocks G = A A^T / n + I, identity-padded from n
    to s; block 1 is made non-SPD."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((P, n, n))
    G = A @ A.transpose(0, 2, 1) / n + np.eye(n)
    G = 0.5 * (G + G.transpose(0, 2, 1))
    out = np.tile(np.eye(s), (P, 1, 1))
    out[:, :n, :n] = G
    out[1, n - 1, :n - 1] = out[1, :n - 1, n - 1] = 0.0
    out[1, n - 1, n - 1] = -1.0
    return out.astype(np.float32)


def _jax_posdef(L):
    d = np.diagonal(L, axis1=1, axis2=2)
    return d.min(axis=1) > np.float32(1e-6) * d.max(axis=1)


@pytest.mark.parametrize("P,n,s", [(5, 6, 8), (4, 13, 16), (3, 50, 56)])
def test_plain_matches_pallas_helpers(P, n, s):
    A = _blocks(P + n, P, n, s)
    Lj = np.asarray(_chol_b(jnp.asarray(A), s))
    Lij = np.asarray(_tri_inv_b(jnp.asarray(Lj), s))
    Lt = block_llt.chol_b_plain(torch.from_numpy(A))
    Lit = block_llt.tri_inv_b_plain(Lt)
    pd = block_llt.posdef_plain(Lt).numpy()
    np.testing.assert_array_equal(pd, _jax_posdef(Lj))
    assert not pd[1] and pd[np.arange(P) != 1].all()
    spd = pd
    np.testing.assert_allclose(Lt.numpy()[spd], Lj[spd], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(Lit.numpy()[spd], Lij[spd], rtol=1e-5,
                               atol=1e-5)
    # the L^-1 of the identity padding is exact
    pad = Lit.numpy()[spd][:, n:, n:]
    np.testing.assert_array_equal(pad, np.broadcast_to(np.eye(s - n),
                                                       pad.shape))


def test_chol_inv_b_on_cpu_is_the_plain_version():
    A = torch.from_numpy(_blocks(7, 4, 9, 16))
    L, Li, pd = block_llt.chol_inv_b(A)
    Lp = block_llt.chol_b_plain(A)
    assert torch.equal(L, Lp)
    assert torch.equal(Li, block_llt.tri_inv_b_plain(Lp))
    assert torch.equal(pd, block_llt.posdef_plain(Lp))
    assert spans.counter("launch.chol_inv_b") == 0


def test_plain_clamps_instead_of_raising():
    A = torch.from_numpy(_blocks(8, 2, 5, 8))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(A)
    L = block_llt.chol_b_plain(A)
    assert not bool(block_llt.posdef_plain(L)[1])

