"""The padded layout in which K6 (``tri_block_solve`` on a CUDA batch) reads
its operands, built on the host: ``pad_cols`` for the factor's blocks,
``padded_rhs`` for the right-hand side and ``identity_rhs``, the one shared
identity that the structured path solves on. Held against the JAX
package's ``tri_block_llt_pallas`` / ``tri_block_solve_pallas`` in
interpret mode on the same numpy inputs: the padded operands, read back at
their unpadded width, solve to the Pallas kernels' result."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu.ops.pallas import block_llt as jbl
from jrlqp_tpu_torch.ops.cuda import block_llt
from jrlqp_tpu_torch.testing.ik_gen import ik_batch

torch.set_num_threads(1)


@pytest.mark.parametrize("w,width", [(5, 8), (8, 8), (43, 44)])
def test_pad_cols_zero_pads_and_keeps_a_padded_view(w, width):
    t = torch.arange(2 * 3 * 4 * w, dtype=torch.float32).reshape(2, 3, 4, w)
    p = block_llt.pad_cols(t, width)
    assert torch.equal(p, t)
    assert p.stride() == (3 * 4 * width, 4 * width, width, 1)
    base = p.as_strided((2, 3, 4, width), p.stride())
    assert bool((base[..., w:] == 0).all())
    assert block_llt.pad_cols(p, width) is p


@pytest.mark.parametrize("B,nb,s", [(3, 4, 5), (1, 9, 43), (2, 2, 8)])
def test_identity_rhs_is_one_shared_padded_buffer(B, nb, s):
    n = nb * s
    r = block_llt.identity_rhs(B, nb, s)
    assert r.shape == (B, nb, s, n)
    assert torch.equal(r.reshape(B, n, n),
                       torch.eye(n).expand(B, n, n))
    r_p, rbs = block_llt.padded_rhs(r)
    assert r_p is r and rbs == 0
    kp = (n + 3) // 4 * 4
    assert r.stride()[1:] == (s * kp, kp, 1)


@pytest.mark.parametrize("k", [4, 5, 8])
def test_padded_rhs_passes_a_padded_view_through(k):
    B, nb, s = 3, 2, 5
    kp = (k + 3) // 4 * 4
    buf = torch.randn(B, nb, s, kp)
    r = buf[..., :k]
    r_p, rbs = block_llt.padded_rhs(r)
    assert r_p is r and rbs == nb * s * kp


@pytest.mark.parametrize("kind", ["contiguous", "expanded", "transposed"])
def test_padded_rhs_copies_other_layouts(kind):
    B, nb, s, k = 3, 2, 5, 7
    g = torch.Generator().manual_seed(3)
    if kind == "contiguous":
        r = torch.randn(B, nb, s, k, generator=g)
    elif kind == "expanded":
        r = torch.randn(1, nb, s, k, generator=g).expand(B, -1, -1, -1)
    else:
        r = torch.randn(B, nb, k, s, generator=g).transpose(2, 3)
    r_p, rbs = block_llt.padded_rhs(r)
    assert r_p.shape == (B, nb, s, k) and torch.equal(r_p, r)
    assert rbs == nb * s * 8 and r_p.stride() == (nb * s * 8, s * 8, 8, 1)
    base = r_p.as_strided((B, nb, s, 8), r_p.stride())
    assert bool((base[..., k:] == 0).all())
    assert block_llt.padded_rhs(r_p) == (r_p, rbs)


def _factor(B, nb, s, seed):
    d = ik_batch(B, nb=nb, s=s, mc=2, seed=seed)
    return d["diag"].astype(np.float32), d["off"].astype(np.float32)


@pytest.mark.parametrize("lower_only", [False, True])
@pytest.mark.parametrize("kind", ["identity", "dense", "tail"])
@pytest.mark.parametrize("nb,s", [(4, 5), (3, 10)])
def test_solve_on_padded_operands_matches_pallas_interpret(nb, s, kind,
                                                          lower_only):
    # the factor's blocks padded by pad_cols and the rhs laid out by
    # padded_rhs (identity_rhs for the identity), read back at their
    # unpadded width: the plain solve on them equals the Pallas kernels'
    B = 3
    n = nb * s
    diag, off = _factor(B, nb, s, seed=nb + s)
    if kind == "identity":
        r_np = np.broadcast_to(np.eye(n, dtype=np.float32).reshape(
            1, nb, s, n), (B, nb, s, n)).copy()
        r = block_llt.identity_rhs(B, nb, s)
    else:
        r_np = np.random.default_rng(s).standard_normal(
            (B, nb, s, n)).astype(np.float32)
        if kind == "tail":
            r_np[:, :-1] = 0.0   # nonzero in the last block row alone
        r = torch.from_numpy(r_np)
    _, Lo, Li = block_llt.tri_block_llt(torch.from_numpy(diag),
                                        torch.from_numpy(off))
    sp = (s + 3) // 4 * 4
    Lo_p, Li_p = block_llt.pad_cols(Lo, sp), block_llt.pad_cols(Li, sp)
    assert Li_p.stride()[2] == sp and Lo_p.stride()[2] == sp
    r_p, _ = block_llt.padded_rhs(r)
    y = block_llt.tri_block_solve(Lo_p, Li_p, r_p, lower_only)
    _, jLo, jLi = jbl.tri_block_llt_pallas(jnp.asarray(diag),
                                           jnp.asarray(off), interpret=True)
    jy = jbl.tri_block_solve_pallas(jLo, jLi, jnp.asarray(r_np),
                                    interpret=True, lower_only=lower_only)
    assert y.shape == (B, nb, s, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
