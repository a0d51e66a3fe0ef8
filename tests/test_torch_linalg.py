"""The J/R engine's masked primitives (``jrlqp_tpu_torch.ops.linalg``)
against the JAX package's, vmapped, on numpy inputs shared by both: every q
from 0 to n and the removal position l at both ends. f64, tolerance 1e-12
(the same arithmetic in another summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu.ops import linalg as jl
from jrlqp_tpu_torch.ops import linalg as tl

torch.set_num_threads(1)

N = 6
QS = [0, 3, N - 1, N]


def _jr(seed, q):
    """A J (orthogonal-ish) and an identity-padded upper-triangular R of q
    active columns per lane, and a vector d, for a batch of 3."""
    rng = np.random.default_rng(seed)
    B = 3
    J = rng.standard_normal((B, N, N))
    R = np.triu(rng.standard_normal((B, N, N))) + 3 * np.eye(N)
    R[:, :, q:] = np.eye(N)[:, q:]
    d = rng.standard_normal((B, N))
    return J, R, d


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("q", QS)
def test_tri_solve_masked(q):
    J, R, d = _jr(1, q)
    qs = np.full(3, q, np.int32)
    ref = jax.vmap(jl.tri_solve_masked)(jnp.asarray(R), jnp.asarray(d),
                                        jnp.asarray(qs))
    ours = tl.tri_solve_masked(_t(R), _t(d), _t(qs))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("q", QS)
def test_householder_add(q):
    J, R, d = _jr(2, q)
    d[1, q:] = 0.0                     # lane 1: a dependent (zero) tail
    qs = np.array([q, q, max(q - 1, 0)], np.int32)
    Jr, Rr, depr = jax.vmap(jl.householder_add)(
        jnp.asarray(J), jnp.asarray(R), jnp.asarray(d), jnp.asarray(qs))
    Jo, Ro, depo = tl.householder_add(_t(J), _t(R), _t(d), _t(qs))
    np.testing.assert_allclose(Jo.numpy(), np.asarray(Jr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Ro.numpy(), np.asarray(Rr), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(depo.numpy(), np.asarray(depr))


@pytest.mark.parametrize("q", [1, 3, N])
def test_shift_left(q):
    v = np.arange(3 * (N + 1), dtype=np.float64).reshape(3, N + 1)
    ls = np.array([0, q // 2, q - 1], np.int32)
    qs = np.full(3, q, np.int32)
    ref = jax.vmap(jl.shift_left)(jnp.asarray(v), jnp.asarray(ls),
                                  jnp.asarray(qs))
    ours = tl.shift_left(_t(v), _t(ls), _t(qs))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("q", [1, 3, N - 1, N])
def test_givens_remove(q):
    J, R, _ = _jr(3, q)
    # l at both ends and in the middle, one lane each
    ls = np.array([0, q // 2, q - 1], np.int32)
    qs = np.full(3, q, np.int32)
    Jr, Rr = jax.vmap(jl.givens_remove)(jnp.asarray(J), jnp.asarray(R),
                                        jnp.asarray(qs), jnp.asarray(ls))
    Jo, Ro = tl.givens_remove(_t(J), _t(R), _t(qs), _t(ls))
    np.testing.assert_allclose(Jo.numpy(), np.asarray(Jr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Ro.numpy(), np.asarray(Rr), rtol=0, atol=1e-12)


def test_givens_remove_lanes_with_different_q():
    J, R, _ = _jr(4, N)
    qs = np.array([2, 5, N], np.int32)
    ls = np.array([1, 0, 3], np.int32)
    Jr, Rr = jax.vmap(jl.givens_remove)(jnp.asarray(J), jnp.asarray(R),
                                        jnp.asarray(qs), jnp.asarray(ls))
    Jo, Ro = tl.givens_remove(_t(J), _t(R), _t(qs), _t(ls))
    np.testing.assert_allclose(Jo.numpy(), np.asarray(Jr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Ro.numpy(), np.asarray(Rr), rtol=0, atol=1e-12)
