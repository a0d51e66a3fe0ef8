"""The port's KKT oracle against ``jax.vmap`` of the JAX package's, on the
same (x, u, problem) arrays in float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu.problems import QPProblem as JQP
from jrlqp_tpu.testing import kkt as jkkt
from jrlqp_tpu_torch import problem_from_numpy
from jrlqp_tpu_torch.testing import kkt as tkkt

torch.set_num_threads(1)


def _case(seed, B, n, m, bounded):
    """Problem and a candidate (x, u) near a vertex: some multipliers zero,
    some constraints tight, some bounds infinite."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    G = A @ A.transpose(0, 2, 1) / n + np.eye(n)
    C = rng.standard_normal((B, m, n))
    x = rng.uniform(-1, 1, (B, n))
    cx = np.einsum("bij,bj->bi", C, x)
    l = cx - rng.uniform(0, 1, (B, m)) * (rng.random((B, m)) < 0.6)
    u = cx + rng.uniform(0.1, 1, (B, m))
    u[:, ::3] = np.inf
    if bounded:
        xl, xu = x - rng.uniform(0, 1, (B, n)), x + 1.0
    else:
        xl, xu = np.full((B, n), -np.inf), np.full((B, n), np.inf)
    mult = rng.standard_normal((B, m + n)) * (rng.random((B, m + n)) < 0.3)
    x = x + 1e-7 * rng.standard_normal((B, n))
    arrs = dict(G=G, a=rng.standard_normal((B, n)), C=C, l=l, u=u, xl=xl,
                xu=xu)
    return arrs, x, mult


def _jax_problem(arrs):
    B = arrs["G"].shape[0]
    return JQP(**{k: jnp.asarray(v) for k, v in arrs.items()},
               objcst=jnp.zeros((B,)))


@pytest.mark.parametrize("seed,B,n,m,bounded", [
    (0, 16, 6, 9, False), (1, 16, 10, 4, True), (2, 8, 50, 100, False)])
def test_kkt_residual_matches_jax(seed, B, n, m, bounded):
    arrs, x, mult = _case(seed, B, n, m, bounded)
    ref = np.asarray(jax.vmap(jkkt.kkt_residual)(
        jnp.asarray(x), jnp.asarray(mult), _jax_problem(arrs)))
    pb = problem_from_numpy(**arrs, device="cpu")
    ours = tkkt.kkt_residual(torch.from_numpy(x), torch.from_numpy(mult),
                             pb).numpy()
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-14)


@pytest.mark.parametrize("fn", ["check_kkt", "check_kkt_stationarity",
                                "check_kkt_feasibility"])
def test_check_kkt_matches_jax(fn):
    arrs, x, mult = _case(4, 32, 8, 12, True)
    # half the lanes exactly optimal in stationarity: a = -(G x + C^T u_c + u_b)
    m = arrs["C"].shape[1]
    grad = (np.einsum("bij,bj->bi", arrs["G"], x)
            + np.einsum("bji,bj->bi", arrs["C"], mult[:, :m]) + mult[:, m:])
    arrs["a"][::2] = -grad[::2]
    ref = np.asarray(jax.vmap(getattr(jkkt, fn))(
        jnp.asarray(x), jnp.asarray(mult), _jax_problem(arrs)))
    ours = getattr(tkkt, fn)(torch.from_numpy(x), torch.from_numpy(mult),
                             problem_from_numpy(**arrs, device="cpu")).numpy()
    np.testing.assert_array_equal(ours, ref)
