"""The structured J/R solve (``jrlqp_tpu_torch.structured.solve_structured``)
against the JAX package's, vmapped, on tri-block-diagonal and both arrow
layouts, with a StructuredC (block-sparse hooks) and with a dense C, at
nb = 3, s = 4 (f64): status, iterations and active set equal per lane, x
within 1e-10; and an equality with box bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.structured import GType as JGType
from jrlqp_tpu.structured import StructuredC as JSC
from jrlqp_tpu.structured import StructuredG as JSG
from jrlqp_tpu.structured import solve_structured as j_solve_structured
from jrlqp_tpu_torch import SolverOptions, solve_batch
from jrlqp_tpu_torch.structured import (
    GType,
    solve_structured,
    structured_from_numpy,
    structured_qp_problem,
)
from test_torch_dense import assert_results_match

torch.set_num_threads(1)

NB, S, MC, B = 3, 4, 2, 3


def _rand(seed, gtype, bounds=False):
    """numpy batch after tests/test_structured_solver.py's generator."""
    rng = np.random.default_rng(seed)
    n, m = NB * S, NB * MC
    diag = np.zeros((B, NB, S, S))
    for b in range(B):
        for i in range(NB):
            A = rng.standard_normal((S, S))
            diag[b, i] = A @ A.T + NB * S * np.eye(S)
    off = rng.standard_normal((B, NB - 1, S, S))
    blocks = rng.standard_normal((B, NB, MC, S))
    C = np.zeros((B, m, n))
    for i in range(NB):
        C[:, i * MC:(i + 1) * MC, i * S:(i + 1) * S] = blocks[:, i]
    x0 = rng.uniform(-1, 1, (B, n))
    cx = np.einsum("bij,bj->bi", C, x0)
    d = dict(diag=diag, off=off, blocks=blocks, C=C,
             a=rng.standard_normal((B, n)),
             l=cx - rng.uniform(0.0, 0.5, (B, m)),
             u=cx + rng.uniform(0.0, 2.0, (B, m)),
             xl=np.full((B, n), -np.inf), xu=np.full((B, n), np.inf))
    if bounds:
        d["l"][:, 0] = d["u"][:, 0]                  # an equality
        d["xl"][:] = -2.0
        d["xu"][:] = 2.0
    return d


def _port(d, gtype, structured_c):
    sg, sc = structured_from_numpy(diag=d["diag"], off=d["off"], gtype=gtype,
                                   blocks=d["blocks"], device="cpu")
    t = {k: torch.from_numpy(d[k]) for k in ("a", "l", "u", "xl", "xu", "C")}
    return (sg, t["a"], sc if structured_c else t["C"], t["l"], t["u"],
            t["xl"], t["xu"])


def _jax(d, gtype, structured_c):
    sg = JSG(diag=jnp.asarray(d["diag"]), off=jnp.asarray(d["off"]),
             gtype=int(gtype))
    sc = JSC(blocks=jnp.asarray(d["blocks"])) if structured_c \
        else jnp.asarray(d["C"])

    def one(sg, sc, a, l, u, xl, xu):
        return j_solve_structured(sg, a, sc, l, u, xl, xu, opt=JOptions())

    return jax.jit(jax.vmap(one))(sg, sc, *(jnp.asarray(d[k]) for k in
                                            ("a", "l", "u", "xl", "xu")))


@pytest.mark.parametrize("structured_c", [True, False], ids=["sc", "dense_c"])
@pytest.mark.parametrize("gtype", list(GType), ids=lambda g: g.name)
def test_solve_structured_matches_jax(gtype, structured_c):
    assert int(JGType(int(gtype))) == int(gtype)
    d = _rand(int(gtype) + 1, gtype)
    args = _port(d, gtype, structured_c)
    res = solve_structured(*args, opt=SolverOptions())
    ref = _jax(d, gtype, structured_c)
    assert_results_match(res, ref, x_tol=1e-10, mult_tol=1e-9)
    assert bool((res.status == 0).all())
    # and the dense engine on the materialized problem
    dense = solve_batch(structured_qp_problem(*args))
    assert torch.equal(dense.active_set, res.active_set)
    torch.testing.assert_close(dense.x, res.x, rtol=0, atol=1e-8)


def test_solve_structured_with_equalities_and_bounds():
    d = _rand(42, GType.TRI_BLOCK_DIAGONAL, bounds=True)
    res = solve_structured(*_port(d, GType.TRI_BLOCK_DIAGONAL, True),
                           opt=SolverOptions())
    ref = _jax(d, GType.TRI_BLOCK_DIAGONAL, True)
    assert_results_match(res, ref, x_tol=1e-10, mult_tol=1e-9)
    assert bool((res.active_set[:, 0] == 3).all())     # EQUALITY
