"""The port's problem helpers, seeded generators and host validation against
the JAX package: ``pad_problem`` and ``stack_problems`` bit for bit;
``LeastSquareProblem.to_qp`` bit for bit but for its three products (1e-14
relative); ``rand_ortho``, ``randn_rank``, ``rand_dependent`` and
``random_problem`` bit for bit from the same numpy Generator;
``well_formed`` with the same (ok, findings) on the cases of
tests/test_validation.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import LeastSquareProblem as JLS
from jrlqp_tpu import QPProblem as JQP
from jrlqp_tpu import pad_problem as j_pad
from jrlqp_tpu import stack_problems as j_stack
from jrlqp_tpu import well_formed as j_well_formed
from jrlqp_tpu import testing as jtesting
from jrlqp_tpu_torch import (
    LeastSquareProblem,
    QPProblem,
    pad_problem,
    problem_from_numpy,
    result_to_numpy,
    stack_problems,
    well_formed,
)
from jrlqp_tpu_torch import testing as ttesting
from test_torch_card import np_qp_batch

torch.set_num_threads(1)

FIELDS = ("G", "a", "C", "l", "u", "xl", "xu", "objcst")


def _bitwise(ours: dict, ref: dict, keys=FIELDS):
    for k in keys:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), f"{k} differs (bitwise)"


def _one(d, b):
    """Lane ``b`` of the numpy batch ``d`` as a JAX problem."""
    return JQP(**{k: jnp.asarray(d[k][b]) for k in FIELDS})


def _batch(seed, B, n, m):
    d = np_qp_batch(seed, B, n, m, 0.4)
    d["xl"][:, 0], d["xu"][:, 0] = -1.5, 2.5
    d["objcst"] = np.random.default_rng(seed).standard_normal(B)
    return d


@pytest.mark.parametrize("n_pad,m_pad", [(5, 7), (8, 7), (5, 12), (9, 16)])
def test_pad_problem_bitwise(n_pad, m_pad):
    d = _batch(0, 3, 5, 7)
    ours = pad_problem(problem_from_numpy(**d, device="cpu"), n_pad, m_pad)
    assert (ours.n, ours.m) == (n_pad, m_pad)
    for b in range(3):
        ref = j_pad(_one(d, b), n_pad, m_pad)
        _bitwise({k: v[b] for k, v in result_to_numpy(ours).items()},
                 {k: getattr(ref, k) for k in FIELDS})


def test_stack_problems_bitwise():
    shapes = [(4, 6), (7, 3), (5, 9)]
    ds = [_batch(s, 1, n, m) for s, (n, m) in enumerate(shapes)]
    for pads in ((None, None), (8, 12)):
        ours = stack_problems([problem_from_numpy(**d, device="cpu")
                               for d in ds], *pads)
        ref = j_stack([_one(d, 0) for d in ds], *pads)
        _bitwise(result_to_numpy(ours), {k: getattr(ref, k) for k in FIELDS})
    # batches of more than one lane concatenate in order
    two = stack_problems([problem_from_numpy(**_batch(3, 2, 4, 5),
                                             device="cpu"),
                          problem_from_numpy(**ds[0], device="cpu")])
    assert two.batch == 3 and (two.n, two.m) == (4, 6)


def test_least_square_to_qp_bitwise():
    rng = np.random.default_rng(5)
    B, nobj, n, neq, m = 3, 4, 6, 2, 5
    arrs = dict(A=rng.standard_normal((B, nobj, n)),
                b=rng.standard_normal((B, nobj)),
                E=rng.standard_normal((B, neq, n)),
                f=rng.standard_normal((B, neq)),
                C=rng.standard_normal((B, m, n)), l=-np.ones((B, m)),
                u=np.ones((B, m)), xl=np.full((B, n), -np.inf),
                xu=rng.uniform(1, 2, (B, n)))
    ours = result_to_numpy(LeastSquareProblem(
        **{k: torch.from_numpy(v) for k, v in arrs.items()}).to_qp())
    for b in range(B):
        ref = JLS(**{k: jnp.asarray(v[b]) for k, v in arrs.items()}).to_qp()
        lane = {k: v[b] for k, v in ours.items()}
        # the stacked rows and copied bounds bit for bit; the products
        # A^T A, A^T b and b^T b within 1e-14 relative: XLA's dot sums in
        # an order no torch reduction reproduces
        _bitwise(lane, {k: getattr(ref, k) for k in FIELDS},
                 keys=("C", "l", "u", "xl", "xu"))
        for k in ("G", "a", "objcst"):
            np.testing.assert_allclose(lane[k], np.asarray(getattr(ref, k)),
                                       rtol=1e-14, atol=0,
                                       err_msg=f"{k}: rtol 1e-14")


@pytest.mark.parametrize("special", [False, True])
def test_rand_ortho_bitwise(special):
    for size in (0, 1, 4, 9):
        a = ttesting.rand_ortho(np.random.default_rng(size), size, special)
        b = jtesting.rand_ortho(np.random.default_rng(size), size, special)
        assert a.tobytes() == b.tobytes() and a.shape == b.shape


@pytest.mark.parametrize("rows,cols,rank", [(5, 8, -1), (5, 8, 3), (9, 4, 2),
                                            (6, 6, 0)])
def test_randn_rank_bitwise(rows, cols, rank):
    a = ttesting.randn_rank(np.random.default_rng(1), rows, cols, rank)
    b = jtesting.randn_rank(np.random.default_rng(1), rows, cols, rank)
    assert a.tobytes() == b.tobytes()
    assert np.linalg.matrix_rank(a) == (min(rows, cols) if rank < 0 else rank)


def test_rand_dependent_bitwise():
    for args in ((8, 3, 3, 4, 2, 5), (10, 4, 2, 4, 4, 6), (6, 2, 2, 3, 3, 4)):
        a = ttesting.rand_dependent(np.random.default_rng(2), *args)
        b = jtesting.rand_dependent(np.random.default_rng(2), *args)
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()


def _characteristics(mod):
    P = mod.ProblemCharacteristics
    return [
        P(5, 5),
        P(5, 5).nEq(2),
        P(6, 4, 1, 8).nStrongActIneq(3).nWeakActIneq(2),
        P(6, 6, 2, 7).nStrongActIneq(2).doubleSidedIneq(),
        P(7, 7, 1, 6).nStrongActIneq(2).set_bounds().nStrongActBounds(2)
        .nWeakActBounds(1),
        P(5, 3, 1, 9).nStrongActIneq(3).nWeakActIneq(3).strictlyFeasible(),
        P(4, 0, 1, 3).nStrongActIneq(2),
    ]


@pytest.mark.parametrize("which", range(7))
def test_random_problem_bitwise(which):
    ours = ttesting.random_problem(_characteristics(ttesting)[which],
                                   np.random.default_rng(which))
    ref = jtesting.random_problem(_characteristics(jtesting)[which],
                                  np.random.default_rng(which))
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.tobytes() == b.tobytes() and a.shape == b.shape, f.name
        else:
            assert a == b, f.name
    qa, qb = ours.to_qp_arrays(), ref.to_qp_arrays()
    _bitwise(qa, qb)


def _good(seed=0, n=4, m=6):
    d = np_qp_batch(seed, 1, n, m, 0.3)
    d["objcst"] = np.zeros(1)
    return d


def _cases():
    """name -> edit of a numpy batch of one (the cases of
    tests/test_validation.py:27-60)."""
    def edit(**kw):
        return lambda d: {**d, **{k: f(d) for k, f in kw.items()}}

    def at(key, idx, val, add=False):
        def f(d):
            v = d[key].copy()
            v[(0,) + idx] = v[(0,) + idx] + val if add else val
            return v
        return f

    return {
        "good": edit(),
        "short_a": edit(a=lambda d: d["a"][:, :-1]),
        "non_square_G": edit(G=lambda d: d["G"][:, :, :-1]),
        "inverted_l_u": edit(l=lambda d: d["u"] + 1.0, u=lambda d: d["l"]),
        "inverted_xl_xu": edit(xl=at("xl", (1,), 3.0), xu=at("xu", (1,), -3.0)),
        "nan_G": edit(G=at("G", (0, 0), np.nan)),
        "asymmetric_G": edit(G=at("G", (0, 1), 1.0, add=True)),
        "nan_bound": edit(u=at("u", (2,), np.nan)),
        "inf_C": edit(C=at("C", (1, 1), np.inf)),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_well_formed_matches_jax(case):
    d = _cases()[case](_good())
    # a lane of a port problem (built field by field: the malformed shapes
    # do not pass problem_from_numpy's checks) and the JAX problem
    pb = QPProblem(**{k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in d.items()})
    ours = well_formed(pb)
    ref = j_well_formed(_one(d, 0))
    assert ours == ref
    assert ours[0] == (case == "good")
    # plain unbatched arrays give the same findings
    plain = type("Plain", (), {k: v[0] for k, v in d.items()})
    assert well_formed(plain) == ref


def test_well_formed_reads_the_named_lane():
    d = _good()
    two = {k: np.concatenate([v, v]) for k, v in d.items()}
    two["l"][1, 0] = two["u"][1, 0] + 1.0          # lane 1: l > u
    pb = problem_from_numpy(**two, device="cpu")
    assert well_formed(pb) == (True, [])
    ok, findings = well_formed(pb, lane=1)
    assert not ok and findings[0].startswith("l/u inverted at index 0")
