"""The port's MultiIK fixture reader (jrlqp_tpu_torch.io.ikmat) against the
JAX package's (jrlqp_tpu.io.ikmat) on the same text: equal arrays bit for
bit (tolerance 0), round trips through write_ik_pb, qp_arrays, and
open_multi_ik on a zip written here. The real archive (MultiIK.zip, shipped
with the reference's test suite) is read only where MULTI_IK_ZIP names it,
as tests/test_ikmat.py does."""
import io
import os
import zipfile

import numpy as np
import pytest
import torch

from jrlqp_tpu.io import ikmat as jik
from jrlqp_tpu_torch import SolverOptions, problem_from_numpy
from jrlqp_tpu_torch.io import ikmat as tik
from jrlqp_tpu_torch.solver.fast import solve_refined
from jrlqp_tpu_torch.testing.kkt import kkt_residual

torch.set_num_threads(1)

MULTI_IK = os.environ.get("MULTI_IK_ZIP", "")
needs_fixture = pytest.mark.skipif(
    not os.path.exists(MULTI_IK), reason="MultiIK.zip not available "
    "(set MULTI_IK_ZIP)")

PB_FIELDS = ("Q", "c", "A", "b", "C", "d", "x_min", "x_max")


def _bitwise(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _random_pb(mod, rng, n, me, mi):
    A0 = rng.standard_normal((n, n))
    return mod.IKProblem(
        Q=A0 @ A0.T + n * np.eye(n), c=rng.standard_normal(n),
        A=rng.standard_normal((me, n)) if me else np.zeros((0, n)),
        b=rng.standard_normal(me) if me else np.zeros((0,)),
        C=rng.standard_normal((mi, n)) if mi else np.zeros((0, n)),
        d=rng.standard_normal(mi) if mi else np.zeros((0,)),
        x_min=-np.abs(rng.standard_normal(n)) - 1.0,
        x_max=np.abs(rng.standard_normal(n)) + 1.0)


@pytest.mark.parametrize("dims", [(7, 2, 4), (4, 0, 2), (3, 2, 0), (2, 0, 0)])
def test_ik_pb_round_trip_matches_jax(tmp_path, dims):
    rng = np.random.default_rng(sum(dims))
    pb = _random_pb(tik, rng, *dims)
    ours, theirs = tmp_path / "ours.txt", tmp_path / "jax.txt"
    tik.write_ik_pb(ours, pb)
    jik.write_ik_pb(theirs, jik.IKProblem(**{f: getattr(pb, f)
                                             for f in PB_FIELDS}))
    assert ours.read_text() == theirs.read_text()
    back = tik.read_ik_pb(str(ours))
    ref = jik.read_ik_pb(str(ours))
    assert back.n == ref.n == dims[0]
    for f in PB_FIELDS:
        _bitwise(getattr(back, f), getattr(pb, f), f)
        _bitwise(getattr(back, f), getattr(ref, f), f)


def test_read_ik_pb_errors_like_jax():
    for bad in ("garbage\n", "==== dim_var ====\n3\n==== Q ====\n"):
        with pytest.raises(ValueError):
            tik.read_ik_pb(io.StringIO(bad))
        with pytest.raises(ValueError):
            jik.read_ik_pb(io.StringIO(bad))


def test_read_mat_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    M = rng.standard_normal((7, 4))
    p = tmp_path / "m.txt"
    p.write_text("\n".join(" ".join(f"{v:.17g}" for v in row) for row in M)
                 + "\n\n")
    _bitwise(tik.read_mat(str(p)), M)
    _bitwise(tik.read_mat(str(p)), jik.read_mat(str(p)))
    col = "1.5\n-2.25\n3e-7\n"           # a single column: shape (rows, 1)
    _bitwise(tik.read_mat(io.StringIO(col)), [[1.5], [-2.25], [3e-7]])
    _bitwise(tik.read_mat(io.StringIO(col)), jik.read_mat(io.StringIO(col)))
    _bitwise(tik.read_mat(io.StringIO("\n")), jik.read_mat(io.StringIO("\n")))


@pytest.mark.parametrize("dims", [(5, 2, 3), (4, 0, 2), (3, 2, 0)])
def test_qp_arrays_match_jax(dims):
    pb = _random_pb(tik, np.random.default_rng(7), *dims)
    ours = pb.qp_arrays()
    ref = jik.IKProblem(**{f: getattr(pb, f) for f in PB_FIELDS}).qp_arrays()
    assert ours.keys() == ref.keys()
    for k in ref:
        _bitwise(ours[k], ref[k], k)
    n, me, mi = dims
    assert ours["C"].shape == (me + mi, n)
    assert np.all(ours["l"][me:] == -np.inf)
    _bitwise(ours["l"][:me], ours["u"][:me])


def test_open_multi_ik_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    pb = _random_pb(tik, rng, 6, 1, 3)
    pb_path = tmp_path / "arrowAllData.txt"
    tik.write_ik_pb(pb_path, pb)
    G = rng.standard_normal((6, 6))
    z = tmp_path / "MultiIK.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.write(pb_path, "MultiIK/arrowAllData.txt")
        zf.writestr("MultiIK/triBlockDiag_G.txt", "\n".join(
            " ".join(f"{v:.17g}" for v in row) for row in G) + "\n")
        zf.writestr("MultiIK/triBlockDiag_u.txt", "0.5\n-1\n")
        zf.writestr("MultiIK/README.md", "not a fixture\n")
    ours, ref = tik.open_multi_ik(str(z)), jik.open_multi_ik(str(z))
    assert sorted(ours) == sorted(ref) == ["arrowAllData", "triBlockDiag_G",
                                           "triBlockDiag_u"]
    for f in PB_FIELDS:
        _bitwise(getattr(ours["arrowAllData"], f), getattr(pb, f), f)
        _bitwise(getattr(ours["arrowAllData"], f),
                 getattr(ref["arrowAllData"], f), f)
    _bitwise(ours["triBlockDiag_G"], G)
    for k in ("triBlockDiag_G", "triBlockDiag_u"):
        _bitwise(ours[k], ref[k], k)
    assert tik.open_multi_ik(str(tmp_path / "missing.zip")) is None


def _qp(arrs, big=1e100):
    def fin(v, s):
        return np.where(np.isinf(v), s * big, v)[None]

    return problem_from_numpy(
        G=arrs["G"][None], a=arrs["a"][None], C=arrs["C"][None],
        l=fin(arrs["l"], -1), u=fin(arrs["u"], 1), xl=fin(arrs["xl"], -1),
        xu=fin(arrs["xu"], 1), device="cpu")


@needs_fixture
def test_sequential_ik_fixture():
    """The 9-robot 43-dof sequential IK fixture read alike by both packages
    and solved by the port's dense engine to the stored solution (1e-4, the
    files' own precision) at KKT <= 1e-8."""
    d, ref = tik.open_multi_ik(MULTI_IK), jik.open_multi_ik(MULTI_IK)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            _bitwise(d[k], ref[k], k)
    G, C = d["triBlockDiag_G"], d["triBlockDiag_C"]
    n, m = G.shape[0], C.shape[0]
    assert (n, m) == (387, 1621)
    pb = problem_from_numpy(
        G=G[None], a=d["triBlockDiag_a"].ravel()[None], C=C[None],
        l=np.full((1, m), -1e100), u=d["triBlockDiag_u"].ravel()[None],
        xl=np.full((1, n), -1e100), xu=np.full((1, n), 1e100), device="cpu")
    res = solve_refined(pb, SolverOptions(max_iter=500))
    assert int(res.status[0]) == 0
    x_ref = d["triBlockDiag_sol"].ravel()
    assert float(np.max(np.abs(res.x[0].numpy() - x_ref))) <= 1e-4
    assert float(kkt_residual(res.x, res.multipliers, pb)[0]) <= 1e-8


@needs_fixture
def test_simultaneous_ik_fixture():
    """The 5-robot 42-dof simultaneous IK problem file read alike by both
    packages and solved by the port's dense engine at KKT <= 1e-8."""
    ik = tik.open_multi_ik(MULTI_IK)["arrowAllData"]
    ref = jik.open_multi_ik(MULTI_IK)["arrowAllData"]
    for f in PB_FIELDS:
        _bitwise(getattr(ik, f), getattr(ref, f), f)
    assert ik.n == 210 and ik.C.shape == (25, 210)
    pb = _qp(ik.qp_arrays())
    res = solve_refined(pb, SolverOptions(max_iter=400))
    assert int(res.status[0]) == 0
    assert float(kkt_residual(res.x, res.multipliers, pb)[0]) <= 1e-8
