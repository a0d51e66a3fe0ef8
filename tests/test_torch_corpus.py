"""The port's QPS reader/writer and Maros-Meszaros corpus runner
(``jrlqp_tpu_torch.io``) against the JAX package, mirroring
tests/test_qps.py and tests/test_corpus.py: ``parse_qps`` bit for bit on
the 16 vendored files and on the QPS examples, ``write_qps`` text equal and
round-tripping, ``default_subset`` equal, bucketing and missing files, the
corpus rows of the "f64" and "refined" engines against the JAX rows (same
status, obj_ok and iterations -- but for hs35mod on the f64 engine, an
exact tie in f64 whose count is 0 or 1 by the host's rounding; objective
within 1e-9 x max(1, |objective|), 1e-8 on the singular set), the
"pallas" rows (plain K3 here) held as the saved lanes are (a passing row
has f* within run_corpus's check, a missed row is passed by the rescue,
and rows that pass in both packages agree), and the "pallas_rescued" rows
gated as tests/test_corpus.py gates them (SUCCESS, obj_ok, KKT <= 1e-8),
the LARGE_SPECS buckets included."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from jrlqp_tpu import io as jio
from jrlqp_tpu.io import maros_meszaros as jmm
from jrlqp_tpu_torch import io as tio
from jrlqp_tpu_torch.io import maros_meszaros as tmm
from jrlqp_tpu_torch.testing import ProblemCharacteristics, random_problem
from test_corpus import (
    LARGE_SPECS,
    SPECS,
    VENDORED_DIR,
    VENDORED_SINGULAR,
    VENDORED_STRICT,
)
from test_qps import QPTEST

torch.set_num_threads(1)

VENDORED_FILES = sorted(f for f in os.listdir(VENDORED_DIR)
                        if f.endswith(".QPS"))


def _assert_qps_equal(ours, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("fname", VENDORED_FILES)
def test_parse_vendored_bitwise(fname):
    with open(os.path.join(VENDORED_DIR, fname)) as fh:
        text = fh.read()
    _assert_qps_equal(tio.parse_qps(text), jio.parse_qps(text))
    path = os.path.join(VENDORED_DIR, fname)
    _assert_qps_equal(tio.read_qps(path), jio.read_qps(path,
                                                       engine="python"))


def test_parse_examples_and_errors():
    _assert_qps_equal(tio.parse_qps(QPTEST), jio.parse_qps(QPTEST))
    with_cst = QPTEST.replace("RANGES", "    rhs1      obj       -4.0\n"
                              "RANGES")
    assert tio.parse_qps(with_cst).objcst == 4.0
    for bad in ("NAME x\nBOGUS\n", "ROWS\n X  r\n", "ROWS\n N  o\n N  p\n"):
        with pytest.raises(ValueError):
            tio.parse_qps(bad)
        with pytest.raises(ValueError):
            jio.parse_qps(bad)


def test_read_qps_engines(tmp_path):
    p = tmp_path / "q.qps"
    p.write_text(QPTEST)
    _assert_qps_equal(tio.read_qps(str(p), engine="python"),
                      tio.read_qps(str(p)))
    _assert_qps_equal(tio.read_qps(str(p), engine="native"),
                      tio.read_qps(str(p), engine="python"))
    with pytest.raises(ValueError, match="unknown engine"):
        tio.read_qps(str(p), engine="rust")


def test_write_qps_matches_jax_and_round_trips():
    rng = np.random.default_rng(3)
    for i, (n, n_ineq, n_act, bounds, dbl) in enumerate(SPECS[:6]):
        ch = ProblemCharacteristics(
            n_var=n, n_obj=n, n_ineq=n_ineq, n_strong_act_ineq=n_act,
            bounds=bounds, n_strong_act_bounds=1 if bounds else 0,
            double_sided_ineq=dbl)
        d = random_problem(ch, rng).to_qp_arrays()
        args = (f"p{i}", d["G"], d["a"], d["C"], d["l"], d["u"], d["xl"],
                d["xu"])
        text = tio.write_qps(*args, objcst=d["objcst"])
        assert text == jio.write_qps(*args, objcst=d["objcst"])
        back = tio.parse_qps(text)
        # the lower triangle and its mirror: G is symmetric to the bit
        for k in ("a", "C", "l", "u", "xl", "xu"):
            np.testing.assert_array_equal(getattr(back, k), d[k], err_msg=k)
        np.testing.assert_array_equal(back.G, np.tril(d["G"])
                                      + np.tril(d["G"], -1).T)
        assert back.objcst == d["objcst"]
    with pytest.raises(ValueError, match="free constraint"):
        tio.write_qps("f", np.eye(1), [0.0], [[1.0]], [-np.inf], [np.inf],
                      [0.0], [1.0])


def test_default_subset_matches_jax():
    assert ([dataclasses.astuple(e) for e in tmm.MAROS_MESZAROS]
            == [dataclasses.astuple(e) for e in jmm.MAROS_MESZAROS])
    assert tmm.DEFAULT_EXCLUSIONS == jmm.DEFAULT_EXCLUSIONS
    for kw in ({}, dict(max_cond=1e20, max_var=5000), dict(exclusions=())):
        assert ([e.name for e in tio.default_subset(**kw)]
                == [e.name for e in jio.default_subset(**kw)])
    names = {e.name for e in tio.default_subset()}
    assert "qptest" in names and "cvxqp1_s" not in names
    assert "qpcboei1" not in names and "boyd1" not in names


def _make_corpus(tmp_path, specs, seed=0):
    """Synthesized QPS files with known f* (the port's generator and
    writer; the construction of test_corpus._make_corpus)."""
    rng = np.random.default_rng(seed)
    entries = []
    for i, (n, n_ineq, n_act, bounds, dbl) in enumerate(specs):
        ch = ProblemCharacteristics(
            n_var=n, n_obj=n, n_ineq=n_ineq, n_strong_act_ineq=n_act,
            bounds=bounds, n_strong_act_bounds=1 if bounds else 0,
            double_sided_ineq=dbl)
        pb = random_problem(ch, rng)
        d = pb.to_qp_arrays()
        r = pb.A @ pb.x - pb.b
        name = f"synth{i:02d}"
        (tmp_path / f"{name}.qps").write_text(tio.write_qps(
            name, d["G"], d["a"], d["C"], d["l"], d["u"], d["xl"], d["xu"],
            objcst=d["objcst"]))
        entries.append(tmm.MarosMeszarosEntry(
            name=name, fstar=0.5 * float(r @ r), cond=1.0,
            nb_cstr=d["C"].shape[0], nb_var=n,
            nz=int(np.count_nonzero(d["C"])), qn=n, qnz=0))
    return entries


def test_bucketing_and_missing_files(tmp_path):
    entries = _make_corpus(tmp_path, SPECS)
    loaded, missing = tio.load_corpus(str(tmp_path), entries)
    assert not missing and len(loaded) == len(SPECS)
    buckets = {(tmm._bucket_dim(d.n), tmm._bucket_dim(d.m)) for _, d in loaded}
    assert len(buckets) <= len(SPECS) / 2
    for x in (1, 5, 8, 9, 63, 64, 65, 100, 128, 129, 500):
        assert tmm._bucket_dim(x) == jmm._bucket_dim(x), x
    ghost = tmm.MarosMeszarosEntry(name="nosuchpb", fstar=0.0, cond=1.0,
                                   nb_cstr=1, nb_var=1, nz=1, qn=1, qnz=0)
    rows = tio.run_corpus(qps_dir=str(tmp_path), entries=entries[:2] + [ghost],
                          device="cpu")
    by_name = {r["name"]: r for r in rows}
    assert by_name["nosuchpb"] == {"name": "nosuchpb", "status": "missing"}
    assert by_name["synth00"]["obj_ok"]
    with pytest.raises(ValueError, match="unknown engine"):
        tio.run_corpus(qps_dir=str(tmp_path), entries=entries[:1],
                       engine="fast", device="cpu")
    with pytest.raises(ValueError, match="f64 engine only"):
        tio.run_corpus(qps_dir=str(tmp_path), entries=entries[:1],
                       bucketed=False, engine="pallas", device="cpu")


def _entries(mod, names):
    return [e for e in mod.MAROS_MESZAROS if e.name in names]


# (names, bucketed, engine) of each corpus run held against the JAX rows
RUNS = {
    "strict_f64": (VENDORED_STRICT, True, "f64"),
    "strict_refined": (VENDORED_STRICT, True, "refined"),
    "strict_pallas": (VENDORED_STRICT, True, "pallas"),
    "singular_f64_unbucketed": (VENDORED_SINGULAR, False, "f64"),
}


@pytest.fixture(scope="module")
def jax_rows():
    """run name -> the JAX package's rows (its "pallas" engine in
    interpret mode)."""
    return {run: {r["name"]: r for r in jio.run_corpus(
        qps_dir=VENDORED_DIR, entries=_entries(jmm, names), bucketed=bkt,
        engine=eng)} for run, (names, bkt, eng) in RUNS.items()}


def _hs35mod_tie() -> None:
    """hs35mod (hs35 with x2 fixed at 0.5) is an exact tie in f64: with x2
    fixed, the minimizer of the free coordinates, x = (1.5, 0.5, 0.5), lies
    exactly on row r0 (x1 + x2 + 2 x3 <= 3) with multiplier 0. Its slack
    is 0 in exact arithmetic, so whether the f64 engine's computed slack
    rounds to 0 or to -1 ulp decides whether r0 is added (one iteration, a
    step of length 0) or the solve ends after the fixed bound (0
    iterations): the count depends on the order of the host's sums, and
    the objective, status and f* do not."""
    from fractions import Fraction
    q = tio.read_qps(os.path.join(VENDORED_DIR, "HS35MOD.QPS"))
    x = [Fraction(3, 2), Fraction(1, 2), Fraction(1, 2)]
    G = [[Fraction(float(v)) for v in row] for row in q.G]
    a = [Fraction(float(v)) for v in q.a]
    grad = [sum(G[i][j] * x[j] for j in range(3)) + a[i] for i in range(3)]
    fixed = [j for j in range(3) if q.xl[j] == q.xu[j]]
    assert fixed == [1] and x[1] == Fraction(float(q.xl[1]))
    assert [grad[j] for j in (0, 2)] == [0, 0]   # stationary in x1, x3
    assert min(x[0], x[2]) > 0                    # off their bounds
    assert q.C.shape[0] == 1 and q.l[0] == -np.inf
    slack = Fraction(float(q.u[0])) - sum(
        Fraction(float(c)) * v for c, v in zip(q.C[0], x))
    assert slack == 0


# rows whose iteration count is an exact tie of the f64 engine: 0 or 1
ITERATION_TIES = {("strict_f64", "hs35mod"): _hs35mod_tie}


@pytest.fixture(scope="module")
def rescued_rows():
    """The port's "pallas_rescued" rows of the strict set (the f32 engine,
    then the f64 J/R engine on the rows it misses), by name."""
    return {r["name"]: r for r in tio.run_corpus(
        qps_dir=VENDORED_DIR, entries=_entries(tmm, VENDORED_STRICT),
        engine="pallas_rescued", device="cpu")}


def _passes(r) -> bool:
    return (r["status"] == "SUCCESS" and r["obj_ok"]
            and r["kkt_residual"] <= 1e-8)


def _hold_f32_rows(rows, ref, rescued) -> None:
    """The f32 engine's rows, held as the saved lanes are: its status, KKT
    and obj_ok on an ill-conditioned file follow the host's sum order
    (hs268 ends with KKT 3.8e-5 under a no-FMA setting, 5.4e-8 by default),
    so a row that passes has f* within run_corpus's own check, the rescued
    run passes a row that misses, and where both packages' rows pass they
    agree on status, obj_ok, f* and iterations."""
    for r in rows:
        j = ref[r["name"]]
        assert set(r) == set(j) and r["fstar"] == j["fstar"], (r, j)
        if _passes(r):
            assert (abs(r["objective"] - r["fstar"])
                    <= 1e-6 * max(1.0, abs(r["fstar"]))), r
        else:
            assert _passes(rescued[r["name"]]), (r, rescued[r["name"]])
        if _passes(r) and _passes(j):
            for k in ("status", "obj_ok", "fstar", "iterations"):
                assert r[k] == j[k], (k, r, j)


@pytest.mark.parametrize("run", list(RUNS))
def test_vendored_rows_match_jax(jax_rows, run, request):
    names, bucketed, engine = RUNS[run]
    rows = tio.run_corpus(qps_dir=VENDORED_DIR,
                          entries=_entries(tmm, names), bucketed=bucketed,
                          engine=engine, device="cpu")
    assert len(rows) == len(names)
    ref = jax_rows[run]
    if engine == "pallas":
        _hold_f32_rows(rows, ref, request.getfixturevalue("rescued_rows"))
        return
    for r in rows:
        j = ref[r["name"]]
        assert set(r) == set(j)
        for k in ("status", "obj_ok", "fstar"):
            assert r[k] == j[k], (k, r, j)
        tie = ITERATION_TIES.get((run, r["name"]))
        if tie is None:
            assert r["iterations"] == j["iterations"], ("iterations", r, j)
        else:
            tie()
            assert {r["iterations"], j["iterations"]} <= {0, 1}, (r, j)
        # relative to max(1, |objective|), as run_corpus's own f* check;
        # 1e-8 on the singular set, whose G (cond = inf) leaves Cholesky
        # pivots near 0 that magnify the summation order's last bits
        tol = 1e-8 if run == "singular_f64_unbucketed" else 1e-9
        assert (abs(r["objective"] - j["objective"])
                <= tol * max(1.0, abs(j["objective"]))), (
            f"{r['name']}: objective within {tol} x max(1, |obj|)", r, j)
        if run == "singular_f64_unbucketed":
            # the gate of test_vendored_singular_problems_f64 (no KKT gate:
            # with cond(G) = inf the residual of genhs28 is 1.5e-8 here and
            # 3.6e-9 in the JAX package)
            assert r["status"] in ("SUCCESS", "NON_POS_HESSIAN"), r
            assert r["status"] != "SUCCESS" or r["obj_ok"], r
        else:
            assert r["status"] == "SUCCESS", r
            # KKT <= 1e-8 wherever the JAX row meets it
            if j["kkt_residual"] <= 1e-8:
                assert r["kkt_residual"] <= 1e-8, (r, j)


def test_vendored_strict_pallas_rescued(rescued_rows):
    assert len(rescued_rows) == len(VENDORED_STRICT)
    for r in rescued_rows.values():
        assert r["status"] == "SUCCESS", r
        assert r["obj_ok"], r
        assert r["kkt_residual"] <= 1e-8, r


def test_large_buckets_through_pallas_rescued(tmp_path):
    entries = _make_corpus(tmp_path, LARGE_SPECS, seed=7)
    rows = tio.run_corpus(qps_dir=str(tmp_path), entries=entries,
                          engine="pallas_rescued", device="cpu")
    assert len(rows) == len(LARGE_SPECS)
    for r in rows:
        assert r["status"] == "SUCCESS", r
        assert r["obj_ok"], r
        assert r["kkt_residual"] <= 1e-8, r


def test_synthesized_corpus_f64_matches_jax(tmp_path):
    entries = _make_corpus(tmp_path, SPECS, seed=1)
    rows = tio.run_corpus(qps_dir=str(tmp_path), entries=entries,
                          device="cpu")
    ref = {r["name"]: r for r in jio.run_corpus(qps_dir=str(tmp_path),
                                                entries=entries)}
    for r in rows:
        j = ref[r["name"]]
        for k in ("status", "obj_ok", "iterations"):
            assert r[k] == j[k], (k, r, j)
        assert (abs(r["objective"] - j["objective"])
                <= 1e-9 * max(1.0, abs(j["objective"]))), (
            "objective within 1e-9 x max(1, |obj|)", r, j)
        assert r["status"] == "SUCCESS" and r["obj_ok"], r
        assert r["kkt_residual"] <= 1e-8, r
