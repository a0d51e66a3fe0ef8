"""The port's native readers (jrlqp_tpu_torch.io.native, built from
jrlqp_tpu_torch/csrc/host/ with g++) against the JAX package's Python
readers on the inputs of tests/test_native_qps.py and
tests/test_native_ikmat.py: equal arrays bit for bit (tolerance 0), the same
ValueError on malformed input; read_qps with each engine on the vendored
files; and the build itself: available wherever g++ is, once for two
processes that start at once."""
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from jrlqp_tpu.io import ikmat as jik
from jrlqp_tpu.io import parse_qps as j_parse_qps
from jrlqp_tpu_torch.io import native
from jrlqp_tpu_torch.io import qps as tqps
from test_qps import QPTEST

ROOT = pathlib.Path(__file__).resolve().parents[1]
VENDORED = sorted((ROOT / "tests" / "data" / "qps").glob("*.QPS"))
PB_FIELDS = ("Q", "c", "A", "b", "C", "d", "x_min", "x_max")

# the RANGES / BOUNDS input of tests/test_native_qps.py (copied: importing
# that module builds the JAX package's library)
RANGES_BOUNDS = """\
NAME          rngtest
ROWS
 N  obj
 E  e1
 L  l1
 G  g1
COLUMNS
    x         e1        1.0   l1        1.0
    x         g1        1.0   obj       1.0
    y         e1        1.0
RHS
    rhs       e1        3.0   l1        5.0
    rhs       g1        1.0
    rhs       obj       -2.5
RANGES
    rng       e1        2.0   l1        4.0
    rng       g1        4.0
BOUNDS
 MI BND       x
 FX BND       y         1.5
QUADOBJ
    x         x         1.0
    y         y         1.0
ENDATA
"""


def _random_pb(rng, n, me, mi):
    """The IK problem of tests/test_native_ikmat.py."""
    return jik.IKProblem(
        Q=rng.standard_normal((n, n)), c=rng.standard_normal(n),
        A=rng.standard_normal((me, n)) if me else np.zeros((0, n)),
        b=rng.standard_normal(me) if me else np.zeros((0,)),
        C=rng.standard_normal((mi, n)) if mi else np.zeros((0, n)),
        d=rng.standard_normal(mi) if mi else np.zeros((0,)),
        x_min=-np.abs(rng.standard_normal(n)),
        x_max=np.abs(rng.standard_normal(n)),
    )


def _bitwise(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _same_qps(ours, ref):
    for f in ("G", "a", "C", "l", "u", "xl", "xu"):
        _bitwise(getattr(ours, f), getattr(ref, f), f)
    for f in ("name", "objcst", "n_eq", "use_bounds", "has_fixed_variables"):
        assert getattr(ours, f) == getattr(ref, f), f


def test_available_wherever_gxx_is():
    # a broken build must fail here, not hide behind engine="auto"
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH")
    assert native.available(), native._load_error
    assert pathlib.Path(native.build_info["path"]).parent == native.BUILD_DIR


@pytest.mark.parametrize("text", [QPTEST, RANGES_BOUNDS],
                         ids=["qptest", "ranges_bounds"])
def test_qps_native_matches_jax_python(text):
    _same_qps(native.parse_qps_native(text), j_parse_qps(text))
    _same_qps(native.parse_qps_native(text), tqps.parse_qps(text))


def test_qps_native_errors():
    with pytest.raises(ValueError, match="unknown section"):
        native.parse_qps_native("GARBAGE\n foo\n")
    bad = QPTEST.replace("    c1        r1        2.0",
                         "    c1        rX        2.0")
    assert bad != QPTEST
    for parse in (native.parse_qps_native, j_parse_qps):
        with pytest.raises(ValueError):
            parse(bad)


@pytest.mark.parametrize("dims", [(5, 2, 3), (4, 0, 2), (3, 2, 0), (2, 0, 0)])
def test_ikpb_native_matches_jax_python(tmp_path, dims):
    pb = _random_pb(np.random.default_rng(sum(dims)), *dims)
    p = tmp_path / "pb.txt"
    jik.write_ik_pb(p, pb)
    ref = jik.read_ik_pb(str(p))
    ours = native.parse_ikpb_native(p.read_text())
    for f in PB_FIELDS:
        _bitwise(getattr(ours, f), getattr(ref, f), f)


def test_mat_native_matches_jax_python(tmp_path):
    M = np.random.default_rng(3).standard_normal((7, 4))
    p = tmp_path / "m.txt"
    p.write_text("\n".join(" ".join(f"{v:.17g}" for v in row) for row in M)
                 + "\n")
    _bitwise(native.parse_mat_native(p.read_text()), jik.read_mat(str(p)))
    _bitwise(native.parse_mat_native("1.5\n2.5\n"), [[1.5], [2.5]])


def test_native_readers_reject_malformed():
    with pytest.raises(ValueError):
        native.parse_ikpb_native("garbage\n")
    with pytest.raises(ValueError):
        native.parse_mat_native("1 2\n3\n")  # ragged


@pytest.mark.parametrize("path", VENDORED, ids=[p.stem for p in VENDORED])
def test_read_qps_engines_on_vendored(path):
    ref = j_parse_qps(path.read_text())
    for engine in ("native", "auto", "python"):
        _same_qps(tqps.read_qps(str(path), engine=engine), ref)


def test_two_processes_build_one_library(tmp_path):
    """Two processes that build into an empty directory at once: one
    compiles, the other waits on the lock and loads its library; no
    temporary file is left."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH")
    code = ("import pathlib, sys; sys.path.insert(0, sys.argv[1]); "
            "from jrlqp_tpu_torch.io import native; "
            "native.BUILD_DIR = pathlib.Path(sys.argv[2]); "
            "assert native.available(), native._load_error; "
            "print(native.build_info['built'], native.build_info['path']); "
            "print(native.parse_mat_native('1 2').tolist())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(ROOT),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [o[0].split("\n") for o in outs]
    built = sorted(ln[0].split()[0] for ln in lines)
    assert built == ["False", "True"], outs
    assert lines[0][0].split()[1] == lines[1][0].split()[1]
    assert all(ln[1] == "[[1.0, 2.0]]" for ln in lines)
    assert [p.name for p in tmp_path.glob("*.so")] == [
        pathlib.Path(lines[0][0].split()[1]).name]
    assert not list(tmp_path.glob("*.tmp"))
