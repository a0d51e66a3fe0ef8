"""Reader for the reference's MultiIK robotics fixture format.

A numpy copy of :mod:`jrlqp_tpu.io.ikmat`: the same text gives the same
arrays bit for bit. Two file kinds (format per ref: tests/IKmatReader.cpp:11-146):

- plain matrix files: whitespace-separated floats, one matrix row per line
  (``read_mat``, ref ``readMat``);
- composite IK problem files: ``==== name ====`` section headers followed by
  the section payload, sections in order dim_var, dim_eq, dim_ineq, Q, c,
  A, b, C, d, x_min, x_max (``read_ik_pb``, ref ``readIKPbFile``).

The fixtures themselves (MultiIK.zip) ship with the reference test suite and
are not vendored here; tests locate them at runtime and skip when absent
(the same opt-in pattern the reference uses for the QPS corpus).
"""
from __future__ import annotations

import dataclasses
import io
import os
import zipfile

import numpy as np

__all__ = ["read_mat", "read_ik_pb", "write_ik_pb", "IKProblem",
           "open_multi_ik"]


def _read_lines(f) -> list[str]:
    return [ln.rstrip("\n") for ln in f]


def read_mat(path_or_file) -> np.ndarray:
    """All lines as one matrix (ref: readMat(filename), IKmatReader.cpp:95).
    A single column of values comes back as shape (rows, 1)."""
    if hasattr(path_or_file, "read"):
        lines = _read_lines(path_or_file)
    else:
        with open(path_or_file) as fh:
            lines = _read_lines(fh)
    rows = [np.array(ln.split(), dtype=float) for ln in lines if ln.strip()]
    if not rows:
        return np.zeros((0, 0))
    return np.vstack(rows)


@dataclasses.dataclass
class IKProblem:
    """Composite IK problem: min 0.5 x'Qx + c'x  s.t.  Ax = b, Cx <= d,
    x_min <= x <= x_max (ref: readIKPbFile, IKmatReader.cpp:106-146)."""

    Q: np.ndarray   # (n, n)
    c: np.ndarray   # (n,)
    A: np.ndarray   # (me, n) equalities
    b: np.ndarray   # (me,)
    C: np.ndarray   # (mi, n) inequalities (upper bounds)
    d: np.ndarray   # (mi,)
    x_min: np.ndarray  # (n,)
    x_max: np.ndarray  # (n,)

    @property
    def n(self):
        return self.Q.shape[0]

    def qp_arrays(self):
        """Arrays in the solvers' convention: stack equalities (l = u = b) and
        inequalities (l = -inf, u = d) into one constraint block."""
        inf = np.inf
        Cs = np.vstack([self.A, self.C]) if self.A.size or self.C.size \
            else np.zeros((0, self.n))
        l = np.concatenate([self.b, np.full(self.C.shape[0], -inf)])
        u = np.concatenate([self.b, self.d])
        return dict(G=self.Q, a=self.c, C=Cs, l=l, u=u,
                    xl=self.x_min, xu=self.x_max)


def _is_header(line: str, name: str) -> bool:
    # ref isDataName (IKmatReader.cpp:34-42): '=' prefix, name at col 5
    return line.startswith("=") and line[5:5 + len(name)] == name


_FIELDS = ["dim_var", "dim_eq", "dim_ineq", "Q", "c", "A", "b", "C", "d",
           "x_min", "x_max"]


def read_ik_pb(path_or_file) -> IKProblem:
    """Parse a composite IK problem file (ref: readIKPbFile)."""
    if hasattr(path_or_file, "read"):
        lines = _read_lines(path_or_file)
    else:
        with open(path_or_file) as fh:
            lines = _read_lines(fh)
    pos = 0

    def expect(name):
        nonlocal pos
        if pos >= len(lines) or not _is_header(lines[pos], name):
            raise ValueError(f"expected section {name!r} at line {pos + 1}")
        pos += 1

    def read_int():
        nonlocal pos
        v = int(lines[pos].split()[0])
        pos += 1
        return v

    def read_rows(nrows):
        nonlocal pos
        out = [np.array(lines[pos + i].split(), dtype=float)
               for i in range(nrows)]
        pos += nrows
        return np.vstack(out) if out else np.zeros((0, 0))

    expect("dim_var")
    n = read_int()
    expect("dim_eq")
    me = read_int()
    expect("dim_ineq")
    mi = read_int()
    expect("Q")
    Q = read_rows(n)
    expect("c")
    c = read_rows(n).ravel()
    expect("A")
    A = read_rows(me) if me else np.zeros((0, n))
    if me == 0:
        pos += 1  # ref consumes one (empty) line for a 0-row matrix
    expect("b")
    b = read_rows(me).ravel() if me else np.zeros((0,))
    if me == 0:
        pos += 1
    expect("C")
    C = read_rows(mi) if mi else np.zeros((0, n))
    if mi == 0:
        pos += 1
    expect("d")
    d = read_rows(mi).ravel() if mi else np.zeros((0,))
    if mi == 0:
        pos += 1
    expect("x_min")
    xl = read_rows(n).ravel()
    expect("x_max")
    xu = read_rows(n).ravel()
    return IKProblem(Q=Q, c=c, A=A, b=b, C=C, d=d, x_min=xl, x_max=xu)


def write_ik_pb(path, pb: IKProblem) -> None:
    """Write a composite IK problem in the reference's format (round-trip
    counterpart of :func:`read_ik_pb`; used for fixture generation)."""
    def fmt(M):
        M = np.atleast_2d(np.asarray(M, float))
        return "\n".join(" ".join(f"{v:.17g}" for v in row) for row in M)

    n = pb.n
    me = pb.A.shape[0]
    mi = pb.C.shape[0]
    parts = []
    for name, payload in [
        ("dim_var", str(n)), ("dim_eq", str(me)), ("dim_ineq", str(mi)),
        ("Q", fmt(pb.Q)), ("c", fmt(pb.c.reshape(-1, 1))),
        ("A", fmt(pb.A) if me else ""),
        ("b", fmt(pb.b.reshape(-1, 1)) if me else ""),
        ("C", fmt(pb.C) if mi else ""),
        ("d", fmt(pb.d.reshape(-1, 1)) if mi else ""),
        ("x_min", fmt(pb.x_min.reshape(-1, 1))),
        ("x_max", fmt(pb.x_max.reshape(-1, 1))),
    ]:
        parts.append(f"==== {name} ====")
        parts.append(payload)
    with open(path, "w") as fh:
        fh.write("\n".join(parts) + "\n")


def open_multi_ik(zip_path: str):
    """Open the reference's MultiIK.zip and return a dict of lazily-read
    members: read_mat on the triBlockDiag_* files and read_ik_pb on
    arrowAllData.txt. Returns None if the archive is missing."""
    if not os.path.exists(zip_path):
        return None
    zf = zipfile.ZipFile(zip_path)

    def _txt(name):
        return io.StringIO(zf.read(name).decode())

    out = {}
    for member in zf.namelist():
        base = os.path.basename(member)
        if not base.endswith(".txt"):
            continue
        key = base[:-4]
        if key == "arrowAllData":
            out[key] = read_ik_pb(_txt(member))
        else:
            out[key] = read_mat(_txt(member))
    return out
