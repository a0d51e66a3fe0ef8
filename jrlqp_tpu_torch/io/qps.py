"""QPS-format reader (MPS + QUADOBJ extension) and writer.

A numpy copy of :mod:`jrlqp_tpu.io.qps`: the same text gives the same
arrays bit for bit. Host-side parser producing numpy problem data, the
analog of the reference's test-side reader (ref: tests/QPSReader.h:17-117,
tests/QPSReader.cpp). Format semantics follow the public MPS/QPS
conventions the reference implements:

- ROWS: N (objective, first one wins), E, L, G.
- COLUMNS: (col, row, value) triplets; objective-row entries feed the linear
  cost a.
- RHS: row right-hand sides; the objective-row RHS is the *negated* constant
  term (ref: QPSReader.cpp:414).
- RANGES: E: v >= 0 widens u, v < 0 lowers l; L: l = u - |v|;
  G: u = l + |v| (ref: QPSReader.cpp:255-276).
- BOUNDS: LO/UP/FX/FR/MI/PL; default variable bounds [0, +inf)
  (ref: QPSReader.cpp:204-205,284-305).
- QUADOBJ: lower-triangular entries of G (objective 0.5 x'Gx + a'x).

Output convention matches jrlqp_tpu_torch: constraints one per ROW of C
(the reference stores C transposed), infinite bounds as +/-inf.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["QPSData", "read_qps", "parse_qps", "write_qps"]


@dataclasses.dataclass
class QPSData:
    """Parsed problem + properties (ref: QPSReader.h ProblemProperties)."""

    name: str
    G: np.ndarray  # (n, n) full symmetric
    a: np.ndarray  # (n,)
    C: np.ndarray  # (m, n)
    l: np.ndarray  # (m,)
    u: np.ndarray  # (m,)
    xl: np.ndarray  # (n,)
    xu: np.ndarray  # (n,)
    objcst: float
    n_eq: int
    use_bounds: bool
    has_fixed_variables: bool

    @property
    def n(self):
        return self.G.shape[0]

    @property
    def m(self):
        return self.C.shape[0]


_SECTIONS = {"NAME", "ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS", "QUADOBJ", "ENDATA"}
# OBJSENSE/OBJSENSE MIN etc. are not in the reference's dialect; unknown
# sections raise, like the reference's THROW on unknown line types.


def parse_qps(text: str, name: str = "") -> QPSData:
    """Parse QPS text. Raises ValueError on malformed input."""
    inf = np.inf
    section = None
    problem_name = name
    obj_row = None
    row_types: dict[str, str] = {}
    row_index: dict[str, int] = {}
    col_index: dict[str, int] = {}
    c_vals: list[tuple[int, int, float]] = []
    g_vals: list[tuple[int, int, float]] = []
    a_vals: list[tuple[int, float]] = []
    rhs_vals: list[tuple[int, float]] = []
    range_vals: list[tuple[int, float]] = []
    bnd_vals: list[tuple[str, int, float]] = []
    objcst = 0.0

    def col_of(tok: str) -> int:
        if tok not in col_index:
            col_index[tok] = len(col_index)
        return col_index[tok]

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line or line.lstrip().startswith("*"):
            continue
        is_header = not raw[0].isspace()
        toks = line.split()
        if is_header:
            head = toks[0].upper()
            if head == "NAME":
                problem_name = toks[1] if len(toks) > 1 else problem_name
                continue
            if head == "ENDATA":
                break
            if head not in _SECTIONS:
                raise ValueError(f"line {lineno}: unknown section {head!r}")
            section = head
            continue

        if section == "ROWS":
            if len(toks) != 2:
                raise ValueError(f"line {lineno}: bad ROWS line")
            rtype, rname = toks[0].upper(), toks[1]
            if rtype == "N":
                if obj_row is not None:
                    # the reference rejects a second free row
                    raise ValueError(f"line {lineno}: multiple N rows")
                obj_row = rname
            elif rtype in ("E", "L", "G"):
                row_types[rname] = rtype
                row_index[rname] = len(row_index)
            else:
                raise ValueError(f"line {lineno}: unknown row type {rtype!r}")

        elif section == "COLUMNS":
            if len(toks) not in (3, 5):
                raise ValueError(f"line {lineno}: bad COLUMNS line")
            ci = col_of(toks[0])
            for k in range(1, len(toks), 2):
                rname, val = toks[k], float(toks[k + 1])
                if rname == obj_row:
                    a_vals.append((ci, val))
                elif rname in row_index:
                    c_vals.append((row_index[rname], ci, val))
                else:
                    raise ValueError(f"line {lineno}: unknown row {rname!r}")

        elif section == "RHS":
            # first token is the RHS set name
            if len(toks) not in (3, 5):
                raise ValueError(f"line {lineno}: bad RHS line")
            for k in range(1, len(toks), 2):
                rname, val = toks[k], float(toks[k + 1])
                if rname == obj_row:
                    objcst = -val  # rhs on the wrong side (ref :414)
                elif rname in row_index:
                    rhs_vals.append((row_index[rname], val))
                else:
                    raise ValueError(f"line {lineno}: unknown row {rname!r}")

        elif section == "RANGES":
            if len(toks) not in (3, 5):
                raise ValueError(f"line {lineno}: bad RANGES line")
            for k in range(1, len(toks), 2):
                rname, val = toks[k], float(toks[k + 1])
                if rname not in row_index:
                    raise ValueError(f"line {lineno}: unknown row {rname!r}")
                range_vals.append((row_index[rname], val))

        elif section == "BOUNDS":
            btype = toks[0].upper()
            if btype in ("FR", "MI", "PL", "BV"):
                if len(toks) < 3:
                    raise ValueError(f"line {lineno}: bad BOUNDS line")
                bnd_vals.append((btype, col_of(toks[2]), 0.0))
            elif btype in ("LO", "UP", "FX"):
                if len(toks) != 4:
                    raise ValueError(f"line {lineno}: bad BOUNDS line")
                bnd_vals.append((btype, col_of(toks[2]), float(toks[3])))
            else:
                raise ValueError(f"line {lineno}: unknown bound type {btype!r}")

        elif section == "QUADOBJ":
            if len(toks) != 3:
                raise ValueError(f"line {lineno}: bad QUADOBJ line")
            g_vals.append((col_of(toks[0]), col_of(toks[1]), float(toks[2])))

        else:
            raise ValueError(f"line {lineno}: data before any section")

    n = len(col_index)
    m = len(row_index)
    G = np.zeros((n, n))
    a = np.zeros(n)
    C = np.zeros((m, n))
    l = np.zeros(m)
    u = np.zeros(m)
    xl = np.zeros(n)
    xu = np.full(n, inf)

    for i, j, v in g_vals:
        # QUADOBJ stores the lower triangle; mirror to full symmetric
        G[i, j] = v
        G[j, i] = v
    for i, v in a_vals:
        a[i] = v
    for i, j, v in c_vals:
        C[i, j] = v

    n_eq = 0
    for rname, rtype in row_types.items():
        i = row_index[rname]
        if rtype == "E":
            l[i] = u[i] = 0.0
            n_eq += 1
        elif rtype == "L":
            l[i], u[i] = -inf, 0.0
        else:  # G
            l[i], u[i] = 0.0, inf
    rtype_by_idx = {row_index[k]: v for k, v in row_types.items()}
    for i, v in rhs_vals:
        rt = rtype_by_idx[i]
        if rt == "E":
            l[i] = u[i] = v
        elif rt == "L":
            l[i], u[i] = -inf, v
        else:
            l[i], u[i] = v, inf
    for i, v in range_vals:
        rt = rtype_by_idx[i]
        if rt == "E":
            if v >= 0:
                u[i] += v
            else:
                l[i] += v
        elif rt == "L":
            l[i] = u[i] - abs(v)
        else:
            u[i] = l[i] + abs(v)
    for btype, i, v in bnd_vals:
        if btype == "LO":
            xl[i] = v
        elif btype == "UP":
            xu[i] = v
        elif btype == "FX":
            xl[i] = xu[i] = v
        elif btype == "FR":
            xl[i], xu[i] = -inf, inf
        elif btype == "MI":
            xl[i] = -inf
        elif btype == "PL":
            xu[i] = inf
        elif btype == "BV":
            xl[i], xu[i] = 0.0, 1.0  # binary treated as [0, 1] box

    use_bounds = bool(np.any(xl > -inf) or np.any(xu < inf))
    has_fixed = bool(np.any(xl == xu))
    return QPSData(
        name=problem_name, G=G, a=a, C=C, l=l, u=u, xl=xl, xu=xu,
        objcst=objcst, n_eq=n_eq, use_bounds=use_bounds,
        has_fixed_variables=has_fixed,
    )


def read_qps(path: str, engine: str = "auto") -> QPSData:
    """Read a QPS file. ``engine``: "auto" and "python" use this module's
    parser; "native" (the C++ parser of the JAX package, native/qps_parser.cpp)
    is not ported yet and raises."""
    if engine == "native":
        raise NotImplementedError(
            "read_qps: the native QPS parser is not ported to "
            "jrlqp_tpu_torch yet; use engine='python'")
    if engine not in ("auto", "python"):
        raise ValueError(f"read_qps: unknown engine {engine!r}")
    with open(path) as fh:
        return parse_qps(fh.read())


def write_qps(name, G, a, C, l, u, xl, xu, objcst: float = 0.0) -> str:
    """Serialize a dense QP to QPS text (inverse of :func:`parse_qps`).

    The reference only ships a reader (tests/QPSReader.cpp); the writer
    exists so corpus-style end-to-end tests can synthesize QPS files from
    generator problems with known optima (VERDICT round-1 item 2). Values
    are printed with 17 significant digits, so float64 round-trips exactly
    through the token-based reader.

    Encoding choices (mirroring parse_qps semantics exactly):
    - l == u           -> E row, RHS = l
    - finite l, inf u  -> G row, RHS = l
    - inf l, finite u  -> L row, RHS = u
    - finite l < u     -> G row, RHS = l, RANGES = u - l
    - free rows (both infinite) are not expressible -> ValueError
    - variable bounds: FX / FR / MI+UP / LO+UP as needed (MPS defaults are
      xl = 0, xu = +inf, so only deviations are emitted)
    - a nonzero objective constant is emitted as RHS on the objective row,
      negated (the RHS-on-the-wrong-side convention, ref QPSReader.cpp:414)
    - every column gets an explicit objective entry (even 0.0) so column
      order is deterministic (readers index columns by first appearance).
    """
    G = np.asarray(G, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    xl = np.asarray(xl, dtype=np.float64)
    xu = np.asarray(xu, dtype=np.float64)
    n = a.shape[0]
    m = C.shape[0]
    fmt = lambda v: f"{v:.17g}"  # noqa: E731
    cname = [f"x{j}" for j in range(n)]
    rname = [f"r{i}" for i in range(m)]

    out = [f"NAME          {name}", "ROWS", " N  obj"]
    rtype = []
    for i in range(m):
        li, ui = l[i], u[i]
        if not (np.isfinite(li) or np.isfinite(ui)):
            raise ValueError(f"row {i}: free constraint not expressible in QPS")
        if li == ui:
            t = "E"
        elif np.isfinite(li):
            t = "G"
        else:
            t = "L"
        rtype.append(t)
        out.append(f" {t}  {rname[i]}")

    out.append("COLUMNS")
    for j in range(n):
        out.append(f"    {cname[j]}  obj  {fmt(a[j])}")
        for i in range(m):
            if C[i, j] != 0.0:
                out.append(f"    {cname[j]}  {rname[i]}  {fmt(C[i, j])}")

    out.append("RHS")
    if objcst != 0.0:
        out.append(f"    rhs  obj  {fmt(-float(objcst))}")
    for i in range(m):
        v = l[i] if rtype[i] in ("E", "G") else u[i]
        if v != 0.0:
            out.append(f"    rhs  {rname[i]}  {fmt(v)}")

    ranged = [i for i in range(m)
              if rtype[i] == "G" and np.isfinite(u[i]) and u[i] != l[i]]
    if ranged:
        out.append("RANGES")
        for i in ranged:
            out.append(f"    rng  {rname[i]}  {fmt(u[i] - l[i])}")

    out.append("BOUNDS")
    for j in range(n):
        lo, up = xl[j], xu[j]
        if lo == up:
            out.append(f" FX BND  {cname[j]}  {fmt(lo)}")
        elif not np.isfinite(lo) and not np.isfinite(up):
            out.append(f" FR BND  {cname[j]}")
        else:
            if not np.isfinite(lo):
                out.append(f" MI BND  {cname[j]}")
            elif lo != 0.0:
                out.append(f" LO BND  {cname[j]}  {fmt(lo)}")
            if np.isfinite(up):
                out.append(f" UP BND  {cname[j]}  {fmt(up)}")

    out.append("QUADOBJ")
    for i in range(n):
        for j in range(i + 1):  # lower triangle, diagonal included
            if G[i, j] != 0.0:
                out.append(f"    {cname[i]}  {cname[j]}  {fmt(G[i, j])}")
    out.append("ENDATA")
    return "\n".join(out) + "\n"
