"""Problem input validation. Counterpart of :mod:`jrlqp_tpu.validation`:

- :func:`well_formed` -- a host-side (numpy) check of one problem at
  construction time: shape coherence, symmetry, finiteness, bound ordering
  (validation.py:26-78, the same findings word for word);
- :func:`inconsistent_mask` -- the batched per-lane predicate the solvers
  apply with ``SolverOptions.validate`` (validation.py:81-94).
"""
from __future__ import annotations

import numpy as np
import torch

from .problems import QPProblem

__all__ = ["well_formed", "inconsistent_mask"]

_FIELDS = ("G", "a", "C", "l", "u", "xl", "xu")


def well_formed(pb, check_symmetry: bool = True, sym_tol: float = 1e-12,
                lane: int = 0):
    """Host-side structural validation of one problem: lane ``lane`` of a
    port :class:`QPProblem`, or any object whose fields G, a, C, l, u, xl,
    xu are unbatched arrays (a parsed QPS file, a JAX problem).

    Returns ``(ok, findings)``; ``findings`` is a list of strings, empty
    when ok. Positive definiteness is not checked: the solvers detect it at
    run time (NON_POS_HESSIAN).
    """
    if isinstance(pb, QPProblem):
        G, a, C, l, u, xl, xu = (getattr(pb, k)[lane].detach().cpu().numpy()
                                 for k in _FIELDS)
    else:
        G, a, C, l, u, xl, xu = (np.asarray(getattr(pb, k)) for k in _FIELDS)
    findings: list[str] = []

    if G.ndim != 2 or G.shape[0] != G.shape[1]:
        findings.append(f"G must be square 2-D, got {G.shape}")
        return False, findings
    n = G.shape[0]
    if a.shape != (n,):
        findings.append(f"a must have shape ({n},), got {a.shape}")
    if C.ndim != 2 or C.shape[1] != n:
        findings.append(f"C must have shape (m, {n}), got {C.shape}")
    m = C.shape[0] if C.ndim == 2 else 0
    for name, v, dim in (("l", l, m), ("u", u, m), ("xl", xl, n),
                         ("xu", xu, n)):
        if v.shape != (dim,):
            findings.append(f"{name} must have shape ({dim},), got {v.shape}")
    if findings:
        return False, findings

    if not np.all(np.isfinite(G)):
        findings.append("G has non-finite entries")
    elif check_symmetry:
        asym = float(np.max(np.abs(G - G.T)))
        scale = max(1.0, float(np.max(np.abs(G))))
        if asym > sym_tol * scale:
            findings.append(f"G is not symmetric (max |G-G'| = {asym:g})")
    if not np.all(np.isfinite(a)):
        findings.append("a has non-finite entries")
    if not np.all(np.isfinite(C)):
        findings.append("C has non-finite entries")
    for name, lo, hi in (("l/u", l, u), ("xl/xu", xl, xu)):
        if np.any(np.isnan(lo)) or np.any(np.isnan(hi)):
            findings.append(f"{name} contains NaN")
        elif np.any(lo > hi):
            k = int(np.argmax(lo > hi))
            findings.append(
                f"{name} inverted at index {k}: {lo[k]!r} > {hi[k]!r}")
    return not findings, findings


def inconsistent_mask(pb: QPProblem) -> torch.Tensor:
    """(B,) bool: True where a lane's data is inconsistent (inverted or NaN
    bounds, non-finite G/a/C)."""
    def any_(t):
        return t.flatten(1).any(dim=1)

    def all_(t):
        return t.flatten(1).all(dim=1)

    bad_bounds = (
        any_(pb.l > pb.u) | any_(pb.xl > pb.xu)
        | any_(torch.isnan(pb.l)) | any_(torch.isnan(pb.u))
        | any_(torch.isnan(pb.xl)) | any_(torch.isnan(pb.xu))
    )
    bad_data = (~all_(torch.isfinite(pb.G)) | ~all_(torch.isfinite(pb.a))
                | ~all_(torch.isfinite(pb.C)))
    return bad_bounds | bad_data
