"""Mixed-precision solve: f32 active-set identification, then f64
refinement. Counterpart of :mod:`jrlqp_tpu.solver.mixed`
(mixed.py:45-63).

1. *Identify* the active set with the whole J/R iteration in float32
   (:func:`.dense.solve_batch` with a looser zero-z threshold): which
   constraint is most violated and which multiplier blocks need only a
   few correct digits.
2. *Refine* in float64 with the warm start (:func:`.warm_start.solve_warm`
   from the f32 active set): J/R is rebuilt from that set and the closed
   form evaluated; if the set was right that is the answer (0 further
   iterations), and if it was off the f64 loop continues from there.
"""
from __future__ import annotations

import torch

from ..problems import QPProblem
from ..types import SolverOptions
from .dense import solve_batch
from .state import GIResult
from .warm_start import solve_warm

__all__ = ["solve_mixed", "F32_ZERO_Z"]

# f32 needs a looser "z is numerically zero" threshold than the reference's
# 1e-14: float32 eps ~ 1.2e-7
F32_ZERO_Z = 1e-6


def solve_mixed(pbs: QPProblem, opt: SolverOptions = SolverOptions()
                ) -> GIResult:
    """Solve a batch in f32, refine in f64. Returns a float64 result whose
    ``iterations`` counts the f32 iterations plus the f64 ones. Runs on the
    problems' device: on a card, one launch of K10 in f32, then the f64
    warm init and one launch of K10 in f64."""
    res32 = solve_batch(pbs.with_dtype(torch.float32),
                        opt.with_(dtype=torch.float32,
                                  zero_z_threshold=F32_ZERO_Z))
    res64 = solve_warm(pbs.with_dtype(torch.float64), res32.active_set,
                       opt.with_(dtype=torch.float64, warm_start=True))
    return GIResult(
        x=res64.x,
        multipliers=res64.multipliers,
        f=res64.f,
        iterations=res32.iterations + res64.iterations,
        status=res64.status,
        active_set=res64.active_set,
    )
