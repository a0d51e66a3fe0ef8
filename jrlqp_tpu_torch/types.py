"""Activation/termination enums and solver options.

Counterpart of :mod:`jrlqp_tpu.types`. The integer values are identical, so
status arrays of the two packages compare elementwise; the ordering is
semantic (``status <= EQUALITY`` is a general constraint, ``status >=
LOWER_BOUND`` a variable bound).
"""
from __future__ import annotations

import dataclasses
import enum

import torch

__all__ = [
    "ActivationStatus",
    "TerminationStatus",
    "SolverOptions",
    "BIG_BND",
]

BIG_BND = 1e100


class ActivationStatus(enum.IntEnum):
    INACTIVE = 0
    LOWER = 1
    UPPER = 2
    EQUALITY = 3
    LOWER_BOUND = 4
    UPPER_BOUND = 5
    FIXED = 6


class TerminationStatus(enum.IntEnum):
    RUNNING = -1
    SUCCESS = 0
    INCONSISTENT_INPUT = 1
    NON_POS_HESSIAN = 2
    INFEASIBLE = 3
    MAX_ITER_REACHED = 4
    LINEAR_DEPENDENCY_DETECTED = 5
    OVERCONSTRAINED_PROBLEM = 6
    UNKNOWN = 7


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Runtime options; the same fields as ``jrlqp_tpu.types.SolverOptions``
    with a torch dtype."""

    max_iter: int = 500
    big_bnd: float = BIG_BND
    warm_start: bool = False
    # lanes with inverted/NaN bounds or non-finite G/a/C terminate with
    # INCONSISTENT_INPUT (one extra data pass per solve)
    validate: bool = False
    zero_z_threshold: float = 1e-14
    dtype: torch.dtype = torch.float64

    def with_(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)


INACTIVE = int(ActivationStatus.INACTIVE)
LOWER = int(ActivationStatus.LOWER)
UPPER = int(ActivationStatus.UPPER)
EQUALITY = int(ActivationStatus.EQUALITY)
LOWER_BOUND = int(ActivationStatus.LOWER_BOUND)
UPPER_BOUND = int(ActivationStatus.UPPER_BOUND)
FIXED = int(ActivationStatus.FIXED)

RUNNING = int(TerminationStatus.RUNNING)
SUCCESS = int(TerminationStatus.SUCCESS)
INCONSISTENT_INPUT = int(TerminationStatus.INCONSISTENT_INPUT)
NON_POS_HESSIAN = int(TerminationStatus.NON_POS_HESSIAN)
INFEASIBLE = int(TerminationStatus.INFEASIBLE)
MAX_ITER_REACHED = int(TerminationStatus.MAX_ITER_REACHED)
LINEAR_DEPENDENCY_DETECTED = int(TerminationStatus.LINEAR_DEPENDENCY_DETECTED)
OVERCONSTRAINED_PROBLEM = int(TerminationStatus.OVERCONSTRAINED_PROBLEM)
