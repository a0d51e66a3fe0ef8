"""Solve result. Counterpart of :mod:`jrlqp_tpu.solver.state` (``GIResult``
only; the J/R engine's ``GIState`` arrives with the dense engine)."""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["GIResult"]


@dataclasses.dataclass(frozen=True)
class GIResult:
    """Batched solve result. ``multipliers`` are in the reference's external
    convention: full (B, m+n), negative at active lower bounds and
    equalities, positive at active upper bounds."""

    x: torch.Tensor            # (B, n)
    multipliers: torch.Tensor  # (B, m+n)
    f: torch.Tensor            # (B,) objective value (without objcst)
    iterations: torch.Tensor   # (B,) int32
    status: torch.Tensor       # (B,) int32 TerminationStatus
    active_set: torch.Tensor   # (B, m+n) int32 ActivationStatus

    @property
    def success(self) -> torch.Tensor:
        return self.status == 0
