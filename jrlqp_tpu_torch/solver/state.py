"""Solver state and result. Counterpart of :mod:`jrlqp_tpu.solver.state`,
with a leading batch dimension on every field.

Active-set representation of the J/R engine (the reference's dual view,
ref: internal/ActiveSet.h): ``status`` is the (m+n) ActivationStatus of
every constraint (general constraints first, then variable bounds);
``aorder`` the active constraints in activation order (-1 beyond q), and
the condensed multipliers ``u`` are stored in the same order. The
explicit-form engine's :class:`FastState` (``solver/fast.py`` and the
kernels K11 and K12, which write it) holds the operators H and N* in place
of J and R, and the init's hscale.
"""
from __future__ import annotations

import dataclasses

import torch

from ..types import RUNNING

__all__ = ["GIState", "FastState", "GIResult", "initial_state"]


@dataclasses.dataclass(frozen=True)
class GIState:
    """Batched state of the dense J/R engine (``jrlqp_tpu.solver.state.
    GIState`` per lane)."""

    x: torch.Tensor          # (B, n) primal iterate
    f: torch.Tensor          # (B,) objective value
    J: torch.Tensor          # (B, n, n) J = L^-T Q
    R: torch.Tensor          # (B, n, n) upper triangular, identity beyond q
    status: torch.Tensor     # (B, m+n) int32 ActivationStatus
    aorder: torch.Tensor     # (B, n) int32 active indices in activation order
    u: torch.Tensor          # (B, n+1) condensed multipliers
    q: torch.Tensor          # (B,) int32 number of active constraints
    it: torch.Tensor         # (B,) int32 iteration counter
    term: torch.Tensor       # (B,) int32 TerminationStatus, RUNNING meanwhile
    skip1: torch.Tensor      # (B,) bool: skip the selection (partial step)
    sc_idx: torch.Tensor     # (B,) int32 selected constraint
    sc_status: torch.Tensor  # (B,) int32 its ActivationStatus


@dataclasses.dataclass(frozen=True)
class FastState:
    """Batched state of the explicit-form engine
    (``jrlqp_tpu.solver.fast.FastState`` with a leading batch dimension)."""

    x: torch.Tensor        # (B, n)
    f: torch.Tensor        # (B,)
    H: torch.Tensor        # (B, n, n) reduced inverse Hessian
    Ns: torch.Tensor       # (B, n, n) row k = N* row of active slot k
    status: torch.Tensor   # (B, m+n) int32
    aorder: torch.Tensor   # (B, n) int32, -1 marks a free slot
    u: torch.Tensor        # (B, n+1) multipliers by slot
    q: torch.Tensor        # (B,) int32
    it: torch.Tensor       # (B,) int32
    term: torch.Tensor     # (B,) int32
    skip1: torch.Tensor    # (B,) bool
    sc_idx: torch.Tensor   # (B,) int32
    sc_status: torch.Tensor  # (B,) int32
    hscale: torch.Tensor   # (B,) trace(G^-1) at init


def initial_state(B: int, n: int, m: int, dtype, device) -> GIState:
    """The state before the init: x = 0, J = R = I, nothing active
    (``initial_state``, state.py:47-62)."""
    i32 = torch.int32
    eye = torch.eye(n, dtype=dtype, device=device).expand(B, n, n)
    zeros = torch.zeros((B,), dtype=i32, device=device)
    return GIState(
        x=torch.zeros((B, n), dtype=dtype, device=device),
        f=torch.zeros((B,), dtype=dtype, device=device),
        J=eye.clone(), R=eye.clone(),
        status=torch.zeros((B, m + n), dtype=i32, device=device),
        aorder=torch.full((B, n), -1, dtype=i32, device=device),
        u=torch.zeros((B, n + 1), dtype=dtype, device=device),
        q=zeros, it=zeros, term=zeros + RUNNING,
        skip1=torch.zeros((B,), dtype=torch.bool, device=device),
        sc_idx=zeros - 1, sc_status=zeros)


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
