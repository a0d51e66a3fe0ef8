"""Batched problem container and the numpy carry-over functions.

Counterpart of :mod:`jrlqp_tpu.problems`. A :class:`QPProblem` here is
always a batch: every field has a leading batch dimension. ``C`` has one
constraint per row, and "no bound" is +/-inf, as in the JAX package.

:func:`problem_from_numpy` and :func:`result_to_numpy` carry arrays between
the two packages through numpy, so both can solve the same problems.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["QPProblem", "problem_from_numpy", "result_to_numpy"]


@dataclasses.dataclass(frozen=True)
class QPProblem:
    """min 0.5 x^T G x + a^T x  s.t.  l <= C x <= u, xl <= x <= xu, per lane."""

    G: torch.Tensor   # (B, n, n) symmetric positive definite
    a: torch.Tensor   # (B, n)
    C: torch.Tensor   # (B, m, n) one constraint per row
    l: torch.Tensor   # (B, m)
    u: torch.Tensor   # (B, m)
    xl: torch.Tensor  # (B, n)  -inf where unbounded
    xu: torch.Tensor  # (B, n)  +inf where unbounded
    objcst: torch.Tensor  # (B,)

    @property
    def batch(self) -> int:
        return self.G.shape[0]

    @property
    def n(self) -> int:
        return self.G.shape[-1]

    @property
    def m(self) -> int:
        return self.C.shape[-2]

    def _map(self, fn) -> "QPProblem":
        return QPProblem(**{f.name: fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)})

    def with_dtype(self, dtype: torch.dtype) -> "QPProblem":
        return self._map(lambda t: t.to(dtype))

    def to(self, device) -> "QPProblem":
        return self._map(lambda t: t.to(device))


def problem_from_numpy(*, G, a, C, l, u, xl, xu, objcst=None,
                       device="cuda") -> QPProblem:
    """Batched :class:`QPProblem` from numpy arrays (a JAX problem's fields
    passed through ``np.asarray``). Values, dtype and +/-inf bounds are
    kept bitwise. The problem goes to ``device``, the card unless the caller
    names another (``device="cpu"`` for the CPU)."""
    B = np.shape(G)[0]
    if objcst is None:
        objcst = np.zeros((B,), np.asarray(G).dtype)

    def t(v):
        return torch.from_numpy(np.array(v, copy=True, order="C")).to(device)

    return QPProblem(G=t(G), a=t(a), C=t(C), l=t(l), u=t(u), xl=t(xl),
                     xu=t(xu), objcst=t(np.broadcast_to(objcst, (B,))))


def result_to_numpy(res) -> dict:
    """Dict of numpy arrays from a dataclass of tensors (a result, a problem
    or a solver state), field by field."""
    return {f.name: getattr(res, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(res)}
