"""Batched problem container and the numpy carry-over functions.

Counterpart of :mod:`jrlqp_tpu.problems`. A :class:`QPProblem` here is
always a batch: every field has a leading batch dimension. ``C`` has one
constraint per row, and "no bound" is +/-inf, as in the JAX package.

:func:`problem_from_numpy` and :func:`result_to_numpy` carry arrays between
the two packages through numpy, so both can solve the same problems.
:func:`pad_problem` and :func:`stack_problems` pad batches to a common shape
without changing their solutions, as the JAX package's do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["QPProblem", "LeastSquareProblem", "pad_problem", "stack_problems",
           "problem_from_numpy", "result_to_numpy"]


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


@dataclasses.dataclass(frozen=True)
class LeastSquareProblem:
    """min 0.5 |A x - b|^2  s.t.  E x = f, l <= C x <= u, xl <= x <= xu, per
    lane (``jrlqp_tpu.problems.LeastSquareProblem`` with a batch
    dimension)."""

    A: torch.Tensor   # (B, nobj, n)
    b: torch.Tensor   # (B, nobj)
    E: torch.Tensor   # (B, neq, n)
    f: torch.Tensor   # (B, neq)
    C: torch.Tensor   # (B, m, n)
    l: torch.Tensor   # (B, m)
    u: torch.Tensor   # (B, m)
    xl: torch.Tensor  # (B, n)
    xu: torch.Tensor  # (B, n)

    def to_qp(self) -> QPProblem:
        """G = A^T A, a = -A^T b; the equalities become the first rows of C
        with l == u (problems.py:88-101)."""
        At = self.A.transpose(1, 2)
        return QPProblem(
            G=At @ self.A, a=-(At @ self.b[:, :, None])[:, :, 0],
            C=torch.cat([self.E, self.C], dim=1),
            l=torch.cat([self.f, self.l], dim=1),
            u=torch.cat([self.f, self.u], dim=1), xl=self.xl, xu=self.xu,
            objcst=0.5 * (self.b * self.b).sum(dim=1))


def pad_problem(pb: QPProblem, n_pad: int, m_pad: int) -> QPProblem:
    """Pad a batch to (n_pad, m_pad) without changing its solutions
    (problems.py:103-124): padded variables get G-diagonal 1, a = 0 and
    infinite bounds; padded constraints a zero row and infinite bounds."""
    B, n, m = pb.batch, pb.n, pb.m
    assert n_pad >= n and m_pad >= m, (n, n_pad, m, m_pad)
    if n_pad == n and m_pad == m:
        return pb
    kw = dict(dtype=pb.G.dtype, device=pb.G.device)
    G = torch.zeros((B, n_pad, n_pad), **kw)
    G[:, :n, :n] = pb.G
    k = torch.arange(n, n_pad, device=G.device)
    G[:, k, k] = 1.0
    C = torch.zeros((B, m_pad, n_pad), **kw)
    C[:, :m, :n] = pb.C

    def padded(v, size, fill):
        out = torch.full((B, size), fill, **kw)
        out[:, :v.shape[1]] = v
        return out

    inf = float("inf")
    return QPProblem(G=G, a=padded(pb.a, n_pad, 0.0), C=C,
                     l=padded(pb.l, m_pad, -inf), u=padded(pb.u, m_pad, inf),
                     xl=padded(pb.xl, n_pad, -inf),
                     xu=padded(pb.xu, n_pad, inf), objcst=pb.objcst)


def stack_problems(pbs: list[QPProblem], n_pad: int | None = None,
                   m_pad: int | None = None) -> QPProblem:
    """Pad batches to a common shape and concatenate them into one batch
    (problems.py:126-131; the port's problems are always batched, so each
    item is a batch, usually of one)."""
    n_pad = n_pad or max(p.n for p in pbs)
    m_pad = m_pad or max(p.m for p in pbs)
    padded = [pad_problem(p, n_pad, m_pad) for p in pbs]
    return QPProblem(**{f.name: torch.cat([getattr(p, f.name)
                                           for p in padded])
                        for f in dataclasses.fields(QPProblem)})


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
