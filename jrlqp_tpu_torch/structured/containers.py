"""Structured matrix containers, batched: StructuredG and StructuredC.

Counterpart of :mod:`jrlqp_tpu.structured.containers`. Every tensor has a
leading batch dimension (``StructuredG.diag`` is (B, nb, s, s)), the blocks
have one uniform size, and the factorization returns factors instead of
working in place. :func:`structured_from_numpy` carries a JAX batch across
through numpy.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .blocks import (
    block_arrow_l_solve,
    block_arrow_llt,
    block_arrow_lt_solve,
    block_arrow_to_dense,
    tri_block_diag_llt,
    tri_block_l_solve,
    tri_block_lt_solve,
    tri_block_to_dense,
)

__all__ = ["GType", "StructuredG", "StructuredGFactor", "StructuredC",
           "structured_from_numpy"]


class GType(enum.IntEnum):
    """The block layout of G (same values as ``jrlqp_tpu``'s)."""

    TRI_BLOCK_DIAGONAL = 0
    BLOCK_ARROW_UP = 1
    BLOCK_ARROW_DOWN = 2


@dataclasses.dataclass(frozen=True)
class StructuredG:
    """Batch of SPD matrices stored as (B, nb, s, s) diagonal blocks and
    (B, nb-1, s, s) off-diagonal blocks, read per ``gtype``:

    - TRI_BLOCK_DIAGONAL: off[:, i] at block (i+1, i)
    - BLOCK_ARROW_DOWN:   off[:, i] at block (nb-1, i)
    - BLOCK_ARROW_UP:     off[:, i] at block (0, i+1)
    """

    diag: torch.Tensor  # (B, nb, s, s)
    off: torch.Tensor   # (B, nb-1, s, s)
    gtype: int

    def __post_init__(self):
        # a bare string would compare unequal to every GType and fall
        # through to the arrow branches: accept GType values only
        try:
            GType(self.gtype)
        except ValueError:
            raise ValueError(
                f"gtype must be a GType value (e.g. "
                f"GType.TRI_BLOCK_DIAGONAL), got {self.gtype!r}") from None

    @property
    def nb(self) -> int:
        return self.diag.shape[-3]

    @property
    def s(self) -> int:
        return self.diag.shape[-1]

    @property
    def n(self) -> int:
        return self.nb * self.s

    @property
    def up(self) -> bool:
        return self.gtype == GType.BLOCK_ARROW_UP

    def llt(self) -> "StructuredGFactor":
        """The blocked Cholesky factor (containers.py:78-86)."""
        if self.gtype == GType.TRI_BLOCK_DIAGONAL:
            Ld, Lo, ok = tri_block_diag_llt(self.diag, self.off)
        else:
            Ld, Lo, ok = block_arrow_llt(self.diag, self.off, up=self.up)
        return StructuredGFactor(diag=Ld, off=Lo, gtype=self.gtype, posdef=ok)

    def to_dense(self) -> torch.Tensor:
        """(B, n, n)."""
        if self.gtype == GType.TRI_BLOCK_DIAGONAL:
            return tri_block_to_dense(self.diag, self.off)
        return block_arrow_to_dense(self.diag, self.off, up=self.up)


@dataclasses.dataclass(frozen=True)
class StructuredGFactor:
    """Cholesky factor of a StructuredG in the same block layout (an up
    arrow's in the rolled order). ``posdef`` (B,) is True where every block
    factored: torch leaves a finite partial factor where JAX's is NaN."""

    diag: torch.Tensor
    off: torch.Tensor
    gtype: int
    posdef: torch.Tensor

    @property
    def nb(self) -> int:
        return self.diag.shape[-3]

    @property
    def s(self) -> int:
        return self.diag.shape[-1]

    @property
    def n(self) -> int:
        return self.nb * self.s

    def _blocked(self, v):
        """(B, n) or (B, n, k) -> (B, nb, s) or (B, nb, s, k)."""
        return v.reshape(v.shape[0], self.nb, self.s, *v.shape[2:])

    def l_solve(self, r: torch.Tensor) -> torch.Tensor:
        """L^-1 r for r of shape (B, n) or (B, n, k)."""
        rb = self._blocked(r)
        if self.gtype == GType.TRI_BLOCK_DIAGONAL:
            y = tri_block_l_solve(self.diag, self.off, rb)
        else:
            y = block_arrow_l_solve(self.diag, self.off, rb,
                                    up=self.gtype == GType.BLOCK_ARROW_UP)
        return y.reshape(r.shape)

    def lt_solve(self, r: torch.Tensor) -> torch.Tensor:
        """L^-T r."""
        rb = self._blocked(r)
        if self.gtype == GType.TRI_BLOCK_DIAGONAL:
            y = tri_block_lt_solve(self.diag, self.off, rb)
        else:
            y = block_arrow_lt_solve(self.diag, self.off, rb,
                                     up=self.gtype == GType.BLOCK_ARROW_UP)
        return y.reshape(r.shape)

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        """G^-1 r."""
        return self.lt_solve(self.l_solve(r))

    def inverse_transpose(self) -> torch.Tensor:
        """J0 = L^-T as a dense (B, n, n) tensor, computed blockwise."""
        B = self.diag.shape[0]
        eye = torch.eye(self.n, dtype=self.diag.dtype,
                        device=self.diag.device).expand(B, -1, -1)
        return self.lt_solve(eye)


@dataclasses.dataclass(frozen=True)
class StructuredC:
    """Batch of block-diagonal constraint matrices: block i holds ``mc``
    constraints on the i-th variable block, so C is (B, nb*mc, nb*s)."""

    blocks: torch.Tensor  # (B, nb, mc, s)

    @property
    def nb(self) -> int:
        return self.blocks.shape[-3]

    @property
    def mc(self) -> int:
        return self.blocks.shape[-2]

    @property
    def s(self) -> int:
        return self.blocks.shape[-1]

    @property
    def m(self) -> int:
        return self.nb * self.mc

    def transpose_mult(self, x: torch.Tensor) -> torch.Tensor:
        """C x blockwise for x (B, n) (containers.py:185-190)."""
        B = x.shape[0]
        xb = x.reshape(B, self.nb, self.s, 1)
        return (self.blocks @ xb).reshape(B, self.m)

    def to_dense(self) -> torch.Tensor:
        """(B, m, n)."""
        B, nb, mc, s = self.blocks.shape
        C = self.blocks.new_zeros((B, nb * mc, nb * s))
        for i in range(nb):
            C[:, i * mc:(i + 1) * mc, i * s:(i + 1) * s] = self.blocks[:, i]
        return C


def structured_from_numpy(*, diag, off, gtype, blocks, device="cuda"):
    """(StructuredG, StructuredC) from numpy arrays (a JAX batch's fields
    passed through ``np.asarray``): diag (B, nb, s, s), off (B, nb-1, s,
    s), blocks (B, nb, mc, s). Values and dtype are kept bitwise. The
    tensors go to ``device``, the card unless the caller names another."""
    def t(v):
        return torch.from_numpy(np.array(v, copy=True, order="C")).to(device)

    return (StructuredG(diag=t(diag), off=t(off), gtype=int(gtype)),
            StructuredC(blocks=t(blocks)))
