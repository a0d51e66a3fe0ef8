"""The IK family: the distribution of ``ik_batch`` of the port's testing
package (``jrlqp_tpu_torch.testing.ik_gen``), the reference's "Sequential
IK", drawn in torch on the card: a tri-block-diagonal G with diagonal
blocks A A^T + nb s I and standard normal coupling blocks, a block-diagonal
C, bounds around an interior point. A batch is an :class:`IKBatch` of
blocks; its :class:`~qpbench.gen.QP` is formed from the blocks here."""
from __future__ import annotations

import dataclasses

import torch

from qpbench.gen import F64, QP, generator

GTYPE = "TRI_BLOCK_DIAGONAL"


@dataclasses.dataclass
class IKBatch:
    """A batch of the IK family in block form: diag (B, nb, s, s), off
    (B, nb-1, s, s) at block (i+1, i), blocks (B, nb, mc, s), and a, l, u."""

    diag: torch.Tensor
    off: torch.Tensor
    blocks: torch.Tensor
    a: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor

    def dense(self) -> QP:
        """The dense QP of the blocks, formed here from the blocks alone."""
        B, nb, s, _ = self.diag.shape
        mc = self.blocks.shape[2]
        n, m = nb * s, nb * mc
        G = self.diag.new_zeros((B, n, n))
        C = self.diag.new_zeros((B, m, n))
        for i in range(nb):
            G[:, i * s:(i + 1) * s, i * s:(i + 1) * s] = self.diag[:, i]
            C[:, i * mc:(i + 1) * mc, i * s:(i + 1) * s] = self.blocks[:, i]
        for i in range(nb - 1):
            G[:, (i + 1) * s:(i + 2) * s, i * s:(i + 1) * s] = self.off[:, i]
            G[:, i * s:(i + 1) * s, (i + 1) * s:(i + 2) * s] = \
                self.off[:, i].mT
        inf = torch.full_like(self.a, torch.inf)
        return QP(G=G, a=self.a, C=C, l=self.l, u=self.u, xl=-inf, xu=inf)

    def with_step(self, a, l, u) -> "IKBatch":
        return dataclasses.replace(self, a=a, l=l, u=u)


def draw(cfg: dict, seed: int, pool_index: int, device) -> IKBatch:
    """Batch ``pool_index`` of the run: ``cfg["batch"]`` Sequential IK
    problems of ``nb`` robots of ``s`` dof and ``mc`` constraints each,
    float64."""
    if cfg.get("gtype", GTYPE) != GTYPE:
        raise ValueError(f"the ik family draws a {GTYPE} G, not "
                         f"{cfg['gtype']}")
    B, nb, s, mc = cfg["batch"], cfg["nb"], cfg["s"], cfg["mc"]
    n, m = nb * s, nb * mc
    gen = generator(device, seed, 2, pool_index)
    kw = dict(generator=gen, dtype=F64, device=device)
    off = torch.randn((B, nb - 1, s, s), **kw)
    blocks = torch.randn((B, nb, mc, s), **kw)
    a = torch.randn((B, n), **kw)
    A = torch.randn((B, nb, s, s), **kw)
    diag = A @ A.mT + nb * s * torch.eye(s, dtype=F64, device=device)
    del A
    x0 = -1.0 + 2.0 * torch.rand((B, nb, s, 1), **kw)
    cx = (blocks @ x0).reshape(B, m)
    l = cx - 0.5 * torch.rand((B, m), **kw)
    u = cx + 2.0 * torch.rand((B, m), **kw)
    return IKBatch(diag=diag, off=off, blocks=blocks, a=a, l=l, u=u)
