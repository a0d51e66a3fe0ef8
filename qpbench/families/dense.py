"""The dense family: ``random_qp_batch`` of the port's testing package
(``jrlqp_tpu_torch.testing.batch_gen``), rewritten in torch draw for draw
(the same generator calls in the same order) so that a batch is drawn on
the card in a few large calls; drawn in ``cfg["draw_dtype"]`` and cast to
float64, as ``bench.py`` draws its headline set."""
from __future__ import annotations

import dataclasses

import torch

from qpbench.gen import F64, QP, generator


def random_qp_batch(gen: torch.Generator, batch: int, n: int, m: int,
                    act_frac: float, dtype, device) -> QP:
    """``random_qp_batch`` of the port's testing package, draw for draw:
    G = A A^T / n + I; a, C standard normal; l, u offsets of C x0 for a
    uniform interior x0 in [-1, 1]^n, the first int(act_frac min(n, m))
    rows with a zero lower offset; no variable bounds."""
    kw = dict(generator=gen, dtype=dtype, device=device)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, **kw)

    A = torch.randn((batch, n, n), **kw)
    G = A @ A.transpose(1, 2) / n + torch.eye(n, dtype=dtype, device=device)
    del A
    a = torch.randn((batch, n), **kw)
    C = torch.randn((batch, m, n), **kw)
    x0 = uniform((batch, n), -1.0, 1.0)
    cx = torch.einsum("bij,bj->bi", C, x0)
    off_l = uniform((batch, m), 0.01, 1.0)
    off_u = uniform((batch, m), 0.01, 1.0)
    tight = torch.arange(m, device=device) < int(act_frac * min(n, m))
    l = cx - torch.where(tight, torch.zeros_like(off_l), off_l * 3.0)
    u = cx + off_u * 3.0
    inf = torch.full((batch, n), torch.inf, dtype=dtype, device=device)
    return QP(G=G, a=a, C=C, l=l, u=u, xl=-inf, xu=inf)


def draw(cfg: dict, seed: int, pool_index: int, device) -> QP:
    """Batch ``pool_index`` of the run: ``cfg["batch"]`` problems of sizes
    ``n``, ``m`` and ``act_frac`` tight rows."""
    gen = generator(device, seed, 1, pool_index, 0)
    p = random_qp_batch(gen, cfg["batch"], cfg["n"], cfg["m"],
                        cfg["act_frac"], getattr(torch, cfg["draw_dtype"]),
                        device)
    return QP(**{f.name: getattr(p, f.name).to(F64)
                 for f in dataclasses.fields(QP)})
