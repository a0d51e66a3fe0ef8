"""Device-side batched random QP generation.

Counterpart of ``jrlqp_tpu.testing.batch_gen.random_qp_batch``
(batch_gen.py:28-78): the same distribution, drawn with a
``torch.Generator`` on the generator's device. The streams differ from
``jax.random``, so tests that compare the two packages share numpy arrays
instead of seeds.
"""
from __future__ import annotations

import torch

from ..problems import QPProblem

__all__ = ["random_qp_batch"]


def random_qp_batch(generator: torch.Generator, batch: int, n: int, m: int,
                    act_frac: float = 0.3, bounds: bool = False,
                    double_sided: bool = True, dtype=torch.float64,
                    device=None) -> QPProblem:
    """Batch of strictly-convex dense QPs.

    G = A A^T / n + I; a, C standard normal; the bounds are offsets of
    C x0 for a uniform interior x0 in [-1, 1]^n, with the first
    ``int(act_frac * min(n, m))`` constraints given a zero lower offset
    (likely active at the solution). ``device`` defaults to the
    generator's device.
    """
    device = torch.device(device) if device is not None else generator.device
    kw = dict(generator=generator, dtype=dtype, device=device)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, **kw)

    A = torch.randn((batch, n, n), **kw)
    G = A @ A.transpose(1, 2) / n + torch.eye(n, dtype=dtype, device=device)
    a = torch.randn((batch, n), **kw)
    C = torch.randn((batch, m, n), **kw)
    x0 = uniform((batch, n), -1.0, 1.0)
    cx = torch.einsum("bij,bj->bi", C, x0)
    off_l = uniform((batch, m), 0.01, 1.0)
    off_u = uniform((batch, m), 0.01, 1.0)
    tight = torch.arange(m, device=device) < int(act_frac * min(n, m))
    l = cx - torch.where(tight, torch.zeros_like(off_l), off_l * 3.0)
    u = cx + off_u * 3.0
    inf = torch.full((batch, m), torch.inf, dtype=dtype, device=device)
    if not double_sided:
        u = inf
    if bounds:
        xl, xu = x0 - 2.0, x0 + 2.0
    else:
        xl = torch.full((batch, n), -torch.inf, dtype=dtype, device=device)
        xu = torch.full((batch, n), torch.inf, dtype=dtype, device=device)
    return QPProblem(G=G, a=a, C=C, l=l, u=u, xl=xl, xu=xu,
                     objcst=torch.zeros((batch,), dtype=dtype, device=device))
