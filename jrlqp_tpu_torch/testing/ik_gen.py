"""The multi-robot IK batch of the structured layer, in numpy from a seed.

The generator of ``jrlqp_tpu/bench/harness.py:533-556`` and
``benchmarks/capture_ik_trajectory.py:66-90``, draw for draw: each lane is
nb robots (blocks) of s dof with a tri-block-diagonal G (diagonal blocks
A A^T + nb s I, standard normal coupling blocks), mc constraints per robot
(block-diagonal C, standard normal) and bounds l = Cx0 - U(0, 0.5),
u = Cx0 + U(0, 2) around an interior x0 in [-1, 1]^n. The defaults are the
reference's "Sequential IK" (tests/BlockGISolverTest.in.cpp:172-271):
9 robots x 43 dof, n = 387, m = 36.

It returns numpy arrays, so both packages can solve the same batch; it
imports neither jax nor torch.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ik_batch", "ik_step"]


def ik_batch(batch: int, nb: int = 9, s: int = 43, mc: int = 4,
             seed: int = 0) -> dict:
    """dict of f64 arrays: diag (B, nb, s, s), off (B, nb-1, s, s), blocks
    (B, nb, mc, s), a (B, n), l (B, m), u (B, m)."""
    rng = np.random.default_rng(seed)
    n, m = nb * s, nb * mc
    diag = np.zeros((batch, nb, s, s))
    off = rng.standard_normal((batch, nb - 1, s, s))
    blocks = rng.standard_normal((batch, nb, mc, s))
    a = rng.standard_normal((batch, n))
    l_ = np.zeros((batch, m))
    u_ = np.zeros((batch, m))
    for b in range(batch):
        for i in range(nb):
            A = rng.standard_normal((s, s))
            diag[b, i] = A @ A.T + nb * s * np.eye(s)
        x0 = rng.uniform(-1, 1, n)
        Cd = np.zeros((m, n))
        for i in range(nb):
            Cd[i * mc:(i + 1) * mc, i * s:(i + 1) * s] = blocks[b, i]
        cx = Cd @ x0
        l_[b] = cx - rng.uniform(0.0, 0.5, m)
        u_[b] = cx + rng.uniform(0.0, 2.0, m)
    return dict(diag=diag, off=off, blocks=blocks, a=a, l=l_, u=u_)


def ik_step(base: dict, drift: float, rng: np.random.Generator) -> dict:
    """The next control step of a trajectory (capture_ik_trajectory.py:
    95-107): ``base`` with fresh drift N(0, 1) noise on a and one drift
    N(0, 1) shift per constraint added to both l and u; G and C fixed."""
    da = drift * rng.standard_normal(base["a"].shape)
    db = drift * rng.standard_normal(base["l"].shape)
    return dict(base, a=base["a"] + da, l=base["l"] + db, u=base["u"] + db)
