"""The work K4 (``gi_warm_kernel``, ``csrc/gi_kernel.cu``), the warm step
of the dense control loop, must do: a frozen copy of the count of
``chip_smoke.py``'s ``k4_bound`` (phase 7), in the form of
``qpbench/counts.py``, at the unpadded sizes.

Bytes, 4 per f32 or int32 word, each input read once and each output
written once: the problem (G, C, l, u, xl, xu), what the step starts from
(a, K = [H | N*^T], status, aorder and q) and its outputs (x, u, status,
aorder, eight scalars, K and tr0). Operations: the warm init's closed form
x = K [-a; b] and u = (a + G x)^T K (6 n^2 a lane), then the loop terms of
``counts.gi_flops`` for its iterations (no n^3 prologue: the carry holds
the operators).

The active count a lane enters with is the carry's, which a run's
``traced_counts`` do not hold (their ``q0`` counts the equality rows). It
moves only the operations, and K4 binds on bytes: at n = 50, m = 100 the
operations' time stays below the bytes' until a lane averages some 40
iterations, and a warm step takes a few. So it does not move the bound.
"""
from __future__ import annotations

import numpy as np

from . import counts

# kernel name substring that a profiler trace shows for K4
KERNEL = "gi_warm_kernel"


def k4_flops(it, q0, q_end, n: int, m: int) -> float:
    """FLOPs of K4 for a batch: per lane the closed form (6 n^2) and the
    loop terms of :func:`qpbench.counts.gi_flops` over its iterations."""
    it, q0, q_end = (np.asarray(v, dtype=np.float64) for v in (it, q0, q_end))
    q_sum = np.maximum(it * (q0 + q_end - 1) / 2, 0.0)
    loop = it * (2 * m * n + 4 * n * n) + 4 * n * q_sum
    return float((loop + 6 * n * n).sum())


def k4_bytes(batch: int, n: int, m: int) -> int:
    """Bytes K4 must move: the problem, a, K, status, aorder and q read,
    and the outputs written."""
    problem = n * n + m * n + 2 * m + 2 * n
    start = 2 * n * n + 3 * n + m + 1
    outputs = 2 * n * n + 4 * n + m + 9
    return 4 * batch * (problem + start + outputs)


def k4_bound_s(batch, n, m, it, q0, q_end) -> float:
    return counts.bound_s(k4_flops(it, q0, q_end, n, m),
                          k4_bytes(batch, n, m))


def roofline_pct(run):
    """100 x the summed K4 bound of the traced calls over the device time
    of the kernels named ``gi_warm_kernel`` in the traced range; None
    where the trace shows no such kernel."""
    tr = run.trace
    if tr is None or not run.traced_counts:
        return None
    t_us = sum(min(e, tr.t1) - max(s, tr.t0)
               for ivs in tr.device.values() for s, e, name, _ in ivs
               if KERNEL in name and e > tr.t0 and s < tr.t1)
    if t_us <= 0:
        return None
    bound = sum(k4_bound_s(c["batch"], c["n"], c["m"], c["it"], c["q0"],
                           c["q_end"]) for c in run.traced_counts)
    return 100.0 * bound / (t_us / 1e6)
