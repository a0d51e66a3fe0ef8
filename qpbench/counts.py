"""The yardstick's peaks and the work a GI loop kernel must do.

Frozen copies of the port's own counts, so that a later change to the
program cannot change how its kernels are judged: ``gi_flops`` and
``gi_bytes`` are ``chip_smoke._gi_flops`` / ``_gi_bytes`` with K1's prologue
(the Cholesky, L^-1, H0 = L^-T L^-1 and x0) added as chip_smoke adds it, and
``fast_loop_flops`` / ``fast_loop_bytes`` are
``jrlqp_tpu_torch.ops.cuda.fast_loop``'s. Every count is of the method's
work at the unpadded sizes, from the iteration and active counts that the
solve returns, with each input read once and each output written once.

``LOOP_KERNELS`` names the loop kernels by the substring of their CUDA name
that a profiler trace shows, with the count that bounds each.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def gi_flops(it, q0, q_end, n: int, m: int) -> float:
    """FLOPs of K1 for a batch: per lane its prologue (n^3 for the Cholesky,
    the triangular inverse and H0, 2n^2 for x0) and its loop iterations.
    Per iteration: the selection C x (2mn), z = H n+ (2n^2) and r = N* n+
    over the q active rows (2nq), and the rank-one update of H (2n^2) and
    of those q rows of N* (2nq). A lane's q summed over its iterations is
    it (q0 + q_end - 1) / 2, exact for a lane that only adds."""
    it, q0, q_end = (np.asarray(v, dtype=np.float64) for v in (it, q0, q_end))
    q_sum = np.maximum(it * (q0 + q_end - 1) / 2, 0.0)
    loop = it * (2 * m * n + 4 * n * n) + 4 * n * q_sum
    return float((loop + n ** 3 + 2 * n * n).sum())


def gi_bytes(batch: int, n: int, m: int) -> int:
    """Bytes K1 must move, 4 per f32 or int32 word: the problem (G, C, l,
    u, xl, xu), a, and its outputs (x, u, status, aorder, eight scalars,
    K = [H | N*^T] and tr0)."""
    problem = n * n + m * n + 2 * m + 2 * n
    outputs = 2 * n * n + 4 * n + m + 9
    return 4 * batch * (problem + n + outputs)


def _adds_removes(it, q0, q_end):
    it, q0, q_end = (np.asarray(v, dtype=np.float64) for v in (it, q0, q_end))
    dq = q_end - q0
    return (it + dq) / 2, (it - dq) / 2, (q0 + q_end) / 2


def fast_loop_flops(it, q0, q_end, n: int, m: int) -> float:
    """FLOPs of K11's iterations: every iteration forms z = H n+ (2n^2) and
    r = N* n+ over the q active rows (2qn); an add also the selection C x
    (2mn) and the updates of H (2n^2) and of the q rows of N* (2qn); a
    removal v = G n_l (2n^2), w = N* v (2qn) and the same two updates. Each
    counted at the lane's mean active count, with a general row's normal
    (the cells' problems have no variable bounds)."""
    adds, removes, q = _adds_removes(it, q0, q_end)
    per_add = 2 * m * n + 4 * n * n + 4 * q * n
    per_remove = 6 * n * n + 6 * q * n
    return float((adds * per_add + removes * per_remove).sum())


def fast_loop_bytes(batch: int, n: int, m: int, itemsize: int = 4) -> int:
    """Bytes K11 must move: the problem (G, C, l, u, xl, xu) and hscale read
    once, the state (x, f, H, N*, u in the working type; status, aorder
    and six scalars in int32) read once and written once."""
    problem = itemsize * (n * n + m * n + 2 * m + 2 * n + 1)
    state = itemsize * (2 * n * n + 2 * n + 2) + 4 * (m + 2 * n + 6)
    return batch * (problem + 2 * state)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time one H100 could take: the larger of the operation time
    at the f32 peak and the byte time at the memory peak."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def k1_bound_s(batch, n, m, it, q0, q_end) -> float:
    return bound_s(gi_flops(it, q0, q_end, n, m), gi_bytes(batch, n, m))


def k11_bound_s(batch, n, m, it, q0, q_end) -> float:
    return bound_s(fast_loop_flops(it, q0, q_end, n, m),
                   fast_loop_bytes(batch, n, m))


# kernel name substring -> the bound of one launch from (batch, n, m, it,
# q0, q_end); K1 is gi_fused_kernel (csrc/gi_kernel.cu), K11
# fast_loop_kernel (csrc/fast_loop.cu)
LOOP_KERNELS = {"gi_fused_kernel": k1_bound_s,
                "fast_loop_kernel": k11_bound_s}


def loop_kernel_of(name: str):
    """The LOOP_KERNELS key that a trace's kernel name holds, or None."""
    for key in LOOP_KERNELS:
        if key in name:
            return key
    return None


def roofline_pct(run, kernel: str):
    """100 x the summed bound of the traced calls over the device time of
    the kernels whose name holds ``kernel`` (a LOOP_KERNELS key) in the
    traced range; None where the trace shows no such kernel."""
    tr = run.trace
    if tr is None or not run.traced_counts:
        return None
    t_us = sum(min(e, tr.t1) - max(s, tr.t0)
               for ivs in tr.device.values() for s, e, name, _ in ivs
               if kernel in name and e > tr.t0 and s < tr.t1)
    if t_us <= 0:
        return None
    bound = sum(LOOP_KERNELS[kernel](c["batch"], c["n"], c["m"], c["it"],
                                     c["q0"], c["q_end"])
                for c in run.traced_counts)
    return 100.0 * bound / (t_us / 1e6)
