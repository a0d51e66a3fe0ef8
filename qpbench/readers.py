"""What the metric files read from a run, one function per quantity, so
that one quantity under two names (``solves_per_s`` and
``step_solves_per_s``) reads the same way. Each returns None where the run
has nothing to read."""
from __future__ import annotations

import statistics

from . import counts


def rate(run):
    """Lanes solved in the window over the window's summed call time."""
    if not run.call_s:
        return None
    return sum(run.call_lanes) / sum(run.call_s)


def p95_ms(run):
    """The 95th percentile of every call's time in the window, ms."""
    if len(run.call_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.call_s, n=100,
                                      method="inclusive")[94]


def iterations_mean(run):
    """The result's GI iterations per lane over the window."""
    if not run.attempted:
        return None
    return run.iterations / run.attempted


def nonloop_ms(run):
    """Device time per traced call of every kernel and copy that is not a
    GI loop kernel (``counts.LOOP_KERNELS``), clipped to the traced range."""
    tr = run.trace
    if tr is None or not tr.device or not tr.calls:
        return None
    total = sum(min(e, tr.t1) - max(s, tr.t0)
                for ivs in tr.device.values() for s, e, name, _ in ivs
                if counts.loop_kernel_of(name) is None
                and e > tr.t0 and s < tr.t1)
    return total / 1e3 / tr.calls


def idle_pct(run):
    """The first card's idle share of the traced calls' host range, %."""
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(min(tr.device)) / tr.window_s)
