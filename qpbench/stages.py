"""What the metric files read of the program's own spans: its ``jrlqp.*``
spans in the profiler's trace (``user_annotation`` events of the traced
sub-window's host events, on the kernels' clock).

A stage's device time is the card's busy time on the work that the host
queued inside the stage's spans. The trace keeps no link from a device op
to the runtime call that queued it, but one stream runs its ops in the
order they were queued: the n-th launching runtime call of the traced
range (a kernel launch, an async copy or set) queued its n-th device op.
Where the counts differ (an op queued before the range, a record the
trace lost), the two sequences are aligned by kind, a kernel to a kernel
launch and a copy to a copy. The host's and the card's clocks in the trace
may differ by tens of microseconds, so no pairing leans on them. A device
op runs after its launch, often while the host is in a later stage (the
GI loop's kernel runs while the host queues the refinement), so a stage's
time is read by its launches, not by the host's clock.

The traced sub-window is the only one a stage is read from: the later
capture with Python frames is a trace of its own. A program without spans
(an older one) has no ``jrlqp.*`` events: each reader then returns None."""
from __future__ import annotations

from . import trace

SYNC = "jrlqp.sync."
# the runtime calls that queue one device op each on the stream, and the
# kind of that op
KINDS = {"cudaLaunchKernel": "kernel", "cudaLaunchKernelExC": "kernel",
         "cudaLaunchCooperativeKernel": "kernel",
         "cudaMemcpyAsync": "gpu_memcpy", "cudaMemcpy": "gpu_memcpy",
         "cudaMemcpy2DAsync": "gpu_memcpy", "cudaMemsetAsync": "gpu_memset",
         "cudaMemset": "gpu_memset"}


def _annotations(run, match) -> list:
    """(start, end) of the traced range's ``user_annotation`` events whose
    name ``match`` accepts."""
    tr = run.trace
    return [(s, e) for s, e, name, cat in tr.host
            if cat == "user_annotation" and match(name)
            and s >= tr.t0 and e <= tr.t1]


def _stage(run, stage: str) -> list:
    """The merged host spans of ``jrlqp.<stage>`` in the traced range."""
    name = f"jrlqp.{stage}"
    return trace.merged(_annotations(run, lambda n: n == name))


def _inside(t: float, spans: list) -> bool:
    return any(a <= t <= b for a, b in spans)


def launched(run):
    """Each device op of the first card that ran in the traced range, with
    the host time of the runtime call that queued it: [(launch, start,
    end)], paired in order, or where the counts differ by
    :func:`_aligned`. None without the card's intervals."""
    tr = run.trace
    if tr is None or not tr.device or not tr.calls:
        return None
    ops = sorted((s, e, cat) for s, e, _, cat in tr.device[min(tr.device)]
                 if tr.t0 <= s <= tr.t1)
    calls = sorted((s, KINDS[name]) for s, _, name, cat in tr.host
                   if cat == "cuda_runtime" and name in KINDS
                   and tr.t0 <= s <= tr.t1)
    if not ops:
        return None
    pairs = (zip(calls, ops) if len(calls) == len(ops)
             else _aligned(calls, ops))
    return [(t, s, e) for (t, _), (s, e, _) in pairs]


def _aligned(calls: list, ops: list, slack: int = 16) -> list:
    """The launches ``calls`` [(time, kind)] and the ops ``ops`` [(start,
    end, kind)] paired in order, each with one of its own kind, as many as
    can be (the longest common subsequence of their kinds, within
    ``slack`` places of the offset their counts differ by); the rest is
    left out."""
    n, m = len(calls), len(ops)
    lo, hi = min(0, m - n) - slack, max(0, m - n) + slack
    # best[i][d]: most pairs among calls[:i] and ops[:i + lo + d]
    width = hi - lo + 1
    best = [[0] * width for _ in range(n + 1)]
    for i in range(n + 1):
        for d in range(width):
            j = i + lo + d
            if j < 0 or j > m or (i == 0 and j == 0):
                continue
            v = 0
            if i and d + 1 < width:
                v = best[i - 1][d + 1]              # calls[i - 1] left out
            if j and d:
                v = max(v, best[i][d - 1])          # ops[j - 1] left out
            if i and j and calls[i - 1][1] == ops[j - 1][2]:
                v = max(v, best[i - 1][d] + 1)
            best[i][d] = v
    out, i, d = [], n, m - n - lo
    while i > 0 and i + lo + d > 0:
        j = i + lo + d
        if j and calls[i - 1][1] == ops[j - 1][2] \
                and best[i][d] == best[i - 1][d] + 1:
            out.append((calls[i - 1], ops[j - 1]))
            i -= 1
        elif i and d + 1 < width and best[i][d] == best[i - 1][d + 1]:
            i, d = i - 1, d + 1
        else:
            d -= 1
    return out[::-1]


def stage_device_ms(run, stage: str):
    """The card's busy time per traced call on the ops queued inside a
    ``jrlqp.<stage>`` span (the union of their intervals), ms; None without
    such spans or without the card's intervals."""
    if run.trace is None:
        return None
    inside = _stage(run, stage)
    ops = launched(run) if inside else None
    if ops is None:
        return None
    mine = trace.merged((s, e) for t, s, e in ops if _inside(t, inside))
    return sum(e - s for s, e in mine) / 1e3 / run.trace.calls


def host_syncs(run):
    """The ``jrlqp.sync.*`` spans in the traced range, per traced call;
    None where the trace holds no span of the program."""
    if run.trace is None or not run.trace.calls:
        return None
    if not _annotations(run, lambda n: n.startswith("jrlqp.")):
        return None
    syncs = _annotations(run, lambda n: n.startswith(SYNC))
    return len(syncs) / run.trace.calls


def idle_in(run, stage: str):
    """The first card's idle time in the traced range while the host was
    inside a ``jrlqp.<stage>`` span (each idle gap counted where its
    midpoint lies inside one), ms per traced call; None without the card's
    intervals or without such spans."""
    tr = run.trace
    if tr is None or not tr.device or not tr.calls:
        return None
    inside = _stage(run, stage)
    if not inside:
        return None
    idle = 0.0
    for s, e in trace.gaps(trace.merged(tr.clipped(min(tr.device))),
                           tr.t0, tr.t1):
        if _inside((s + e) / 2, inside):
            idle += e - s
    return idle / 1e3 / tr.calls
