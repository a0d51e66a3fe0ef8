"""A short traced sub-window under ``torch.profiler``, reduced to intervals.

:func:`capture` runs a few calls under the profiler and returns a
:class:`Trace`: each device's kernel, copy and set intervals (with names),
the host range of the traced calls, and the host events (operators, Python
frames, CUDA runtime calls) that the idle-gap labels read. The interval
arithmetic (the union of intervals, as in
``jrlqp_tpu_torch/testing/profile_main.py`` and ``profile_sharded.py``) is
here; the per-layer metrics read a :class:`Trace`.

The profiler's own work widens the gaps between the device's intervals, so
an idle share read from a trace is an upper bound.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "python_function", "cuda_runtime", "user_annotation")
WINDOW = "qpbench_traced_calls"


@dataclasses.dataclass
class Trace:
    calls: int                 # calls inside the traced range
    t0: float                  # host range of the traced calls, us
    t1: float
    device: dict               # device index -> [(start, end, name, cat)]
    host: list                 # [(start, end, name, cat)]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self, dev) -> float:
        return sum(e - s for s, e in merged(self.clipped(dev))) / 1e6

    def clipped(self, dev) -> list:
        """Device ``dev``'s intervals clipped to the host range."""
        return [(max(s, self.t0), min(e, self.t1))
                for s, e, _, _ in self.device.get(dev, [])
                if e > self.t0 and s < self.t1]


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy, t0, t1) -> list:
    """(start, end) of each stretch of [t0, t1] that ``busy`` (merged
    intervals) leaves idle."""
    out, cur = [], t0
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


def capture(run_calls, calls: int, with_stack: bool = False) -> Trace:
    """Profile ``run_calls()``, which makes ``calls`` entry calls, each
    closed by a synchronize, and reduce the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, with_stack=with_stack) as p:
        with torch.profiler.record_function(WINDOW):
            run_calls()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce(events, calls)


def reduce(events, calls: int) -> Trace:
    """A :class:`Trace` from chrome-trace events."""
    rng = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    device, host = {}, []
    for e in events:
        cat = e.get("cat")
        if "dur" not in e:
            continue
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
              cat)
        if cat in DEVICE_CATS:
            dev = int(e.get("args", {}).get("device", 0))
            device.setdefault(dev, []).append(iv)
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append(iv)
    if rng:
        t0 = float(rng[0]["ts"])
        t1 = t0 + float(rng[0]["dur"])
    else:
        ivs = [iv for v in device.values() for iv in v] or host or [(0, 0)]
        t0, t1 = min(iv[0] for iv in ivs), max(iv[1] for iv in ivs)
    return Trace(calls=calls, t0=t0, t1=t1, device=device, host=host)


def top_device_ops(tr: Trace, k: int = 10) -> list:
    """[[name, seconds], ...] of the device operations that took most time
    in the traced range, summed over the devices."""
    by = {}
    for ivs in tr.device.values():
        for s, e, name, _ in ivs:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _innermost(host, t, pick) -> str | None:
    best = None
    for s, e, name, cat in host:
        if s <= t <= e and pick(name, cat):
            if best is None or e - s < best[1] - best[0]:
                best = (s, e, name)
    return best[2] if best else None


def _frame(name, cat):
    return cat == "python_function" and ("jrlqp_tpu_torch" in name
                                         or "qpbench" in name)


def _op(name, cat):
    return cat in ("cpu_op", "cuda_runtime")


def idle_gaps(tr: Trace, dev: int = 0, k: int = 10) -> list:
    """[[label, seconds], ...]: device ``dev``'s idle time in the traced
    range by what the host was doing, most first. A gap's label is the
    innermost Python frame of the program or the harness and the innermost
    operator or runtime call that the host ran at the gap's middle."""
    busy = merged(tr.clipped(dev))
    by = {}
    for s, e in gaps(busy, tr.t0, tr.t1):
        mid = (s + e) / 2
        frame = _innermost(tr.host, mid, _frame) or "no frame"
        op = _innermost(tr.host, mid, _op) or "no operator"
        label = f"{frame} | {op}"[:200]
        by[label] = by.get(label, 0.0) + (e - s) / 1e6
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
