"""Per-shard timelines of a sharded solve: when each shard's engine call and
each of its GI loops ran, on a clock shared by every device.

    from jrlqp_tpu_torch.testing import shard_timeline
    with shard_timeline.record() as tl:
        solve_sharded(pbs, opt, mesh=mesh, engine="pallas", fused_init=True)
    tl.shards      # one dict per engine call, in order of start
    tl.overlap()   # how far the shards' loops ran at the same time
    tl.moves       # each worker's moves of its shards, and the gathers

It reads the program's own spans (:mod:`jrlqp_tpu_torch.utils.spans`),
recorded while the block runs: each ``jrlqp.shard`` span of
``parallel/mesh.py`` (one engine call on one shard, on its worker thread),
the ``jrlqp.loop`` spans inside it (the loop kernel's wrapper: K1, K3,
K4, K9, K10 or K11, or a plain version on the CPU), and the
``jrlqp.scatter`` and ``jrlqp.gather`` spans. On a CUDA device a
span is a pair of CUDA events on its thread's current stream, so it is the
device's own time from the work queued before it to the work queued after
it; on the CPU the host clock stands in. Each device's events are read
against a zero event recorded on it once every device is idle, and the
zeros against each other by the host clock at which they were recorded
(the streams are idle then, so an event lands within microseconds of its
record). Nothing of the program is wrapped; launch counts are untouched.
"""
from __future__ import annotations

import contextlib
import time

import torch

from ..utils import spans

__all__ = ["record", "Timeline"]


class _Clock:
    """Spans on one device, read in ms from the timeline's zero."""

    def __init__(self, dev: torch.device, t_host0: float):
        self.dev = dev
        self.t_host0 = t_host0
        if dev.type == "cuda":
            self.zero = torch.cuda.Event(enable_timing=True)
            self.offset_ms = 1e3 * (time.perf_counter() - t_host0)
            self.zero.record(torch.cuda.current_stream(dev))

    def interval(self, sp: spans.Span) -> tuple[float, float]:
        """(start_ms, end_ms) of the span ``sp``."""
        if sp.events is None:
            return (1e3 * (sp.host0 - self.t_host0),
                    1e3 * (sp.host1 - self.t_host0))
        sp.events[1].synchronize()
        return tuple(self.offset_ms + self.zero.elapsed_time(ev)
                     for ev in sp.events)


class Timeline:
    """The spans of one recording: ``shards``, one dict per engine call
    (device, lanes, ``start_ms``, ``end_ms`` and ``kernels``, a list of
    [name, start_ms, end_ms] of its GI loops), in order of start; and
    ``moves``, one dict per worker's moves of its shards (``scatter``) and
    per gather of the results (``gather``): stage, device, ``start_ms``,
    ``end_ms``."""

    def __init__(self):
        self.shards: list[dict] = []
        self.moves: list[dict] = []

    def overlap(self) -> dict:
        """The shards' loops against each other: ``common_ms``, the time
        during which a loop of every shard was running (0 when some two
        never ran together), ``concurrency``, the loops' summed time over
        the span from the first start to the last end (1 for shards run one
        after another, the number of shards for shards run fully at once;
        None without loops), and the same two for the engine calls
        (``calls_*``)."""
        def figures(spans_):
            if not spans_:
                return None, None
            span = max(e for _, e in spans_) - min(s for s, _ in spans_)
            common = max(0.0, min(e for _, e in spans_)
                         - max(s for s, _ in spans_))
            busy = sum(e - s for s, e in spans_)
            return common, (busy / span if span > 0 else 1.0)

        kern = [(min(k[1] for k in sh["kernels"]),
                 max(k[2] for k in sh["kernels"]))
                for sh in self.shards if sh["kernels"]]
        calls = [(sh["start_ms"], sh["end_ms"]) for sh in self.shards]
        common, conc = figures(kern)
        c_common, c_conc = figures(calls)
        return {"shards": len(self.shards),
                "shards_with_kernels": len(kern), "common_ms": common,
                "concurrency": conc, "calls_common_ms": c_common,
                "calls_concurrency": c_conc}


def _within(sp: spans.Span, outer: spans.Span) -> bool:
    p = sp.parent
    while p is not None and p is not outer:
        p = p.parent
    return p is outer


@contextlib.contextmanager
def record(devices=None):
    """Record the sharded solves run inside the block (see the module's
    docstring). ``devices``: the devices to put on the shared clock, by
    default the CPU and every CUDA device."""
    if devices is None:
        devices = [torch.device("cpu")] + (
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if torch.cuda.is_available() else [])
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    clocks = {str(d): _Clock(d, t0) for d in devices}
    tl = Timeline()
    with spans.recording():
        yield tl
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    for call in spans.recorded():
        if call[0].host0 < t0:
            continue
        for sh in (s for s in call if s.name == "jrlqp.shard"):
            clock = clocks[str(sh.device)]
            start, end = clock.interval(sh)
            tl.shards.append({
                "device": str(sh.device), "lanes": sh.lanes,
                "start_ms": start, "end_ms": end,
                "kernels": [["loop", *clocks[str(k.device)].interval(k)]
                            for k in call if k.name == "jrlqp.loop"
                            and _within(k, sh)]})
        for mv in (s for s in call
                   if s.name in ("jrlqp.scatter", "jrlqp.gather")):
            start, end = clocks[str(mv.device)].interval(mv)
            tl.moves.append({"stage": mv.stage, "device": str(mv.device),
                             "start_ms": start, "end_ms": end})
    tl.shards.sort(key=lambda sh: sh["start_ms"])
    tl.moves.sort(key=lambda mv: mv["start_ms"])
