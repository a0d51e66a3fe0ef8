"""Per-shard timelines of a sharded solve: when each shard's engine call and
each of its GI kernels ran, on a clock shared by every device.

    from jrlqp_tpu_torch.testing import shard_timeline
    with shard_timeline.record() as tl:
        solve_sharded(pbs, opt, mesh=mesh, engine="pallas", fused_init=True)
    tl.shards      # one dict per engine call, in order of start
    tl.overlap()   # how far the shards' kernels ran at the same time

While recording, ``parallel.mesh._solve_shard`` (one engine call on one
shard) and ``ops.cuda.gi_kernel._launch`` (every K1, K3, K4 and K9 launch)
are wrapped: on a CUDA device each records a CUDA event on its thread's
current stream before and after, so a span is the device's own time from
the work queued before it to the work queued after it; on the CPU the host
clock stands in. Each device's events are read against a zero event
recorded on it once every device is idle, and the zeros against each other
by the host clock at which they were recorded (the streams are idle then,
so an event lands within microseconds of its record). The kernel spans
belong to the engine call running on the same thread. Launch counts are
untouched: the wrappers call the real functions once each.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..ops.cuda import gi_kernel
from ..parallel import mesh as mesh_mod

__all__ = ["record", "Timeline"]


class _Clock:
    """Marks on one device, read in ms from the timeline's zero."""

    def __init__(self, dev: torch.device, t_host0: float):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.zero = torch.cuda.Event(enable_timing=True)
            self.offset_ms = 1e3 * (time.perf_counter() - t_host0)
            self.zero.record(torch.cuda.current_stream(dev))
        else:
            self.t_host0 = t_host0

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.dev))
        return ev

    def ms(self, mark) -> float:
        if not self.cuda:
            return 1e3 * (mark - self.t_host0)
        return self.offset_ms + self.zero.elapsed_time(mark)


class Timeline:
    """The spans of one recording: ``shards``, one dict per engine call
    (device, lanes, ``start_ms``, ``end_ms``, ``cpu_ms``, the CPU time of
    the thread that ran it, and ``kernels``, a list of [name, start_ms,
    end_ms]), in order of start."""

    def __init__(self):
        self._calls = []
        self.shards: list[dict] = []

    def overlap(self) -> dict:
        """The shards' kernels against each other: ``common_ms``, the time
        during which a kernel of every shard was running (0 when some two
        never ran together), ``concurrency``, the kernels' summed time over
        the span from the first start to the last end (1 for shards run one
        after another, the number of shards for shards run fully at once;
        None without kernels), and the same two for the engine calls
        (``calls_*``)."""
        def figures(spans):
            if not spans:
                return None, None
            span = max(e for _, e in spans) - min(s for s, _ in spans)
            common = max(0.0, min(e for _, e in spans)
                         - max(s for s, _ in spans))
            busy = sum(e - s for s, e in spans)
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
    local = threading.local()
    lock = threading.Lock()
    solve_shard, launch = mesh_mod._solve_shard, gi_kernel._launch

    def clock(dev):
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return clocks[str(dev)]

    def timed_solve_shard(pb, *args, **kw):
        c = clock(pb.G.device)
        call = {"device": str(c.dev), "lanes": pb.batch, "kernels": []}
        local.call = call
        start, cpu = c.mark(), time.thread_time()
        try:
            return solve_shard(pb, *args, **kw)
        finally:
            call["cpu_ms"] = 1e3 * (time.thread_time() - cpu)
            call["marks"] = (c, start, c.mark())
            local.call = None
            with lock:
                tl._calls.append(call)

    def timed_launch(entry, *args, **kw):
        c = clock(args[1][0].device)
        start = c.mark()
        out = launch(entry, *args, **kw)
        call = getattr(local, "call", None)
        if call is not None:
            call["kernels"].append((entry, c, start, c.mark()))
        return out

    mesh_mod._solve_shard, gi_kernel._launch = timed_solve_shard, timed_launch
    try:
        yield tl
    finally:
        mesh_mod._solve_shard, gi_kernel._launch = solve_shard, launch
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        for call in tl._calls:
            c, s, e = call.pop("marks")
            call["start_ms"], call["end_ms"] = c.ms(s), c.ms(e)
            call["kernels"] = [[name.removeprefix("jrlqp_"), kc.ms(ks),
                                kc.ms(ke)]
                               for name, kc, ks, ke in call["kernels"]]
        tl.shards = sorted(tl._calls, key=lambda sh: sh["start_ms"])
