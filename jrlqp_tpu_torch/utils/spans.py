"""Spans and counters of the port: where a call's time goes, by stage, on
the host and on the card, and how often the program launched a kernel or
waited on the card.

**Spans.** Every public entry point opens a span ``jrlqp.call``: the root
of a call where no span is open on the thread, else a child of the open
one (an entry point that another calls, such as ``_solve_shard`` ->
``solve_refined_kernel``). Inside it the stage spans mark the layers:

- ``jrlqp.prepare``: the problem in the kernels' layout (the f32 copy,
  padding; the dense problem of a structured batch);
- ``jrlqp.factor``: the structured factorization, H = G^-1 (K5+K6, K7+K8);
- ``jrlqp.init``: a torch init (cold replay, warm, carry and its
  deactivations);
- ``jrlqp.loop``: the GI loop (a kernel's wrapper, or its plain version);
- ``jrlqp.remap``: the kernels' layout back to the library's;
- ``jrlqp.refine``: the f64 refinement;
- ``jrlqp.scatter``, ``jrlqp.shard``, ``jrlqp.gather``: a sharded solve's
  moves, each shard's solve (on its worker thread, a child of the
  caller's span) and the gather;
- ``jrlqp.sync.<reason>``: a deliberate host read of device data, the host
  waiting on the card (:func:`sync`).

A span holds its name, its parent, the id of its root's call and the host
clock at start and end (``time.perf_counter``). The spans of the last
:data:`CALLS_KEPT` root calls are kept in memory; :func:`calls` sums them
by stage, :func:`recorded` returns them.

Spans record only while tracing is on: while a ``torch.profiler`` session
records, or inside :func:`recording`. Off, :func:`span` reads two flags and
returns a shared no-op context manager: no torch call, no lock, nothing
allocated or recorded. Under a profiler a span enters
``torch.profiler.record_function(name)`` and nothing more: it is a
``user_annotation`` event of the chrome trace, on the kernels' clock, and
a stage's device time is read from the trace (the kernels its host span
launched). Inside :func:`recording` a span also records a device span: a
CUDA event pair on the current stream of its card (the host clock on the
CPU), read once the events have completed.

**Counters** are always on: :func:`count` adds to a named count under one
lock, :func:`counts` reads them, :func:`reset` sets them back. The
kernels' wrappers count ``launch.K1`` ... ``launch.K14`` and
``launch.chol_inv_b``; ``ops/cuda/_build`` counts ``library.load``. A
counter is read by its name alone: ``counter("launch.K1")``.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "call", "sync", "current", "recording", "calls",
           "recorded", "clear", "count", "counter", "counts", "reset",
           "Span", "CALL", "CALLS_KEPT"]

CALL = "jrlqp.call"
SYNC = "jrlqp.sync."
CALLS_KEPT = 64

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_recording = 0                 # depth of open recording() blocks
_ids = itertools.count()
_calls: collections.deque = collections.deque(maxlen=CALLS_KEPT)
_counts: dict = {}


class Span:
    """One span (see the module's docstring). ``parent`` is the enclosing
    span, None for a root; ``call`` the id of its root's call; ``host0``
    and ``host1`` the host clock in s; ``device`` the card (or the CPU)
    whose current stream its events, if any, were recorded on; ``events``
    the CUDA event pair (inside :func:`recording` alone); ``lanes`` the
    leading size of the tensor that named it (None where a device did, or
    the parent's card); ``entry`` the entry point of a ``jrlqp.call``
    span."""

    __slots__ = ("name", "entry", "parent", "call", "device", "lanes",
                 "thread", "host0", "host1", "events", "_where", "_rf",
                 "_device_ms", "_rec")

    def __init__(self, name: str, where=None, parent=None, entry=None):
        self.name, self.entry, self.parent = name, entry, parent
        self._where = where
        self.call = self.device = self.lanes = self.host1 = None
        self.events = self._device_ms = self._rf = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = self.parent if self.parent is not None else (
            stack[-1] if stack else None)
        self.parent = parent
        where = self._where
        self._where = None
        if where is None:
            self.device = (parent.device if parent is not None
                           else torch.device("cpu"))
        elif isinstance(where, torch.device):
            self.device = where
        else:
            self.device, self.lanes = where.device, where.shape[0]
        self.thread = threading.get_ident()
        if parent is None:
            self._rec = _Call(next(_ids), self)
            self.call = self._rec.id
            with _lock:
                _calls.append(self._rec)
        else:
            self._rec, self.call = parent._rec, parent.call
            with _lock:
                self._rec.spans.append(self)
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if _recording and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        stack.append(self)
        self.host0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.host1 = time.perf_counter()
        _local.stack.pop()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False

    @property
    def host_ms(self) -> float:
        return 1e3 * (self.host1 - self.host0)

    @property
    def device_ms(self) -> float | None:
        """The device span in ms: the card's time from the work queued
        before the span to the work queued at its end (waits for the
        events); the host clock on the CPU; None on a card without events
        (a span recorded under a profiler alone)."""
        if self._device_ms is None:
            if self.events is None:
                if self.device.type == "cuda":
                    return None
                self._device_ms = self.host_ms
            else:
                self.events[1].synchronize()
                self._device_ms = self.events[0].elapsed_time(self.events[1])
        return self._device_ms

    @property
    def stage(self) -> str:
        return self.name.removeprefix("jrlqp.")

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, call={self.call}, parent="
                f"{self.parent.name if self.parent else None!r})")


class _Call:
    __slots__ = ("id", "root", "spans")

    def __init__(self, id_: int, root: Span):
        self.id, self.root, self.spans = id_, root, [root]


def span(name: str, where=None, parent: Span | None = None):
    """A context manager: the span ``name`` while tracing is on, a shared
    no-op one while it is off. ``where``, a tensor or a device, gives the
    card whose current stream times it (by default the parent's);
    ``parent`` the span it belongs to (by default the one open on this
    thread: pass it where a worker thread works for another's span)."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name, where, parent)


def call(entry: str, where):
    """The span ``jrlqp.call`` of the entry point ``entry`` on the card of
    ``where`` (a tensor or a device): a root where no span is open on this
    thread, else a child of the open one."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return Span(CALL, where, None, entry)


def sync(reason: str):
    """The span ``jrlqp.sync.<reason>`` around a deliberate host read of
    device data (a shared no-op while tracing is off)::

        with spans.sync("replay"):
            go = bool(active.any())
    """
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return Span(SYNC + reason)


def current() -> Span | None:
    """The span open on this thread (None while tracing is off), for a
    worker thread's spans to name as their parent."""
    if not (_recording or _profiler._is_profiler_enabled):
        return None
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def recording():
    """Tracing on inside the block, with no profiler needed."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def recorded() -> list:
    """The spans of each kept root call whose root has ended, oldest call
    first, each call's spans in order of start (the root first)."""
    with _lock:
        kept = list(_calls)
    return [list(c.spans) for c in kept if c.root.host1 is not None]


def calls() -> list:
    """Each kept root call, oldest first: ``call`` (its id), ``entry``,
    ``host_ms`` and ``device_ms`` of the root, ``syncs`` (its
    ``jrlqp.sync.*`` spans) and ``stages``: for each span name below the
    root, without ``jrlqp.``, the summed ``host_ms`` and ``device_ms`` and
    the number ``n`` of such spans. A nested entry point's ``jrlqp.call``
    is not a stage; its stages count in the root's. Reading the device
    spans waits for their events; a call recorded under a profiler alone
    has none on a card, and its ``device_ms`` are None."""
    out = []
    for sp in recorded():
        root = sp[0]
        stages: dict = {}
        for s in sp[1:]:
            if s.name == CALL:
                continue
            st = stages.setdefault(s.stage, {"host_ms": 0.0,
                                             "device_ms": 0.0, "n": 0})
            st["host_ms"] += s.host_ms
            ms = s.device_ms
            st["device_ms"] = (None if ms is None or st["device_ms"] is None
                               else st["device_ms"] + ms)
            st["n"] += 1
        out.append({"call": root.call, "entry": root.entry,
                    "host_ms": root.host_ms, "device_ms": root.device_ms,
                    "syncs": sum(s.name.startswith(SYNC) for s in sp),
                    "stages": stages})
    return out


def clear() -> None:
    """Drop the kept calls."""
    with _lock:
        _calls.clear()


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + k


def counter(name: str) -> int:
    """The counter ``name`` (0 if never counted)."""
    with _lock:
        return _counts.get(name, 0)


def counts(prefix: str = "") -> dict:
    """The counters named ``prefix`` or below it (``prefix.*``); all of
    them for ``""``."""
    with _lock:
        return {k: v for k, v in _counts.items() if _under(k, prefix)}


def reset(prefix: str = "") -> None:
    """Set the counters named ``prefix`` or below it back to 0: ``reset(
    "launch")`` every launch count, ``reset("launch.K1")`` K1's alone,
    ``reset()`` all."""
    with _lock:
        for k in [k for k in _counts if _under(k, prefix)]:
            del _counts[k]


def _under(name: str, prefix: str) -> bool:
    return not prefix or name == prefix or name.startswith(prefix + ".")
