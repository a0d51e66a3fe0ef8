"""The one general generator of traffic: a cell's calls from its mix's data.

A traffic mix is a JSON file under ``qpbench/traffic/`` with a ``pattern``
and its parameters; the configuration names its ``family`` and sizes. The
family (``families/<family>.py``, its ``draw``) draws one batch from the
run's seed on the run's first device; the pattern (``patterns/<pattern>.py``,
its ``batches``) turns the family's draws into the run's pool of calls:
(the batch the entry is handed, the benchmark's :class:`~qpbench.gen.QP` of
it). :class:`Feed` hands out each call's program inputs (made once at
set-up by the entry's ``prepare``) and the key of its problem, whose
benchmark form (:meth:`Feed.problem`) the judge and the reference read.
"""
from __future__ import annotations

from . import gen
from .loader import load_module


class Feed:
    """The calls of one run: ``next()`` gives (program inputs, key)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, entry):
        draw = load_module("families", cfg["family"]).draw
        pattern = load_module("patterns", traffic["pattern"])
        pool = pattern.batches(cfg, traffic, seed, device, draw)
        self._args = [entry.prepare(b) for b, _ in pool]
        self._problems = [p for _, p in pool]
        self.k = 0

    def next(self):
        """(program inputs, key) of the next call."""
        key = self.k % len(self._args)
        self.k += 1
        return self._args[key], key

    def problem(self, key) -> gen.QP:
        """The benchmark's own form of problem ``key``."""
        return self._problems[key]
