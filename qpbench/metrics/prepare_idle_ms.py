"""prepare_idle_ms: the first card's idle time per traced call while the
host was inside the program's ``jrlqp.prepare`` stage (the idle gaps of
``device_idle_pct`` whose midpoint lies inside such a span), ms. The
profiler widens the gaps, so it is an upper bound. ``prepare_idle_ms.track``,
the same quantity in a trajectory cell, reads with this file."""

from qpbench import stages


def read(run):
    return stages.idle_in(run, "prepare")
