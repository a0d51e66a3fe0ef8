"""refine_device_ms: the card's busy time per traced call on the work the
program queued inside its ``jrlqp.refine`` spans, ms, read from the trace
(``qpbench/stages.py``): the f64 refinement. ``refine_device_ms.track``,
the same quantity in a trajectory cell, reads with this file."""

from qpbench import stages


def read(run):
    return stages.stage_device_ms(run, "refine")
