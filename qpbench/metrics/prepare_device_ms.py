"""prepare_device_ms: the card's busy time per traced call on the work the
program queued inside its ``jrlqp.prepare`` spans, ms, read from the trace
(``qpbench/stages.py``): the problem in the kernels' layout, that is the
f32 copy and padding of a dense batch, or the dense problem of a structured
batch and its f32 copy. ``prepare_device_ms.track``, the same quantity in a
trajectory cell, reads with this file."""

from qpbench import stages


def read(run):
    return stages.stage_device_ms(run, "prepare")
