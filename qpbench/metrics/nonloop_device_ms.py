"""nonloop_device_ms: device time per traced call of every kernel and copy
that is not a GI loop kernel: preparation, the torch inits, the structured
factorization, the remap and the refinement. ``nonloop_device_ms.track``,
the same quantity in a trajectory cell, reads with this file."""

from qpbench import readers

read = readers.nonloop_ms
