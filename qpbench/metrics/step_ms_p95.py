"""step_ms_p95: the 95th percentile of every call's time in the window, for
a trajectory cell (a call is one warm control step)."""

from qpbench import readers

read = readers.p95_ms
