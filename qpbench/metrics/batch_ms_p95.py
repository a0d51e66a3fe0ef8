"""batch_ms_p95: the 95th percentile of every call's time in the window,
for the cells of independent batches (a call is one batch)."""

from qpbench import readers

read = readers.p95_ms
