"""device_idle_pct: the share of the traced calls' host range in which the
first card ran no kernel, copy or set (the union of its intervals, as
``testing/profile_main.py`` takes it). The profiler widens the gaps, so it
is an upper bound. ``device_idle_pct.track``, the same quantity in a
trajectory cell, reads with this file."""

from qpbench import readers

read = readers.idle_pct
