"""gi_iterations_mean: the result's GI iterations per lane, over every lane
of the window (a count, not a time). ``gi_iterations_mean.track``, the
same quantity in a trajectory cell, reads with this file."""

from qpbench import readers

read = readers.iterations_mean
