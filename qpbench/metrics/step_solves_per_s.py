"""step_solves_per_s: lanes solved in the window over the window's summed
call time, for a trajectory cell (each call one warm control step)."""

from qpbench import readers

read = readers.rate
