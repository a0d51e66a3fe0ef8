"""solves_per_s: lanes solved in the window over the window's summed call
time (every call, none dropped), for the cells of independent batches."""

from qpbench import readers

read = readers.rate
