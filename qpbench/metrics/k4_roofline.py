"""k4_roofline: K4's share of its roofline in the traced warm steps.

The bound of each traced call is max(FLOPs / 67 TFLOP/s, bytes / 3.35
TB/s) from ``qpbench/counts_k4.py`` (chip_smoke's ``k4_bound``: the
problem, a, the carried K = [H | N*^T], status and aorder read once, the
outputs written once, the closed form and the call's own iterations); the
time is the device time of the kernels named ``gi_warm_kernel`` (K4,
``csrc/gi_kernel.cu``) in the trace. K4 binds on bytes, so the carry's
active count at entry, which the run's counts lack, does not move it."""

from qpbench import counts_k4


def read(run):
    return counts_k4.roofline_pct(run)
