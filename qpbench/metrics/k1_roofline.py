"""k1_roofline: K1's share of its roofline in the traced calls.

The bound of each traced call is max(FLOPs / 67 TFLOP/s, bytes / 3.35
TB/s) from ``qpbench/counts.py`` (the method's work at the unpadded sizes
from the call's own iteration and active counts, each input read once and
each output written once); the time is the device time of the kernels
named ``gi_fused_kernel`` (K1, ``csrc/gi_kernel.cu``) in the trace."""

from qpbench import counts

KERNEL = "gi_fused_kernel"


def read(run):
    return counts.roofline_pct(run, KERNEL)
