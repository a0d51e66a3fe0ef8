"""k11_roofline: K11's share of its roofline in the traced calls.

The bound of each traced call is max(FLOPs / 67 TFLOP/s, bytes / 3.35
TB/s) from ``qpbench/counts.py`` (``fast_loop_flops`` / ``fast_loop_bytes``
at the unpadded sizes from the call's own iteration and active counts);
the time is the device time of the kernels named ``fast_loop_kernel`` (K11,
``csrc/fast_loop.cu``) in the trace."""

from qpbench import counts

KERNEL = "fast_loop_kernel"


def read(run):
    return counts.roofline_pct(run, KERNEL)
