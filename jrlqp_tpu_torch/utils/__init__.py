"""Observability and the no-rebuild guard (counterpart of
:mod:`jrlqp_tpu.utils`)."""
from .compile_guard import no_retrace
from .logger import (
    IterationTrace,
    LogFlags,
    capture_kernel_trajectory,
    dump_matlab,
    solve_fast_traced,
    solve_traced,
)

__all__ = ["no_retrace", "LogFlags", "IterationTrace", "solve_traced",
           "solve_fast_traced", "capture_kernel_trajectory", "dump_matlab"]
