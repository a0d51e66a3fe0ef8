"""Observability and the no-rebuild guard (counterpart of
:mod:`jrlqp_tpu.utils`): the spans and counters of the port
(:mod:`.spans`), the iteration logger (:mod:`.logger`) and
:func:`no_retrace`.

The logger's names are imported at first use: the kernels' wrappers import
:mod:`.spans`, and the logger imports the wrappers."""
from . import spans
from .compile_guard import no_retrace

_LOGGER = ("LogFlags", "IterationTrace", "solve_traced", "solve_fast_traced",
           "capture_kernel_trajectory", "dump_matlab")

__all__ = ["spans", "no_retrace", *_LOGGER]


def __getattr__(name):
    if name in _LOGGER:
        from . import logger

        return getattr(logger, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
