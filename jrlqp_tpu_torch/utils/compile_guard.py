"""No-rebuild guard: the port's counterpart of
:mod:`jrlqp_tpu.utils.compile_guard`.

The JAX guard asserts that no jitted function compiles again inside a block
(compile_guard.py:18-40): one executable per padded shape serves every
solve. The port has one CUDA library whose kernels take their sizes at run
time, so its contract is that repeated solves, of one shape or of several,
build and load that library at most once per process. :func:`no_retrace`
asserts that nothing was built or loaded inside the block.
"""
from __future__ import annotations

import contextlib

from . import spans

__all__ = ["no_retrace"]


@contextlib.contextmanager
def no_retrace():
    """Context manager asserting that the block builds and loads no CUDA
    library::

        solve_refined_kernel(pb0, opt)     # warm up: the one build
        with no_retrace():
            for pb in batches:             # any shapes
                solve_refined_kernel(pb, opt)

    Raises AssertionError if the library was built or loaded inside it.
    """
    before = spans.counter("library.load")
    yield
    after = spans.counter("library.load")
    if after != before:
        raise AssertionError(
            f"the CUDA library was built or loaded inside a no_retrace "
            f"block: loads {before} -> {after}")
