"""jrlqp_tpu_torch -- the batched Goldfarb-Idnani QP solver in PyTorch + CUDA.

A port of :mod:`jrlqp_tpu` (JAX/Pallas) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (``sm_90a``). Module names follow the JAX package
so each counterpart is easy to find. The package imports ``torch`` only; the
kernels are compiled from ``csrc/`` at first use on a CUDA tensor
(:mod:`jrlqp_tpu_torch.ops.cuda._build`), and CPU tensors run each kernel's
plain PyTorch version.

Main path: :func:`jrlqp_tpu_torch.solver.fast.solve_refined_kernel`, the
counterpart of ``jrlqp_tpu.solver.fast.solve_refined_pallas(...,
fused_init=True)``. Control-loop warm paths: ``solve_refined_warm_kernel``
(from activation hints, ``solve_refined_warm_pallas``) and
``solve_refined_kernel_carry`` with ``WarmCarry`` (operator reuse along a
trajectory, ``solve_refined_pallas_carry``). The f64 J/R engine: ``solve``
and ``solve_batch`` (:mod:`.solver.dense`), ``solve_warm`` and the rescue
``solve_refined_kernel_rescued`` (K3, then f64 for the failed lanes); the
compact-slot kernel K9 behind ``solve_refined_kernel_compact`` and the
tracing of :mod:`jrlqp_tpu_torch.utils`. Beside them: the closed-form box
solve ``solve_box``, the f32-then-f64 ``solve_mixed``, sharded solves over
a device mesh (:mod:`jrlqp_tpu_torch.parallel`), and the QPS reader and
Maros-Meszaros corpus runner (:mod:`jrlqp_tpu_torch.io`).
"""
import torch as _torch

# The GI dual step breaks under reduced-precision f32 products, and the f64
# refinement's f32 corrections lose accuracy with TF32: pin full f32 for
# matmuls and convolutions (counterpart of jrlqp_tpu/__init__.py:19-26).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .problems import (  # noqa: E402
    LeastSquareProblem,
    QPProblem,
    pad_problem,
    problem_from_numpy,
    result_to_numpy,
    stack_problems,
)
from .solver.box_single import solve_box  # noqa: E402
from .solver.dense import solve, solve_batch  # noqa: E402
from .solver.fast import (  # noqa: E402
    WarmCarry,
    solve_fast,
    solve_fast_warm,
    solve_refined_kernel,
    solve_refined_kernel_carry,
    solve_refined_kernel_compact,
    solve_refined_kernel_compacted,
    solve_refined_kernel_rescued,
    solve_refined_warm_kernel,
)
from .solver.mixed import solve_mixed  # noqa: E402
from .solver.state import GIResult, GIState  # noqa: E402
from .solver.warm_start import solve_warm  # noqa: E402
from .structured import GType, StructuredC, StructuredG, solve_structured  # noqa: E402
from .utils import (  # noqa: E402
    LogFlags,
    capture_kernel_trajectory,
    dump_matlab,
    no_retrace,
    solve_fast_traced,
    solve_traced,
)
from .types import ActivationStatus, SolverOptions, TerminationStatus  # noqa: E402
from .validation import inconsistent_mask, well_formed  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "QPProblem",
    "well_formed",
    "inconsistent_mask",
    "LeastSquareProblem",
    "pad_problem",
    "stack_problems",
    "problem_from_numpy",
    "result_to_numpy",
    "solve",
    "solve_batch",
    "solve_mixed",
    "solve_warm",
    "solve_box",
    "solve_fast",
    "solve_fast_warm",
    "solve_structured",
    "GType",
    "StructuredC",
    "StructuredG",
    "solve_refined_kernel_rescued",
    "solve_refined_kernel_compact",
    "solve_refined_kernel_compacted",
    "LogFlags",
    "solve_traced",
    "solve_fast_traced",
    "capture_kernel_trajectory",
    "dump_matlab",
    "no_retrace",
    "solve_refined_kernel",
    "solve_refined_warm_kernel",
    "solve_refined_kernel_carry",
    "WarmCarry",
    "GIResult",
    "GIState",
    "ActivationStatus",
    "TerminationStatus",
    "SolverOptions",
]
