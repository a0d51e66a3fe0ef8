"""Structured linear algebra and the structured solvers, batched
(counterpart of :mod:`jrlqp_tpu.structured`): the fast solver on the block
kernels and the J/R ``solve_structured`` on the dense engine."""
from .blocks import (
    block_arrow_l_solve,
    block_arrow_llt,
    block_arrow_lt_solve,
    block_arrow_to_dense,
    tri_block_diag_llt,
    tri_block_l_solve,
    tri_block_lt_solve,
    tri_block_to_dense,
)
from .containers import (
    GType,
    StructuredC,
    StructuredG,
    StructuredGFactor,
    structured_from_numpy,
)
from .solver import (
    init_state_structured,
    solve_structured,
    solve_structured_fast,
    solve_structured_fast_batch,
    solve_structured_fast_carry,
    structured_hooks,
    structured_qp_problem,
)

__all__ = [
    "GType",
    "StructuredC",
    "StructuredG",
    "StructuredGFactor",
    "structured_from_numpy",
    "solve_structured",
    "structured_hooks",
    "init_state_structured",
    "solve_structured_fast",
    "solve_structured_fast_batch",
    "solve_structured_fast_carry",
    "structured_qp_problem",
    "tri_block_diag_llt",
    "tri_block_l_solve",
    "tri_block_lt_solve",
    "tri_block_to_dense",
    "block_arrow_llt",
    "block_arrow_l_solve",
    "block_arrow_lt_solve",
    "block_arrow_to_dense",
]
