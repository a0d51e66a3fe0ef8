"""Benchmark harness (reference: benchmarks/ google-benchmark suite); the
exports of ``jrlqp_tpu/bench/__init__.py``."""
from .harness import (
    BenchResult,
    bench_active_sweep,
    bench_box_single,
    bench_decompositions,
    bench_scaling,
    bench_size_sweep,
    bench_structured_ik,
    bench_warm_start_trajectory,
    time_batch,
)

__all__ = [
    "BenchResult",
    "bench_active_sweep",
    "bench_decompositions",
    "bench_box_single",
    "bench_scaling",
    "bench_size_sweep",
    "bench_structured_ik",
    "bench_warm_start_trajectory",
    "time_batch",
]
