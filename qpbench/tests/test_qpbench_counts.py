"""The frozen FLOP and byte counts against hand counts, the idle
arithmetic on synthetic intervals, and the readers that use them."""
from __future__ import annotations

import types

import numpy as np
import pytest

from qpbench import counts, harness, trace
from qpbench.loader import load_module


def test_k1_counts_by_hand():
    # two lanes at n=2, m=3: 4 and 2 iterations from q0=0 to q_end=2, 1
    it, q0, q_end = np.array([4, 2]), np.array([0, 0]), np.array([2, 1])
    n, m = 2, 3
    per_it = 2 * m * n + 4 * n * n                       # 28
    q_sum = np.array([4 * (0 + 2 - 1) / 2, 2 * (0 + 1 - 1) / 2])  # 2, 0
    prologue = n ** 3 + 2 * n * n                         # 16
    want = (4 * per_it + 4 * n * q_sum[0] + prologue
            + 2 * per_it + 4 * n * q_sum[1] + prologue)
    assert counts.gi_flops(it, q0, q_end, n, m) == want == 216
    # problem 4+6+6+4, a 2, outputs 8+8+3+9 words, 4 bytes, 2 lanes
    assert counts.gi_bytes(2, n, m) == 4 * 2 * (20 + 2 + 28) == 400


def test_k11_counts_by_hand():
    # one lane, n=3, m=2: 5 iterations from q0=1 to q_end=2 (3 adds, 2
    # removals, mean q 1.5)
    n, m = 3, 2
    per_add = 2 * m * n + 4 * n * n + 4 * 1.5 * n          # 12 + 36 + 18
    per_remove = 6 * n * n + 6 * 1.5 * n                   # 54 + 27
    want = 3 * per_add + 2 * per_remove
    assert counts.fast_loop_flops([5], [1], [2], n, m) == want == 360
    problem = 4 * (9 + 6 + 4 + 6 + 1)
    state = 4 * (18 + 6 + 2) + 4 * (2 + 6 + 6)
    assert counts.fast_loop_bytes(1, n, m) == problem + 2 * state == 424


def test_bound_takes_the_larger_time():
    assert counts.bound_s(67e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_union_and_gaps():
    busy = trace.merged([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert busy == [[0, 3], [5, 9]]
    assert trace.gaps(busy, -1, 12) == [(-1, 0), (3, 5), (9, 12)]
    assert trace.gaps([], 0, 4) == [(0, 4)]


def _events():
    """A chrome trace of one traced range [100, 200] us: two cards, a loop
    kernel and a copy on card 0, one kernel on card 1, host frames."""
    return [
        {"cat": "user_annotation", "name": trace.WINDOW, "ts": 100,
         "dur": 100},
        {"cat": "kernel", "name": "void gi_fused_kernel(float*)", "ts": 110,
         "dur": 40, "args": {"device": 0}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 140, "dur": 20,
         "args": {"device": 0}},
        {"cat": "kernel", "name": "elementwise", "ts": 180, "dur": 30,
         "args": {"device": 0}},
        {"cat": "kernel", "name": "void gi_fused_kernel(float*)", "ts": 150,
         "dur": 25, "args": {"device": 1}},
        {"cat": "python_function", "name":
         "jrlqp_tpu_torch/solver/fast.py(464): _deactivate_negative_u",
         "ts": 158, "dur": 24},
        {"cat": "cpu_op", "name": "aten::is_nonzero", "ts": 165, "dur": 10},
        {"cat": "cpu_op", "name": "aten::outer", "ts": 100, "dur": 100},
    ]


def test_trace_reduction_and_idle():
    tr = trace.reduce(_events(), calls=2)
    assert (tr.t0, tr.t1, tr.window_s) == (100, 200, 100e-6)
    # card 0: [110, 160] and [180, 200] inside the range
    assert tr.busy_s(0) == pytest.approx(70e-6)
    assert tr.busy_s(1) == pytest.approx(25e-6)
    gaps = dict(trace.idle_gaps(tr))
    assert gaps == pytest.approx({
        "no frame | aten::outer": 10e-6,
        "jrlqp_tpu_torch/solver/fast.py(464): _deactivate_negative_u"
        " | aten::is_nonzero": 20e-6})
    ops = dict(trace.top_device_ops(tr))
    assert ops["void gi_fused_kernel(float*)"] == pytest.approx(65e-6)


def _run(tr, **kw):
    base = dict(setup_s=1.0, call_s=[0.5, 0.25, 0.25],
                call_lanes=[10, 10, 10], iterations=60, failed=0)
    base.update(kw)
    return harness.Run(trace=tr, **base)


def test_readers_on_a_synthetic_trace():
    tr = trace.reduce(_events(), calls=2)
    counts_ = [dict(batch=1, n=2, m=3, it=np.array([4]), q0=np.array([0]),
                    q_end=np.array([2]))] * 2
    run = _run(tr, traced_counts=counts_)
    bound = 2 * counts.k1_bound_s(1, 2, 3, [4], [0], [2])
    assert load_module("metrics", "k1_roofline").read(run) == pytest.approx(
        100 * bound / 65e-6)
    assert load_module("metrics", "k11_roofline").read(run) is None
    # card 0's copy (20 us) and elementwise (20 us inside) and card 1's
    # nothing else: 40 us over 2 calls
    assert load_module("metrics", "nonloop_device_ms").read(run) == \
        pytest.approx(0.02)
    assert load_module("metrics", "device_idle_pct").read(run) == \
        pytest.approx(30.0)
    assert load_module("metrics", "solves_per_s").read(run) == 30.0
    assert load_module("metrics", "gi_iterations_mean").read(run) == 2.0
    assert load_module("metrics", "batch_ms_p95").read(run) == \
        pytest.approx(475.0)
    # a quantity split by the end-to-end metric it moves reads the same
    for name in ("device_idle_pct", "gi_iterations_mean",
                 "nonloop_device_ms"):
        assert load_module("metrics", f"{name}.track").read(run) == \
            load_module("metrics", name).read(run)


def test_readers_without_a_trace_read_nothing():
    run = _run(None)
    for name in ("k1_roofline", "k11_roofline", "nonloop_device_ms",
                 "device_idle_pct"):
        assert load_module("metrics", name).read(run) is None
    empty = types.SimpleNamespace(trace=trace.reduce([], 1), traced_counts=[])
    assert counts.roofline_pct(empty, "gi_fused_kernel") is None
