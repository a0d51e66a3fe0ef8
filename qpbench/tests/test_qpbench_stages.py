"""The metrics that read the program's spans (``qpbench/stages.py``): a
tiny traced run on the CPU reports the sync count of its traced calls, and
no device metric, having no card; the stage readers on traces made by hand,
a stage's device time read by the order of its launches; and nothing,
without an error, from a program that has no spans."""
from __future__ import annotations

import time

import pytest
from conftest import CELLS, cpu_devices, tiny_cell

from qpbench import harness, program, stages, trace
from qpbench.loader import load_module

SEED = 2 ** 31 + 4111
NEW = {"host_syncs_per_call", "prepare_device_ms", "init_device_ms",
       "refine_device_ms", "prepare_idle_ms"}
# read from the card's intervals, which a CPU trace lacks
ON_THE_CARD = {"prepare_device_ms", "init_device_ms", "refine_device_ms",
               "prepare_idle_ms"}


def _new(cell):
    return [m for m in cell.per_layer if m["name"].split(".")[0] in NEW]


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_traced_run_reads_the_traced_calls(cell_name):
    cell = tiny_cell(cell_name)
    spans = program.program("utils.spans")
    spans.clear()
    out = harness.run(cell, SEED, 0.3, True, cpu_devices(cell),
                      time.perf_counter(), log=lambda m: None)
    got = out["metrics"]
    calls = spans.calls()
    assert len(calls) == harness.TRACED_CALLS + harness.STACK_CALLS
    traced = calls[:harness.TRACED_CALLS]
    wanted = _new(cell)
    assert wanted
    for m in wanted:
        if m["name"].split(".")[0] in ON_THE_CARD:
            assert m["name"] not in got, m["name"]
            continue
        want = sum(c["syncs"] for c in traced) / len(traced)
        assert got[m["name"]]["value"] == pytest.approx(want, rel=1e-12)
    if cell_name == "dense50-cold":
        # the padding of K1's inputs, the dense path's one host read
        assert got["host_syncs_per_call"]["value"] == 1


def _trace():
    # two calls' worth, in us: the host in prepare 5-25 (it queues two
    # ops at 6 and 10, then waits for them 15.5-20.5), in the loop 30-35
    # (one at 31), in the refinement 40-60 (two at 41 and 45); the harness
    # queues a copy at 95. The card runs the loop's kernel 32-80 and the
    # refinement's ops after it, when the host has left the refinement
    u, rt = "user_annotation", "cuda_runtime"
    host = [(0.0, 100.0, "jrlqp.call", u),
            (5.0, 25.0, "jrlqp.prepare", u),
            (15.0, 21.0, "jrlqp.sync.pad", u),
            (15.5, 20.5, "cudaStreamSynchronize", rt),
            (30.0, 35.0, "jrlqp.loop", u),
            (40.0, 60.0, "jrlqp.refine", u),
            (6.0, 7.0, "cudaLaunchKernel", rt),
            (8.0, 8.5, "cudaStreamIsCapturing", rt),
            (10.0, 11.0, "cudaMemcpyAsync", rt),
            (31.0, 32.0, "cudaLaunchKernel", rt),
            (41.0, 42.0, "cudaLaunchKernel", rt),
            (45.0, 46.0, "cudaLaunchKernel", rt),
            (95.0, 96.0, "cudaMemcpyAsync", rt),
            (5.0, 25.0, "aten::copy_", "cpu_op")]
    dev = {0: [(8.0, 12.0, "k", "kernel"), (14.0, 20.0, "c", "gpu_memcpy"),
               (32.0, 80.0, "loop", "kernel"), (80.0, 85.0, "k", "kernel"),
               (85.0, 90.0, "k", "kernel"), (96.0, 98.0, "c", "gpu_memcpy")]}
    return trace.Trace(calls=2, t0=0.0, t1=100.0, device=dev, host=host)


def _run(tr):
    return harness.Run(setup_s=0.0, call_s=[], call_lanes=[], iterations=0,
                       failed=0, trace=tr)


def test_a_stage_reads_the_ops_its_launches_queued():
    run = _run(_trace())
    # ms per call: prepare 4 + 6 us, loop 48, refine 5 + 5, by launch
    # order; by the host's clock the refinement's ops would read nothing
    assert stages.stage_device_ms(run, "prepare") == pytest.approx(0.005)
    assert stages.stage_device_ms(run, "loop") == pytest.approx(0.024)
    assert stages.stage_device_ms(run, "refine") == pytest.approx(0.005)
    assert stages.stage_device_ms(run, "init") is None
    assert load_module("metrics", "refine_device_ms").read(run) == \
        pytest.approx(0.005)
    # an op queued before the range, running at its start: left out
    tr = _trace()
    tr.device[0].insert(0, (0.5, 3.0, "judge", "kernel"))
    assert stages.stage_device_ms(_run(tr), "prepare") == \
        pytest.approx(0.005)
    assert stages.stage_device_ms(_run(tr), "refine") == pytest.approx(0.005)
    # a copy's launch the trace lost: the kinds still align, the copy's op
    # is left out and every other op keeps its launch
    tr = _trace()
    tr.host = [h for h in tr.host if h[0] != 10.0]
    assert len(stages.launched(_run(tr))) == 5
    assert stages.stage_device_ms(_run(tr), "prepare") == \
        pytest.approx(0.002)
    assert stages.stage_device_ms(_run(tr), "loop") == pytest.approx(0.024)
    assert stages.stage_device_ms(_run(tr), "refine") == pytest.approx(0.005)


def test_the_idle_and_sync_readers_on_a_trace_made_by_hand():
    run = _run(_trace())
    # idle 0-8, 12-14 (midpoint 13, in prepare), 20-32 (26, in none),
    # 90-96 and 98-100
    assert stages.idle_in(run, "prepare") == pytest.approx(0.002 / 2)
    assert stages.idle_in(run, "init") is None
    assert stages.host_syncs(run) == 0.5
    assert load_module("metrics", "prepare_idle_ms").read(run) == \
        pytest.approx(0.001)


def test_a_program_without_spans_reads_nothing():
    tr = _trace()
    tr.host = [h for h in tr.host if not h[2].startswith("jrlqp.")]
    for name in sorted(NEW):
        assert load_module("metrics", name).read(_run(tr)) is None, name
