"""The cell ``dense50-track`` (the dense control loop: K4 warm steps from
the carry) on the CPU: its files resolve, the contract holds with it among
the cells, a tiny run prints the contracts line, a tiny traced run reads
the counts and no device metric, a broken timed path and the float32
control are not correct, and K4's frozen counts are chip_smoke's."""
from __future__ import annotations

import importlib.util
import json
import time

import numpy as np
import pytest
import torch
from conftest import CELLS, ROOT, cpu_devices, tiny_cell
from test_qpbench_run import Broken

from qpbench import control, counts, counts_k4, harness, program, trace
from qpbench.loader import load_module

CELL = "dense50-track"
SEED = 2 ** 31 + 4421
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
PER_LAYER = {"k4_roofline", "gi_iterations_mean.track",
             "device_idle_pct.track", "host_syncs_per_call.track",
             "prepare_device_ms.track", "refine_device_ms.track",
             "prepare_idle_ms.track"}


def _run(cell, traced=False, entry=None, seconds=0.3):
    return harness.run(cell, SEED, seconds, traced, cpu_devices(cell),
                       time.perf_counter(), entry=entry, log=lambda m: None)


def test_the_cell_loads_its_files():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1
    assert cell.config["name"] == "dense50-warm"
    assert (cell.config["family"], cell.config["n"], cell.config["m"],
            cell.config["act_frac"], cell.config["batch"]) == \
        ("dense", 50, 100, 0.4, 16384)
    assert cell.config["options"] == {"max_iter": 150}
    assert cell.config["ir_steps"] == 1 and cell.config["reduced"] == []
    assert cell.traffic["pattern"] == "track"
    assert cell.settings["entry"] == "solve_refined_kernel_carry"
    entry = program.load_entry(cell.settings["entry"], cell.config,
                               cpu_devices(cell))
    assert entry.carries
    assert {m["name"] for m in cell.end_to_end} == {
        "step_solves_per_s", "step_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == PER_LAYER
    for m in cell.end_to_end + cell.per_layer:
        assert callable(load_module("metrics", m["name"]).read)
    own = cell.settings
    assert (own["miss_share"], own["x_gap"], own["sample_lanes"],
            own["reference_max_iter"]) == (1e-3, 1e-9, 64, 1000)
    assert set(own["set_from"]) == {"miss_share", "x_gap"}


def test_the_contract_holds_with_the_new_cell():
    # the checks of test_qpbench_spec.py that name the cells, over the
    # accepted cells and this one
    cells = (*CELLS, CELL)
    assert tuple(w["name"] for w in SPEC["workloads"]) == cells
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {w["config"] for w in SPEC["workloads"]} == \
        {c["name"] for c in SPEC["configs"]}
    entries = {harness.load_cell(c).settings["entry"] for c in cells}
    assert entries == {p.stem for p in (ROOT / "qpbench" / "entries").glob(
        "*.py")}
    (k4,) = [m for m in SPEC["per_layer"] if m["name"] == "k4_roofline"]
    assert k4 == {"name": "k4_roofline", "unit": "%", "better": "higher",
                  "source": "device_trace", "layer": "GI loop kernels",
                  "moves": "step_solves_per_s", "workloads": [CELL]}


def test_a_tiny_run_prints_the_contracts_line():
    cell = tiny_cell(CELL)
    out = _run(cell)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    json.dumps(out)


def test_a_tiny_traced_run_reads_the_counts_and_no_device_metric():
    cell = tiny_cell(CELL)
    out = _run(cell, traced=True)
    assert {"busy_s", "window_s"} <= set(out["device"])
    # no device on the CPU: K4's share and the device times read nothing;
    # the iteration count and the host-sync spans read
    assert "k4_roofline" not in out["metrics"]
    assert set(out["metrics"]) <= PER_LAYER
    assert out["metrics"]["gi_iterations_mean.track"]["value"] >= 0
    assert out["metrics"]["host_syncs_per_call.track"]["value"] >= 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered", "one_lane_altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    cell = tiny_cell(CELL)
    inner = program.load_entry(cell.settings["entry"], cell.config,
                               cpu_devices(cell))
    out = _run(cell, entry=Broken(inner, fault))
    assert out["correct"] is False, out["checks"]


def test_the_control_is_not_correct():
    cell = tiny_cell(CELL)
    entry = control.ReferenceEntry(workers=0)
    for seed in (1, 2, 3):
        out = control.run_control(cell, seed, [torch.device("cpu")], entry,
                                  log=lambda m: None)
        assert out["correct"] is False, out["checks"]
        assert out["checks"]["x_gap"]["value"] > \
            out["checks"]["x_gap"]["limit"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_counts", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k4_counts_are_chip_smokes_k4_bound():
    # chip_smoke phase 7: _gi_flops(it, q0, q_end) + B 6 n^2 operations,
    # _gi_bytes(B, n, m, 2n^2 + 3n + m + 1) bytes
    cs = _chip_smoke()
    B, n, m = 5, 50, 100
    it = np.array([0, 1, 2, 3, 7])
    q0 = np.array([20, 21, 19, 0, 30])
    q_end = np.array([20, 22, 18, 2, 33])
    flops = cs._gi_flops(torch.as_tensor(it), torch.as_tensor(q0),
                         torch.as_tensor(q_end), n, m) + B * 6 * n * n
    nbytes = cs._gi_bytes(B, n, m, 2 * n * n + 3 * n + m + 1)
    assert counts_k4.k4_flops(it, q0, q_end, n, m) == flops
    assert counts_k4.k4_bytes(B, n, m) == nbytes
    # the bound in seconds against chip_smoke's (ms, what binds)
    ms, binds = cs._bound(flops, nbytes)
    assert counts_k4.k4_bound_s(B, n, m, it, q0, q_end) == \
        pytest.approx(ms / 1e3, rel=1e-12)
    assert binds == "bytes"
    # 16,384 lanes at n = 50, m = 100 move 1.203 GB: 0.359 ms at 3.35 TB/s
    assert counts_k4.k4_bytes(16384, n, m) == 1_203_240_960


def _trace(kernel):
    return trace.reduce([
        {"cat": "user_annotation", "name": trace.WINDOW, "ts": 100,
         "dur": 100},
        {"cat": "kernel", "name": f"void {kernel}(float const*)", "ts": 110,
         "dur": 40, "args": {"device": 0}},
        {"cat": "kernel", "name": "elementwise", "ts": 160, "dur": 30,
         "args": {"device": 0}}], calls=2)


def test_k4_roofline_reads_the_warm_kernel_alone():
    counts_ = [dict(batch=4, n=3, m=5, it=np.array([1, 0, 2, 1]),
                    q0=np.zeros(4), q_end=np.array([1, 2, 2, 0]))] * 2
    run = harness.Run(setup_s=1.0, call_s=[0.5, 0.5], call_lanes=[4, 4],
                      iterations=8, failed=0, trace=_trace("gi_warm_kernel"),
                      traced_counts=counts_)
    bound = 2 * counts_k4.k4_bound_s(4, 3, 5, *(counts_[0][k] for k in
                                               ("it", "q0", "q_end")))
    reader = load_module("metrics", "k4_roofline")
    assert reader.read(run) == pytest.approx(100 * bound / 40e-6)
    # K1's kernel is not K4's, and K4's is not a loop kernel of counts.py
    assert load_module("metrics", "k1_roofline").read(run) is None
    assert counts.loop_kernel_of("void gi_warm_kernel(float const*)") is None
    run.trace = _trace("gi_fused_kernel")
    assert reader.read(run) is None
    run.trace = None
    assert reader.read(run) is None
