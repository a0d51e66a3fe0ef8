"""Whole runs at a tiny size on the CPU: the result line's shape, the
correctness check against the control and against a broken timed path,
and the command's refusals (no card, no program, a JAX module)."""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import CELLS, ROOT, cpu_devices, tiny_cell

from qpbench import control, harness, program

SEED = 2 ** 31 + 4099


def _run(cell, traced=False, entry=None, seconds=0.3):
    return harness.run(cell, SEED, seconds, traced, cpu_devices(cell),
                       time.perf_counter(), entry=entry, log=lambda m: None)


def _shape(out, cell, traced):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool)
    assert out["attempted"] > 0 and 0 <= out["failed"] <= out["attempted"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    assert out["device"]["count"] == cell.chips
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in out["breakdown"].values())


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_tiny_run_prints_the_contracts_line(cell_name):
    cell = tiny_cell(cell_name)
    out = _run(cell)
    _shape(out, cell, False)
    assert out["correct"], out["checks"]
    want = {m["name"] for m in cell.end_to_end}
    assert set(out["metrics"]) == want


@pytest.mark.parametrize("cell_name", ["dense50-cold", "ik9x43-track"])
def test_a_tiny_traced_run_reports_per_layer_metrics(cell_name):
    cell = tiny_cell(cell_name)
    out = _run(cell, traced=True)
    _shape(out, cell, True)
    # no device on the CPU: the device readers read nothing, the counts do
    allowed = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) <= allowed
    if "gi_iterations_mean" in allowed:
        assert out["metrics"]["gi_iterations_mean"]["value"] > 0


class Broken(program.Entry):
    """The cell's own entry with one fault planted where its answer is
    produced."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault
        self.carries = inner.carries
        self.previous = None

    def prepare(self, batch):
        return self.inner.prepare(batch)

    def solve(self, args, carry=None):
        res, new_carry = self.inner.solve(args, carry)
        B = res.x.shape[0]
        if self.fault == "state_unchanged":
            # the step hands back what it was handed: the last answer
            last, self.previous = self.previous, res
            return (last if last is not None else res), carry
        keep = torch.ones(B, dtype=torch.bool)
        if self.fault == "half_left_out":
            keep[B // 2:] = False
        if self.fault in ("answer_altered", "one_lane_altered"):
            scale = 1 + res.x.abs().amax(dim=1, keepdim=True)
            bump = torch.full_like(scale, 1e-6)
            if self.fault == "one_lane_altered":
                bump[1:] = 0.0             # lane 0 of every call alone
            res = dataclasses.replace(res, x=res.x + bump * scale)
        else:
            k = keep[:, None].to(res.x.device)
            res = dataclasses.replace(
                res, x=torch.where(k, res.x, 0.0),
                multipliers=torch.where(k, res.multipliers, 0.0))
        return res, new_carry


FAULTS = [(c, f) for c in CELLS for f in
          ("state_unchanged", "half_left_out", "answer_altered",
           "one_lane_altered")]


@pytest.mark.parametrize("cell_name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell_name, fault):
    cell = tiny_cell(cell_name)
    inner = program.load_entry(cell.settings["entry"], cell.config,
                               cpu_devices(cell))
    out = _run(cell, entry=Broken(inner, fault))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_is_not_correct(cell_name):
    cell = tiny_cell(cell_name)
    entry = control.ReferenceEntry(workers=0)
    for seed in (1, 2, 3):
        out = control.run_control(cell, seed, [torch.device("cpu")], entry,
                                  log=lambda m: None)
        assert out["correct"] is False, out["checks"]
        assert out["checks"]["x_gap"]["value"] > \
            out["checks"]["x_gap"]["limit"]


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "qpbench/run.py", "--workload",
                        "dense50-cold", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_the_command_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "qpbench", tmp_path / "qpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "qpbench/run.py", "--workload",
                        "dense50-cold", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    base = set(harness.forbidden_modules())
    for name in ("jrlqp_tpu_torch.solver", "jaxtyping", "flaxen",
                 "jrlqp_tpu_tools"):
        monkeypatch.setitem(sys.modules, name, object())
    assert set(harness.forbidden_modules()) == base
    for name in ("jax.numpy", "jrlqp_tpu.solver", "flax", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, object())
    assert set(harness.forbidden_modules()) >= {"jax", "jrlqp_tpu", "flax",
                                               "jaxlib"}


def test_the_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import qpbench.harness, "
            "qpbench.control, qpbench.program; import jrlqp_tpu_torch; "
            "from qpbench import harness; from qpbench.loader import "
            "load_module; from pathlib import Path; "
            "[load_module(p.parent.name, p.stem) for k in ('entries', "
            "'families', 'patterns', 'metrics') for p in "
            "Path('qpbench', k).glob('*.py')]; "
            "print(','.join(harness.forbidden_modules()))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip() == "", p.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, "qpbench/run.py", "--workload",
                        "dense50-cold", "--seed", str(SEED), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


def test_x_gap_leaves_out_judged_misses_only_while_excused(monkeypatch):
    # kept lanes: (key, lane, x, status, passed); the gap is x itself
    monkeypatch.setattr(harness, "lane_gap", lambda x, qp, it: float(x))
    sample = [(0, 0, 1e-13, 0, True), (0, 1, 3e-7, 0, False),
              (0, 2, 5.0, 4, False)]
    problems = [None] * 3
    assert harness.x_gap(sample, problems, 10, excused=True) == (1e-13,
                                                                  3e-7)
    assert harness.x_gap(sample, problems, 10, excused=False) == (3e-7,
                                                                   3e-7)
    # no lane the program calls SUCCESS: nothing to compare
    none = [(0, 2, 5.0, 4, False)]
    assert harness.x_gap(none, [None], 10, excused=True)[0] == float("inf")
