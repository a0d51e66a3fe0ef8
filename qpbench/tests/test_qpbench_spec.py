"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file it resolves to."""
from __future__ import annotations

import json
import re

import pytest
from conftest import CELLS, ROOT

from qpbench import harness
from qpbench.loader import load_module, module_path

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(_dim|_rank)$|^(n|m|s|nb|mc)$")
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "qpbench/run.py"]
    assert SPEC["paths"] == ["qpbench"]
    assert all(PATH.match(p) for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128


def test_names_units_and_lines():
    groups = ([c["name"] for c in SPEC["configs"]],
              [w["name"] for w in SPEC["workloads"]],
              [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    for group in groups:
        assert len(set(group)) == len(group)
    names = [n for group in groups for n in group]
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells_and_chips():
    assert tuple(w["name"] for w in SPEC["workloads"]) == CELLS
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        E2E["setup_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    assert (ROOT / "qpbench" / "traffic"
            / f"{_workload(cell)['traffic']}.json").is_file()
    assert c.chips == _workload(cell)["chips"]
    assert {"entry", "miss_share", "x_gap", "sample_lanes",
            "reference_max_iter"} <= set(c.settings)
    assert set(c.settings["set_from"]) == {"miss_share", "x_gap"}
    # the entry point, the family and the pattern are modules found by name
    assert hasattr(load_module("entries", c.settings["entry"]), "Entry")
    assert hasattr(load_module("families", c.config["family"]), "draw")
    assert hasattr(load_module("patterns", c.traffic["pattern"]), "batches")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert module_path("metrics", m["name"]).is_file()


@pytest.mark.parametrize("conf", [c["name"] for c in SPEC["configs"]])
def test_config_files(conf):
    entry = {c["name"]: c for c in SPEC["configs"]}[conf]
    assert entry["file"].startswith("qpbench/configs/")
    body = json.loads((ROOT / entry["file"]).read_text())
    assert body["name"] == conf
    assert _line(body["source"])
    assert body["reduced"] == entry["reduced"]
    assert set(body["reduced"]) <= set(body["assumed"])
    assert body["guarantee"]["kkt_max"] == 1e-8
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    sources = [c["source"] for c in SPEC["configs"]]
    assert len(set(sources)) == len(sources)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_files_resolve_to_a_reader(metric):
    path = module_path("metrics", metric["name"])
    # a file of its own, or the quantity's file for a split metric
    assert path.stem in (metric["name"], metric["name"].split(".")[0])
    assert callable(load_module("metrics", metric["name"]).read)


def test_every_file_of_a_kind_is_used():
    used = {"entries": {harness.load_cell(c).settings["entry"]
                        for c in CELLS},
            "families": {json.loads((ROOT / c["file"]).read_text())
                         ["family"] for c in SPEC["configs"]},
            "patterns": {json.loads((ROOT / "qpbench" / "traffic"
                                     / f"{w['traffic']}.json").read_text())
                         ["pattern"] for w in SPEC["workloads"]},
            "cells": {w["name"] for w in SPEC["workloads"]},
            "configs": {c["name"] for c in SPEC["configs"]},
            "traffic": {w["traffic"] for w in SPEC["workloads"]}}
    metrics = {m["name"].split(".")[0]
               for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    used["metrics"] = metrics
    for kind, names in used.items():
        files = {p.stem for p in (ROOT / "qpbench" / kind).iterdir()
                 if p.suffix in (".py", ".json")}
        assert files == names, kind


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    moved = E2E[metric["moves"]]
    cells = metric.get("workloads", [w["name"] for w in SPEC["workloads"]])
    for cell in cells:
        assert cell in moved.get("workloads", [cell])


def test_layers_of_one_name():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    for name in layers:
        assert name == name.strip()
    assert {"GI loop kernels", "solver", "torch stages around the loop",
            "device"} == layers


def _workload(name):
    return {w["name"]: w for w in SPEC["workloads"]}[name]
