"""Shared pieces of the harness's tests: the repository root on sys.path,
tiny copies of the cells for CPU runs, and the card fixture."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("dense50-cold", "ik9x43-cold", "ik9x43-track")


def tiny_cell(name: str, sample_lanes: int = 6):
    """The cell ``name`` at a size a CPU test holds: the same files, the
    family's sizes cut down."""
    from qpbench import harness

    cell = harness.load_cell(name)
    cfg = dict(cell.config)
    if cfg["family"] == "dense":
        cfg.update(n=6, m=12, batch=12)
    else:
        cfg.update(nb=2, s=4, mc=2, batch=6)
    return dataclasses.replace(
        cell, config=cfg,
        settings=dict(cell.settings, sample_lanes=sample_lanes))


def cpu_devices(cell):
    return [torch.device("cpu")] * cell.chips


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
