"""One run of one cell: set-up, the timed window, the judging, the
reference, the metrics and the result line.

Everything a cell is comes from files that ``BENCHMARK.json`` names:
``configs/<config>.json`` (the family, its sizes and the options),
``traffic/<traffic>.json`` (read by :mod:`.feeds`), ``cells/<cell>.json``
(the cell's entry point and the limits of its correctness check) and one
``metrics/<metric>.py`` per metric (a reader of :class:`Run`); the family,
the traffic's pattern and the entry point are modules of their own found by
name (:mod:`.loader`). A later cell, configuration, mix, family, pattern,
entry point or metric is new files and new entries in ``BENCHMARK.json``.

The window is a closed loop: the entry is called back to back, each call
timed by the host clock from handing over inputs that are already on the
device to the synchronize that closes it, until the calls' summed time
reaches ``seconds``. Between calls, with the clock stopped, every lane of
the call is judged on the device (status SUCCESS and the benchmark's own
KKT residual within the configuration's guarantee) and one lane, drawn from
the seed, is kept for the reference, with the window's lane of most
iterations. After the window the plain reference (:mod:`.reference`)
solves the kept lanes on the host (:func:`x_gap`).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import feeds, gen, kkt, program, reference, trace
from .loader import load_module

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# a traced run profiles this many calls for its metrics, and this many with
# Python frames for the labels of its idle gaps
TRACED_CALLS, STACK_CALLS = 3, 1
# missed lanes a run solves again by the reference, for its ``misses``
MISSED_KEPT = 4
FORBIDDEN = ("jax", "jaxlib", "flax", "jrlqp_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict      # cells/<cell>.json: the entry point and the limits
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"qpbench: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    wl = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    bench = root / "qpbench"
    return Cell(
        name=name, chips=int(wl["chips"]),
        config=json.loads((root / cfg_entry["file"]).read_text()),
        traffic=json.loads(
            (bench / "traffic" / f"{wl['traffic']}.json").read_text()),
        settings=json.loads((bench / "cells" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


@dataclasses.dataclass
class Run:
    """What the window and the traced sub-window measured; the metric
    readers read it."""

    setup_s: float
    call_s: list          # each call's time, s
    call_lanes: list      # each call's lanes
    iterations: int       # the result's iterations summed over the lanes
    failed: int
    trace: trace.Trace | None = None
    traced_counts: list = dataclasses.field(default_factory=list)

    @property
    def attempted(self) -> int:
        return int(sum(self.call_lanes))


def sync(devices) -> None:
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _counts(res, qp: gen.QP) -> dict:
    """What a loop kernel's bound needs of one call."""
    q_end = (res.active_set != 0).sum(dim=1)
    q0 = (qp.l == qp.u).sum(dim=1) + (qp.xl == qp.xu).sum(dim=1)
    return dict(batch=int(res.x.shape[0]), n=int(res.x.shape[1]),
                m=int(qp.C.shape[1]),
                it=res.iterations.cpu().numpy(), q0=q0.cpu().numpy(),
                q_end=q_end.cpu().numpy())


class Judge:
    """Every lane of every call against the guarantee, and the kept lanes."""

    def __init__(self, kkt_max: float, seed: int, lanes: int):
        self.kkt_max = kkt_max
        self.lanes = lanes
        self.rng = np.random.default_rng(gen.stream_seed(seed, 4))
        self.failed = 0
        self.iterations = 0
        self.kept = []          # (key, lane, x, status, passed), one a call
        # lanes of the first call, drawn from a stream of their own, that
        # fill the sample where the window has fewer calls than it needs
        self.reserve_rng = np.random.default_rng(gen.stream_seed(seed, 5))
        self.reserve = []
        self.hardest = None     # (iterations, key, lane, x, status, passed)
        self.miss_status = {}   # status -> lanes that missed
        self.missed = []        # a few missed lanes: (key, lane, x, status)
        self.miss_kkt = 0.0     # the widest KKT residual of a missed lane

    def __call__(self, res, qp: gen.QP, key) -> None:
        r = kkt.kkt_residual(res.x, res.multipliers, qp.G, qp.a, qp.C, qp.l,
                             qp.u, qp.xl, qp.xu)
        ok = (res.status == 0) & (r <= self.kkt_max)
        bad = ~ok
        n_bad = int(bad.sum())
        self.failed += n_bad
        if n_bad:
            self._note_misses(res, r, bad, key)
        it = res.iterations
        self.iterations += int(it.long().sum())
        if not self.reserve:
            B = res.x.shape[0]
            pick = self.reserve_rng.choice(B, min(self.lanes, B),
                                           replace=False)
            x_cpu = res.x[torch.as_tensor(pick, device=res.x.device)]
            self.reserve = [(key, int(i), x_cpu[j].double().cpu().numpy(),
                             int(res.status[int(i)]), bool(ok[int(i)]))
                            for j, i in enumerate(pick)]
        lane = int(self.rng.integers(res.x.shape[0]))
        self.kept.append((key, lane, res.x[lane].double().cpu().numpy(),
                          int(res.status[lane]), bool(ok[lane])))
        j = int(it.argmax())
        if self.hardest is None or int(it[j]) > self.hardest[0]:
            self.hardest = (int(it[j]), key, j,
                            res.x[j].double().cpu().numpy(),
                            int(res.status[j]), bool(ok[j]))

    def _note_misses(self, res, r, bad, key) -> None:
        """What the lanes that missed said, for the run's ``misses``."""
        st = res.status[bad].cpu().tolist()
        for v in st:
            self.miss_status[v] = self.miss_status.get(v, 0) + 1
        rb = torch.nan_to_num(r[bad], nan=float("inf"))
        self.miss_kkt = max(self.miss_kkt, float(rb.max()))
        for lane in bad.nonzero()[:, 0].tolist()[:MISSED_KEPT
                                                 - len(self.missed)]:
            self.missed.append((key, lane,
                                res.x[lane].double().cpu().numpy(),
                                int(res.status[lane])))

    def sample(self) -> list:
        """The hardest lane and up to ``lanes - 1`` kept lanes drawn from
        the seed, filled from the reserve where the window had fewer calls:
        (key, lane, x, status, passed) each, ``passed`` the judge's
        verdict."""
        lanes = self.lanes
        pick = self.rng.choice(len(self.kept), min(lanes - 1, len(self.kept)),
                               replace=False)
        out = [self.kept[i] for i in sorted(pick)]
        taken = {(k, lane) for k, lane, *_ in out}
        for item in self.reserve:
            if len(out) >= lanes - 1:
                break
            if item[:2] not in taken:
                out.append(item)
                taken.add(item[:2])
        if self.hardest is not None:
            out.append(self.hardest[1:])
        return out


def lane_gap(x, qp: dict, max_iter: int, dtype=np.float64) -> float:
    """The gap between ``x`` and the reference's answer of the one-lane
    numpy problem ``qp``, relative to 1 + |x_ref|_inf; inf where the
    reference finds no solution."""
    ref = reference.solve(*(qp[k][0] for k in ("G", "a", "C", "l", "u", "xl",
                                               "xu")),
                          max_iter=max_iter, dtype=dtype)
    if ref.status != 0:
        return float("inf")
    gap = float(np.abs(x - ref.x).max() / (1 + np.abs(ref.x).max()))
    return gap if np.isfinite(gap) else float("inf")


def x_gap(sample, problems: list, max_iter: int,
          excused: bool) -> tuple[float, float]:
    """(compared, widest): the widest :func:`lane_gap` over the kept lanes
    that the program calls SUCCESS, leaving out, where ``excused``, those
    that the judge failed; and the widest over all of them. inf where there
    is no such lane.

    A lane the judge failed is already counted by ``miss_share``. While the
    window's misses are within their limit (``excused``) they are the misses
    the configuration allows, and their answers, as far off as the float32
    control's, are left out; beyond it every SUCCESS lane is held to the
    reference."""
    gaps = [(lane_gap(x, qp, max_iter), passed)
            for (_, _, x, status, passed), qp in zip(sample, problems)
            if status == 0]
    held = [g for g, passed in gaps if passed or not excused]
    return (max(held, default=float("inf")),
            max((g for g, _ in gaps), default=float("inf")))


def card_info(devices) -> dict:
    """platform, kind, count of the run's devices."""
    d0 = torch.device(devices[0])
    if d0.type != "cuda":
        return {"platform": d0.type, "kind": d0.type, "count": len(devices)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(d0),
            "count": len(devices)}


def power_limit() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(cell: Cell, seed: int, seconds: float, traced: bool, devices,
        t_start: float, entry=None, log=print) -> dict:
    """One run of ``cell``; returns the result object. ``entry`` replaces
    the cell's entry point (the control and the fault tests)."""
    cfg, traffic, own = cell.config, cell.traffic, cell.settings
    marks = [("imports", time.perf_counter())]
    entry = entry or program.load_entry(own["entry"], cfg, devices)
    marks.append(("program", time.perf_counter()))
    feed = feeds.Feed(cfg, traffic, seed, devices[0], entry)
    sync(devices)
    marks.append(("draws", time.perf_counter()))
    carry = None
    if entry.carries:
        args, _ = feed.next()
        _, carry = entry.solve(args, None)      # the cold step
    for _ in range(int(traffic.get("warmup_calls", 2))):
        args, _ = feed.next()
        _, carry = entry.solve(args, carry)
    sync(devices)
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", t_start + setup_s))
    split = ", ".join(f"{name} {t - prev:.3f}" for (name, t), prev in
                      zip(marks, [t_start] + [t for _, t in marks]))
    log(f"qpbench: {cell.name}: set-up {setup_s:.3f} s ({split})")

    judge = Judge(float(cfg["guarantee"]["kkt_max"]), seed,
                  int(own["sample_lanes"]))
    call_s, call_lanes = [], []
    wall0 = time.perf_counter()
    while sum(call_s) < seconds and \
            time.perf_counter() - wall0 < 2 * seconds + 60:
        args, key = feed.next()
        t = time.perf_counter()
        res, carry = entry.solve(args, carry)
        sync(devices)
        call_s.append(time.perf_counter() - t)
        call_lanes.append(int(res.x.shape[0]))
        judge(res, feed.problem(key), key)
    log(f"qpbench: {cell.name}: {len(call_s)} calls in {sum(call_s):.3f} s "
        f"of call time, {time.perf_counter() - wall0:.3f} s of wall")
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if torch.device(d).type == "cuda"), default=0)
    rec = Run(setup_s=setup_s, call_s=call_s,
              call_lanes=call_lanes, iterations=judge.iterations,
              failed=judge.failed)

    stack = None
    if traced:
        results = []

        def calls(k):
            def go():
                nonlocal carry
                for _ in range(k):
                    a, key_ = feed.next()
                    r, carry = entry.solve(a, carry)
                    sync(devices)
                    results.append((r, key_))
            return go

        rec.trace = trace.capture(calls(TRACED_CALLS), TRACED_CALLS)
        rec.traced_counts = [_counts(r, feed.problem(k)) for r, k in results]
        results.clear()
        stack = trace.capture(calls(STACK_CALLS), STACK_CALLS,
                              with_stack=True)

    # the program's state goes before the reference runs
    sample = judge.sample()
    problems = [feed.problem(k).lanes([lane]).numpy()
                for k, lane, *_ in sample + judge.missed]
    del feed, entry, carry, args
    gc.collect()
    if torch.device(devices[0]).type == "cuda":
        torch.cuda.empty_cache()
    attempted = rec.attempted
    miss_share = rec.failed / attempted if attempted else float("inf")
    t_ref = time.perf_counter()
    max_iter = int(own["reference_max_iter"])
    gap, widest = x_gap(sample, problems, max_iter,
                        excused=miss_share <= float(own["miss_share"]))
    misses = {"x_gap_widest": widest, "kept_lanes": len(sample),
              "by_status": {str(k): v for k, v in
                            sorted(judge.miss_status.items())},
              "max_kkt": judge.miss_kkt,
              "x_gap_of_kept": [lane_gap(m[2], qp, max_iter) for m, qp in
                                zip(judge.missed, problems[len(sample):])]}
    log(f"qpbench: {cell.name}: reference on {len(sample)} lanes in "
        f"{time.perf_counter() - t_ref:.3f} s")

    checks = {
        "miss_share": {"value": miss_share,
                       "limit": float(own["miss_share"])},
        "x_gap": {"value": gap, "limit": float(own["x_gap"])},
    }
    correct = attempted > 0 and all(c["value"] <= c["limit"]
                                    for c in checks.values())

    specs = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in specs:
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = card_info(devices)
    device["memory_peak_bytes"] = int(peak)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": rec.failed, "metrics": metrics, "device": device}
    if traced:
        used = range(len({torch.device(d) for d in devices}))
        device["busy_s"] = (sum(rec.trace.busy_s(i) for i in used)
                            / len(used))
        device["window_s"] = rec.trace.window_s
        device["power"] = power_limit()
        out["breakdown"] = {"device_ops": trace.top_device_ops(rec.trace),
                            "idle_gaps": trace.idle_gaps(stack)}
    out["misses"] = misses
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    """The top-level names of ``sys.modules`` that the run may not hold."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))

