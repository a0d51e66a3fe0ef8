"""Runs of one cell, one after another, and the spread of their metrics.

    python3 qpbench/spread.py --workload <cell> --seeds 11,12,13 \
        --seconds 20 [--trace 0] [--out build/qpbench/spread.json]

Starts ``qpbench/run.py`` once per seed, in this order, each in a process
of its own (one process on the cards at a time), keeps each run's result
line, its exit code and the end of its standard error, and prints for each
metric the runs' values, median and spread: the distance between the first
and third quartile (``statistics.quantiles(values, n=4)``) as a share of
the median. ``--out`` writes everything as one JSON file. This is the tool
that sets and checks a cell's bounds; the benchmark's own runs do not use
it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values) -> float | None:
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def one(workload: str, seed: int, seconds: float, traced: int) -> dict:
    t = time.perf_counter()
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        workload, "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(traced)],
                       capture_output=True, text=True, cwd=HERE.parent)
    lines = p.stdout.strip().splitlines()
    result = None
    if p.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"seed": seed, "trace": traced, "rc": p.returncode,
            "wall_s": time.perf_counter() - t, "result": result,
            "stderr_tail": p.stderr[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each, in order")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    for s in (int(v) for v in args.seeds.split(",") if v):
        r = one(args.workload, s, args.seconds, args.trace)
        runs.append(r)
        res = r["result"] or {}
        print(json.dumps({"seed": s, "rc": r["rc"], "wall_s": r["wall_s"],
                          "correct": res.get("correct"),
                          "failed": res.get("failed"),
                          "metrics": {k: v["value"] for k, v in
                                      res.get("metrics", {}).items()},
                          "checks": res.get("checks")}), flush=True)
        if r["rc"] != 0:
            print(r["stderr_tail"], file=sys.stderr, flush=True)
    names = sorted({k for r in runs if r["result"]
                    for k in r["result"]["metrics"]})
    summary = {}
    for k in names:
        vals = [r["result"]["metrics"][k]["value"] for r in runs
                if r["result"] and k in r["result"]["metrics"]]
        summary[k] = {"values": vals, "median": statistics.median(vals),
                      "spread": spread(vals)}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "seconds": args.seconds,
             "runs": runs, "summary": summary}, indent=1))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
