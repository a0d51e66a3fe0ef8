"""Where the main path's time goes on one CUDA card.

    python3 -m jrlqp_tpu_torch.testing.profile_main [--batch 16384]

Times each stage of ``solve_refined_kernel`` at n=50, m=100, act_frac 0.3
(problems made in f32, solved in f64) by the program's own spans
(:mod:`jrlqp_tpu_torch.utils.spans`, CUDA events, under
``spans.recording()``): preparation (cast and pad), the loop (the fused
kernel K1), the index remap and the f64 refinement, summed per stage, and
the whole call; then the whole solve by wall clock, spans off. One solve under
``torch.profiler`` gives the device's busy time as the union of its kernel
and copy intervals, and the idle share against two spans: first kernel
start to last kernel end, and the profiled solve's host range (the
profiler's own overhead widens the gaps, so these are upper bounds).
Last, the loop stage's (K1's) device time at several batch sizes. Every
number is printed;
the last line is one JSON object with all of them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from .. import SolverOptions, solve_refined_kernel
from ..utils import spans
from .batch_gen import random_qp_batch

N, M, ACT_FRAC, MAX_ITER, IR_STEPS = 50, 100, 0.3, 150, 1


def _stages_ms(solve, reps):
    """Per rep, after one warm-up: the device ms of each stage of one
    ``solve()`` and of the whole call (``call``), by its spans."""
    solve()
    torch.cuda.synchronize()
    spans.clear()
    with spans.recording():
        for _ in range(reps):
            solve()
    torch.cuda.synchronize()
    return [dict({k: v["device_ms"] for k, v in c["stages"].items()},
                 call=c["device_ms"]) for c in spans.calls()]


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _trace(solve):
    """Kernel intervals and the host range of one profiled ``solve()``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("profiled_solve"):
            solve()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == "profiled_solve"]
    return dev, (host[0] if host else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--scaling", default="4096,16384,65536",
                    help="batch sizes for K1's device time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    f32, f64 = torch.float32, torch.float64
    opt = SolverOptions(max_iter=MAX_ITER)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    def problems(batch):
        return random_qp_batch(gen, batch, N, M, ACT_FRAC,
                               dtype=f32).with_dtype(f64)

    B = args.batch
    pbs = problems(B)
    reps = _stages_ms(lambda: solve_refined_kernel(pbs, opt, IR_STEPS),
                      args.reps)
    phases = {k: [r.get(k, 0.0) for r in reps] for k in reps[0]}
    for k, v in phases.items():
        print(f"phase {k}: device ms by its spans, {args.reps} reps: {v}")

    walls = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        solve_refined_kernel(pbs, opt, IR_STEPS)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    print(f"solve wall ms, {args.reps} reps: {walls}; "
          f"best {B / (min(walls) / 1e3)!r} solves/s")

    kern, host = _trace(lambda: solve_refined_kernel(pbs, opt, IR_STEPS))
    prof = {"n_device_events": len(kern)}
    if kern:
        iv = [(e["ts"], e["ts"] + e["dur"]) for e in kern]
        busy = _busy_us(iv)
        span = max(e for _, e in iv) - min(s for s, _ in iv)
        k1 = sum(e["dur"] for e in kern if "gi_fused" in e["name"])
        prof.update(busy_us=busy, device_span_us=span, k1_us=k1,
                    k1_share_of_busy=k1 / busy,
                    idle_share_device_span=1.0 - busy / span)
        if host is not None:
            prof.update(host_range_us=host["dur"],
                        idle_share_host_range=1.0 - busy / host["dur"])
    else:
        prof["idle_share_device_span"] = "not measured (no device events)"
    print(f"torch.profiler, one solve: {prof}")

    scaling = {}
    for b in (int(s) for s in args.scaling.split(",") if s):
        pb_b = problems(b)
        scaling[b] = min(r["loop"] for r in _stages_ms(
            lambda: solve_refined_kernel(pb_b, opt, IR_STEPS), args.reps))
        del pb_b
        torch.cuda.empty_cache()
        print(f"K1 (loop stage) device ms at batch {b}: {scaling[b]!r}")

    print(json.dumps({"card": card, "batch": B, "phases_ms": phases,
                      "solve_wall_ms": walls, "profile": prof,
                      "k1_ms_by_batch": scaling}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
