"""Weak scaling of the sharded solve over the cards of one host, with each
shard's device timeline.

    python3 -m jrlqp_tpu_torch.testing.profile_sharded [--trace]
    python3 -m jrlqp_tpu_torch.testing.profile_sharded --device cpu --batch 32 --loop-batch 16 --n 12 --m 24

The per-card batch is fixed (the headline set: n=50, m=100, act_frac 0.3,
problems made in f32 and solved in f64, ``max_iter=150``; ``--batch``
lanes per card for the kernel engines, ``--loop-batch`` for the host-loop
engines; chunk c of the global batch is drawn from seed c, so every layout
solves the same problems), and the global batch grows with the cards.
Each engine of ``--engines`` ("pallas": ``fused_init=True``, K1;
"pallas_k3": ``fused_init=False``, the torch init and K3; "f64": the J/R
engine; "refined": the f32 loop in K11) runs in two layouts:

1. one process, a mesh of the first k cards (``make_mesh(k)``): the batch
   starts on card 0 and ``solve_sharded`` solves its shards on their
   cards;
2. k processes, one card each (``CUDA_VISIBLE_DEVICES``), a process group
   on nccl (gloo for ``--device cpu``), each solving its
   ``process_local_batch_slice`` over ``global_mesh()``; the statistics are
   all-reduced.

Each configuration prints one JSON line: layout, engine, cards, global
batch, wall ms (best of ``--reps``; layout 2 from a barrier to a barrier
after a synchronize), solves/s, the efficiency against the same layout and
engine on one card, and ``BatchStats``, which must equal the sums over the
chunks solved one by one on card 0; layout 1's lanes must equal theirs bit
for bit. Layout 1 also prints one more solve's timeline
(``testing.shard_timeline``: each shard's engine call and kernels, in ms on
a clock shared by the cards, and how far they overlap). ``--trace`` runs
one layout-1 solve of each engine on every card under ``torch.profiler``
and prints, per card, its busy time, first and last activity and a ribbon
of 64 time bins (``#`` busy more than half the bin, ``+`` some, ``.``
idle), and per host thread the time spent in CUDA calls that wait for the
card. ``--out FILE`` writes every row, timeline
and trace summary as one JSON object. ``--device cpu`` rehearses both layouts on CPU devices (small
batches only: the plain kernels). The last line is one JSON object with
every row.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

from .. import SolverOptions, stack_problems
from ..parallel import distributed, make_mesh, solve_sharded
from ..parallel import mesh as mesh_mod
from . import shard_timeline
from .batch_gen import random_qp_batch

N, M, ACT_FRAC, MAX_ITER = 50, 100, 0.3, 150
# engine name -> (solve_sharded's engine, fused_init)
ENGINES = {"pallas": ("pallas", True), "pallas_k3": ("pallas", False),
           "f64": ("f64", False), "refined": ("refined", False)}
# the host-loop engines, run at --loop-batch lanes per card
LOOP_ENGINES = ("f64", "refined")
# CUDA runtime calls in which the host waits for the card
_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")


def _chunk(c: int, batch: int, n: int, m: int, device):
    gen = torch.Generator(device=device).manual_seed(c)
    return random_qp_batch(gen, batch, n, m, ACT_FRAC, dtype=torch.float32,
                           device=device).with_dtype(torch.float64)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stats_tuple(stats):
    return [stats.total_iterations, stats.n_success, stats.max_iterations]


def _solve(name, pbs, opt, mesh):
    engine, fused = ENGINES[name]
    return solve_sharded(pbs, opt, mesh=mesh, engine=engine,
                         fused_init=fused)


def _reference(name, chunks, n, m, batch, device, opt):
    """The chunks solved one by one on ``device`` by the engine alone:
    (the result's fields, in order; [total iterations, SUCCESS count, max
    iterations])."""
    engine, fused = ENGINES[name]
    res = [mesh_mod._solve_shard(_chunk(c, batch, n, m, device), opt, engine,
                                 fused) for c in range(chunks)]
    fields = {k: torch.cat([getattr(r, k) for r in res])
              for k in ("status", "iterations", "x", "multipliers",
                        "active_set")}
    it, status = fields["iterations"], fields["status"]
    return (fields,
            [int(it.long().sum()), int((status == 0).sum()), int(it.max())])


def _check_lanes(label, res, ref):
    """Lane for lane against the chunks solved on one card, bit for bit."""
    for k, want in ref.items():
        got = getattr(res, k).to(want.device)
        if not torch.equal(got, want):
            err = float((got.double() - want.double()).abs().max())
            raise SystemExit(f"profile_sharded: {label}: {k} differs from "
                             f"the chunks solved on one card (max |err| "
                             f"{err})")


def _mesh(k, device):
    devices = (make_mesh(k).devices if device == "cuda"
               else [torch.device("cpu")] * k)
    return make_mesh(devices=devices)


def _one_process(name, k, n, m, batch, device, opt, reps):
    """Layout 1: (best wall s, stats, result, timeline of one more solve)."""
    mesh = _mesh(k, device)
    devices = mesh.devices
    pbs = stack_problems([_chunk(c, batch, n, m, devices[0])
                          for c in range(k)])
    res, stats = _solve(name, pbs, opt, mesh)
    best = float("inf")
    for _ in range(reps):
        for d in set(devices):
            _sync(d)
        t = time.perf_counter()
        res, stats = _solve(name, pbs, opt, mesh)
        for d in set(devices):
            _sync(d)
        best = min(best, time.perf_counter() - t)
    with shard_timeline.record() as tl:
        _solve(name, pbs, opt, mesh)
    return best, stats, res, {"shards": tl.shards, "overlap": tl.overlap(),
                              "moves": tl.moves}


def _merged(intervals, gap=0.0):
    """The union of (start, end) intervals as sorted disjoint intervals,
    joining those less than ``gap`` apart."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1] + gap:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _ribbon(busy, t0, t1, bins=64):
    width = (t1 - t0) / bins or 1.0
    marks = []
    for b in range(bins):
        lo, hi = t0 + b * width, t0 + (b + 1) * width
        cover = sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in busy)
        marks.append("#" if cover > width / 2 else "+" if cover > 0 else ".")
    return "".join(marks)


def _trace(name, k, n, m, batch, device, opt):
    """One layout-1 solve under torch.profiler: per card its busy ms, first
    and last activity and a ribbon, per host thread its waits."""
    mesh = _mesh(k, device)
    pbs = stack_problems([_chunk(c, batch, n, m, mesh.devices[0])
                          for c in range(k)])
    _solve(name, pbs, opt, mesh)
    for d in set(mesh.devices):
        _sync(d)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("sharded_solve"):
            _solve(name, pbs, opt, mesh)
            for d in set(mesh.devices):
                _sync(d)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    host = [e for e in events if e.get("name") == "sharded_solve"
            and e.get("cat") == "user_annotation"]
    dev_ev = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    t0 = host[0]["ts"] if host else min(e["ts"] for e in dev_ev)
    t1 = (host[0]["ts"] + host[0]["dur"]) if host else max(
        e["ts"] + e["dur"] for e in dev_ev)
    cards, copies = {}, {}
    for e in dev_ev:
        d = str(e.get("args", {}).get("device", e.get("pid")))
        cards.setdefault(d, []).append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] == "gpu_memcpy":
            copies.setdefault(d, []).append((e["ts"], e["ts"] + e["dur"]))
    per_card = {}
    for d, iv in sorted(cards.items()):
        busy = _merged(iv)
        cp = _merged(copies.get(d, []))
        per_card[d] = {
            "events": len(iv),
            "busy_ms": sum(e - s for s, e in busy) / 1e3,
            "copy_ms": sum(e - s for s, e in cp) / 1e3,
            "copies_end_ms": (cp[-1][1] - t0) / 1e3 if cp else None,
            "first_ms": (busy[0][0] - t0) / 1e3,
            "last_ms": (busy[-1][1] - t0) / 1e3,
            "ribbon": _ribbon(busy, t0, t1)}
    waits = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and e.get("name") in _WAITS:
            w = waits.setdefault(str(e.get("tid")), {})
            w[e["name"]] = w.get(e["name"], 0.0) + e["dur"] / 1e3
    return {"engine": name, "cards": k, "host_ms": (t1 - t0) / 1e3,
            "per_card": per_card, "host_waits_ms_by_thread": waits,
            "device_events": len(dev_ev)}


def _worker(args):
    """One process of layout 2: its card is cuda:0 (CUDA_VISIBLE_DEVICES).
    Prints one JSON line per engine from rank 0."""
    import torch.distributed as dist

    backend = "nccl" if args.device == "cuda" else "gloo"
    distributed.initialize(f"127.0.0.1:{args.port}", args.world, args.rank,
                           backend=backend)
    opt = SolverOptions(max_iter=MAX_ITER)
    dev = "cuda" if args.device == "cuda" else "cpu"
    mesh = (distributed.global_mesh() if args.device == "cuda"
            else make_mesh(devices=[torch.device("cpu")]))
    # one process initializes no group (initialize is a no-op there)
    barrier = dist.barrier if dist.is_initialized() else (lambda: None)
    for name in args.engines.split(","):
        batch = args.loop_batch if name in LOOP_ENGINES else args.batch
        sl = distributed.process_local_batch_slice(args.world * batch)
        assert sl == slice(args.rank * batch, (args.rank + 1) * batch)
        local = _chunk(args.rank, batch, args.n, args.m, dev)
        _solve(name, local, opt, mesh)
        best = float("inf")
        for _ in range(args.reps):
            _sync(dev)
            barrier()
            t = time.perf_counter()
            res, stats = _solve(name, local, opt, mesh)
            _sync(dev)
            barrier()
            best = min(best, time.perf_counter() - t)
        if args.rank == 0:
            print(json.dumps({"engine": name, "wall_s": best,
                              "stats": _stats_tuple(stats)}), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _processes(k, args):
    """Layout 2 on k processes: engine -> (best wall s, stats) of rank 0."""
    port = _free_port()
    procs = []
    for r in range(k):
        env = dict(os.environ)
        if args.device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = str(r)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "jrlqp_tpu_torch.testing.profile_sharded",
             "--worker", "--rank", str(r), "--world", str(k), "--port",
             str(port), "--device", args.device, "--batch", str(args.batch),
             "--loop-batch", str(args.loop_batch), "--engines", args.engines,
             "--n", str(args.n), "--m", str(args.m), "--reps",
             str(args.reps)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=args.timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {k} exited {p.returncode}:\n"
                               f"{out[-3000:]}")
    rows = [json.loads(line) for line in outs[0].splitlines()
            if line.startswith('{"engine"')]
    return {r["engine"]: (r["wall_s"], r["stats"]) for r in rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cards", type=int, default=None,
                    help="largest number of cards (default: every card; "
                         "4 with --device cpu)")
    ap.add_argument("--engines", default="pallas,pallas_k3,f64,refined",
                    help=f"comma-separated, of {tuple(ENGINES)}")
    ap.add_argument("--layouts", default="1,2")
    ap.add_argument("--batch", type=int, default=16384,
                    help="lanes per card (kernel engines)")
    ap.add_argument("--loop-batch", type=int, default=1024,
                    help="lanes per card (the host-loop engines)")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    names = args.engines.split(",")
    for name in names:
        if name not in ENGINES:
            ap.error(f"unknown engine {name!r}")
    if args.worker:
        _worker(args)
        return 0
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("profile_sharded: no CUDA device", file=sys.stderr)
            return 1
        have = torch.cuda.device_count()
        label = (f"{torch.cuda.get_device_name(0)} x {have}, "
                 + subprocess.run(
                     ["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60).stdout.strip().replace("\n", "; "))
    else:
        have, label = 4, "CPU (rehearsal: plain kernels, gloo)"
    kmax = min(args.cards or have, have)
    ks = [k for k in (1, 2, 4, 8) if k <= kmax]
    opt = SolverOptions(max_iter=MAX_ITER)
    dev0 = "cuda" if args.device == "cuda" else "cpu"
    print(f"cards: {label}")
    rows, timelines, traces = [], [], []
    refs = {}
    layouts = args.layouts.split(",")
    for layout in layouts:
        walls = {}
        if layout == "2":
            for k in ks:
                walls[k] = _processes(k, args)
        for name in names:
            batch = args.loop_batch if name in LOOP_ENGINES else args.batch
            base = None
            for k in ks:
                if (name, k) not in refs:
                    refs[name, k] = _reference(name, k, args.n, args.m,
                                               batch, dev0, opt)
                lanes, ref = refs[name, k]
                if layout == "1":
                    wall, stats, res, tl = _one_process(
                        name, k, args.n, args.m, batch, args.device, opt,
                        args.reps)
                    _check_lanes(f"layout 1, {name}, {k} cards", res, lanes)
                    stats = _stats_tuple(stats)
                    timelines.append({"engine": name, "cards": k, **tl})
                    print(json.dumps({"timeline": name, "cards": k,
                                      "overlap": tl["overlap"],
                                      "shards": tl["shards"]}))
                else:
                    wall, stats = walls[k][name]
                if stats != ref:
                    raise SystemExit(f"profile_sharded: layout {layout}, "
                                     f"{name}, {k} cards: BatchStats "
                                     f"{stats} != the chunks' {ref}")
                sps = k * batch / wall
                base = base or sps
                row = {"layout": layout, "engine": name, "cards": k,
                       "global_batch": k * batch, "wall_ms": 1e3 * wall,
                       "solves_per_s": sps, "efficiency": sps / (k * base),
                       "stats": dict(zip(("total_iterations", "n_success",
                                          "max_iterations"), stats)),
                       "device": label}
                rows.append(row)
                print(json.dumps(row))
    if args.trace and args.device == "cuda":
        for name in names:
            batch = args.loop_batch if name in LOOP_ENGINES else args.batch
            tr = _trace(name, kmax, args.n, args.m, batch, args.device, opt)
            traces.append(tr)
            print(json.dumps({"trace": name, "cards": kmax,
                              "host_ms": tr["host_ms"]}))
            for d, c in tr["per_card"].items():
                print(f"  card {d}: busy {c['busy_ms']:.3f} ms (copies "
                  f"{c['copy_ms']:.3f}), "
                      f"{c['first_ms']:.3f}-{c['last_ms']:.3f} "
                      f"|{c['ribbon']}|")
            print(f"  host waits ms by thread: "
                  f"{json.dumps(tr['host_waits_ms_by_thread'])}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": label, "rows": rows,
                       "timelines": timelines, "traces": traces}, f)
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
