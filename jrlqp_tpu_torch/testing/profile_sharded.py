"""Weak scaling of the sharded solve over the cards of one host.

    python3 -m jrlqp_tpu_torch.testing.profile_sharded
    python3 -m jrlqp_tpu_torch.testing.profile_sharded --device cpu --batch 64

The per-card batch is fixed (the headline set: n=50, m=100, act_frac 0.3,
problems made in f32 and solved in f64, ``max_iter=150``; chunk c of the
global batch is drawn from seed c, so every layout solves the same
problems), and the global batch grows with the cards. Two layouts run with
``solve_sharded(engine="pallas", fused_init=True)`` (K1):

1. one process, a mesh of the first k cards (``make_mesh(k)``): the batch
   starts on card 0 and its shards go to their cards (the shards are
   launched one after another from one thread);
2. k processes, one card each (``CUDA_VISIBLE_DEVICES``), a process group
   on nccl (gloo for ``--device cpu``), each solving its
   ``process_local_batch_slice`` over ``global_mesh()``; the statistics are
   all-reduced.

Each configuration prints one JSON line: cards, global batch, wall ms (best
of 3; layout 2 from a barrier to a barrier after a synchronize), solves/s,
the efficiency against the same layout on one card, and ``BatchStats``,
which must equal the sums over the chunks solved one by one on card 0
(layout 1's lanes must also equal theirs: status, iterations, x within
1e-10).
``--device cpu`` rehearses both layouts on CPU devices (small batches
only: the plain kernels). The last line is one JSON object with every
row.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch

from .. import SolverOptions, stack_problems
from ..parallel import distributed, make_mesh, solve_sharded
from ..solver.fast import solve_refined_kernel
from .batch_gen import random_qp_batch

N, M, ACT_FRAC, MAX_ITER = 50, 100, 0.3, 150


def _chunk(c: int, batch: int, n: int, m: int, device):
    gen = torch.Generator(device=device).manual_seed(c)
    return random_qp_batch(gen, batch, n, m, ACT_FRAC, dtype=torch.float32,
                           device=device).with_dtype(torch.float64)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stats_tuple(stats):
    return [stats.total_iterations, stats.n_success, stats.max_iterations]


def _reference(chunks, n, m, batch, device, opt):
    """The chunks solved one by one on ``device``: (status, iterations and
    x of all of them, in order; [total iterations, SUCCESS count, max
    iterations])."""
    res = [solve_refined_kernel(_chunk(c, batch, n, m, device), opt)
           for c in range(chunks)]
    status, it, x = (torch.cat([getattr(r, k) for r in res])
                     for k in ("status", "iterations", "x"))
    return ((status, it, x),
            [int(it.long().sum()), int((status == 0).sum()), int(it.max())])


def _check_lanes(label, res, ref):
    """Lane for lane against the chunks solved on one card: status and
    iterations equal, x within 1e-10."""
    status, it, x = ref
    dev = status.device
    err = float((res.x.to(dev) - x).abs().max())
    if not (torch.equal(res.status.to(dev), status)
            and torch.equal(res.iterations.to(dev), it) and err <= 1e-10):
        raise SystemExit(f"profile_sharded: {label}: lanes differ from the "
                         f"chunks solved on one card (max |x err| {err})")


def _one_process(k, n, m, batch, device, opt, reps):
    devices = (make_mesh(k).devices if device == "cuda"
               else [torch.device("cpu")] * k)
    mesh = make_mesh(devices=devices)
    pbs = stack_problems([_chunk(c, batch, n, m, devices[0])
                          for c in range(k)])
    res, stats = solve_sharded(pbs, opt, mesh=mesh, engine="pallas",
                               fused_init=True)
    best = float("inf")
    for _ in range(reps):
        for d in set(devices):
            _sync(d)
        t = time.perf_counter()
        res, stats = solve_sharded(pbs, opt, mesh=mesh, engine="pallas",
                                   fused_init=True)
        for d in set(devices):
            _sync(d)
        best = min(best, time.perf_counter() - t)
    return best, stats, res


def _worker(args):
    """One process of layout 2: its card is cuda:0 (CUDA_VISIBLE_DEVICES)."""
    import torch.distributed as dist

    backend = "nccl" if args.device == "cuda" else "gloo"
    distributed.initialize(f"127.0.0.1:{args.port}", args.world, args.rank,
                           backend=backend)
    opt = SolverOptions(max_iter=MAX_ITER)
    dev = "cuda" if args.device == "cuda" else "cpu"
    mesh = (distributed.global_mesh() if args.device == "cuda"
            else make_mesh(devices=[torch.device("cpu")]))
    sl = distributed.process_local_batch_slice(args.world * args.batch)
    assert sl == slice(args.rank * args.batch, (args.rank + 1) * args.batch)
    local = _chunk(args.rank, args.batch, args.n, args.m, dev)
    solve_sharded(local, opt, mesh=mesh, engine="pallas", fused_init=True)
    # one process initializes no group (initialize is a no-op there)
    barrier = dist.barrier if dist.is_initialized() else (lambda: None)
    best = float("inf")
    for _ in range(args.reps):
        _sync(dev)
        barrier()
        t = time.perf_counter()
        res, stats = solve_sharded(local, opt, mesh=mesh, engine="pallas",
                                   fused_init=True)
        _sync(dev)
        barrier()
        best = min(best, time.perf_counter() - t)
    if args.rank == 0:
        print(json.dumps({"wall_s": best, "stats": _stats_tuple(stats)}))
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _processes(k, args):
    """Layout 2 on k processes: (best wall s, stats) from rank 0."""
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
    row = json.loads(outs[0].strip().splitlines()[-1])
    return row["wall_s"], row["stats"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cards", type=int, default=None,
                    help="largest number of cards (default: every card; "
                         "4 with --device cpu)")
    ap.add_argument("--batch", type=int, default=16384,
                    help="lanes per card")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
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
    rows = []
    base = {}
    for layout in ("one process", "one process per card"):
        for k in ks:
            lanes, ref = _reference(k, args.n, args.m, args.batch, dev0,
                                    opt)
            if layout == "one process":
                wall, stats, res = _one_process(k, args.n, args.m,
                                                args.batch, args.device, opt,
                                                args.reps)
                _check_lanes(f"{layout}, {k} cards", res, lanes)
                stats = _stats_tuple(stats)
            else:
                wall, stats = _processes(k, args)
            if stats != ref:
                raise SystemExit(f"profile_sharded: {layout}, {k} cards: "
                                 f"BatchStats {stats} != the chunks' {ref}")
            sps = k * args.batch / wall
            base.setdefault(layout, sps)
            row = {"layout": layout, "cards": k,
                   "global_batch": k * args.batch, "wall_ms": 1e3 * wall,
                   "solves_per_s": sps,
                   "efficiency": sps / (k * base[layout]),
                   "stats": dict(zip(("total_iterations", "n_success",
                                      "max_iterations"), stats)),
                   "device": label}
            rows.append(row)
            print(json.dumps(row))
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
