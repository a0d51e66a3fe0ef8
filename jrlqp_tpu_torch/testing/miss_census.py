"""Census of the lanes the port's f32 GI paths miss on the card.

    python3 -m jrlqp_tpu_torch.testing.miss_census --out PATH
    python3 -m jrlqp_tpu_torch.testing.miss_census --jax-lanes PATH --out PATH
    python3 -m jrlqp_tpu_torch.testing.miss_census --states port=PATH jax=PATH \
        --out PATH

Without ``--jax-lanes`` it draws each set of :data:`SETS` on the card as
``chip_smoke.py`` draws it, solves it by the set's kernel path (K1 for the
headline and the size sweep, K3 for ``fused_init=False``, K9 for the compact
path) and by the same path with the kernel's plain PyTorch version, and
saves every lane that either misses the gate (SUCCESS and
``kkt_residual <= 1e-8``) to ``--out`` (the repo keeps it as
``tests/data/missed_lanes_port.npz``). Each saved lane carries its set, seed, lane index, n and m, its
f64 arrays (G, a, C, l, u, xl, xu) and these outcomes: the kernel and the
plain version in their batch (``kernel_card``, ``plain_card``) and on the
lane alone (``kernel_card_alone``, ``plain_card_alone``), and the f64 J/R
engine ``dense.solve_batch`` (``f64_jr_card``); each outcome is status,
iterations, KKT residual, pass or fail, the active set and x. A lane whose
kernel outcome alone differs from the one in its batch is kept with
``alone_reproduces`` false (its batch context is its set, seed and lane).
``kernel_card_trajectory`` holds the kernel's state on the lane alone at
iteration caps 0, 1, ... (status, x, q, it, term per cap), from which the
first iteration where two solvers part can be found.

With ``--jax-lanes PATH`` it reads a file of the same layout (the lanes the
JAX package misses, ``tests/data/missed_lanes_jax.npz``), solves each lane
alone on the card by its path's kernel and plain version, and writes their
outcomes and the kernel's trajectory into ``--out``.

With ``--states`` it reads the files of lanes named and, for each lane
where the card's kernel parts from the JAX kernel on a slack, keeps the
kernel's whole state at the caps of :func:`split_caps` (the repo keeps
them as ``tests/data/split_states_card.npz``), from which
``testing.op_split`` replays and splits each iteration.

Runs on the card; without one it raises. Each set's counts are printed as
one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import SolverOptions
from ..bench import harness
from ..ops.cuda import gi_kernel
from ..problems import QPProblem, problem_from_numpy
from ..solver import dense, fast
from .batch_gen import random_qp_batch
from .kkt import kkt_residual

GATE = 1e-8
ARRAYS = ("G", "a", "C", "l", "u", "xl", "xu")

# the headline set (bench.py's): n=50, m=100, act_frac 0.3, batch 16384,
# made in f32 and solved in f64; chip_smoke.py draws two check batches from
# the same generator before it (K2's and K1's, phases 2-3)
N, M, ACT_FRAC, BATCH = 50, 100, 0.3, 16384
PRIOR_DRAWS = (4096, 1024)
HEADLINE_OPT = (150, 1)            # max_iter, ir_steps
SWEEP_SIZES = (10, 25, 50, 75, 100)
SWEEP_OPT = (500, 3)               # time_batch's options

# (set, kernel path, seeds or sizes)
SETS = (("headline", "K1", tuple(range(8))),
        ("non_fused", "K3", (0,)),
        ("compact", "K9", (0,)),
        ("size_sweep", "K1", SWEEP_SIZES))


def headline_batch(seed: int, device) -> QPProblem:
    """The headline batch of ``chip_smoke.py``'s phase 4 at ``seed``: the
    generator first draws K2's and K1's check batches, then this one."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for b in PRIOR_DRAWS:
        random_qp_batch(gen, b, N, M, ACT_FRAC, dtype=torch.float32)
    return random_qp_batch(gen, BATCH, N, M, ACT_FRAC,
                           dtype=torch.float32).with_dtype(torch.float64)


def sweep_batch(n: int, device) -> QPProblem:
    """The size sweep's batch at ``n``, m = 2n, seed 0, as phase 19 draws
    it."""
    return harness._qp_batch(0, BATCH, n, 2 * n, ACT_FRAC, device)


def set_options(name: str) -> tuple[int, int]:
    """(max_iter, ir_steps) of a set."""
    return SWEEP_OPT if name == "size_sweep" else HEADLINE_OPT


def _loop(path: str, plain: bool = False):
    """The f32 loop of a path: K1's ``run(pb32, max_iter)``, K3's or K9's
    ``run(pb32, state0, max_iter)``; the kernel's wrapper or its plain
    version."""
    return {"K1": (gi_kernel.run_loop_fused, gi_kernel.gi_fused_plain),
            "K3": (gi_kernel.run_loop, gi_kernel.gi_loop_plain),
            "K9": (gi_kernel.run_loop_compact, gi_kernel.gi_compact_plain),
            }[path][plain]


def solve_path(path: str, pbs: QPProblem, max_iter: int, ir_steps: int,
               plain: bool = False):
    """The solve a path's entry point makes (``solve_refined_kernel`` for
    K1 and K3, ``solve_refined_kernel_compact`` for K9), with its kernel or
    the kernel's plain version. A CPU batch runs the plain version either
    way."""
    opt = SolverOptions(max_iter=max_iter)
    if path == "K1":
        return fast._solve_refined(pbs, opt, ir_steps, _loop(path, plain))
    return fast._solve_refined_from_init(pbs, opt, ir_steps,
                                         _loop(path, plain))


def trajectory(path: str, pb: QPProblem, max_iter: int, caps,
               full: bool = False) -> dict:
    """A path's f32 loop on one lane at each iteration cap of ``caps`` (the
    kernel on the card, its plain version on the CPU): {status (T, m+n)
    int8, x (T, n) f32, q, it, term (T,) int32}; with ``full`` also the
    rest of the state at each cap, as ``testing.op_split`` takes it: H and
    N* (T, n, n) f32 (N*'s rows are the slots), u (T, n), aorder (T, n)
    int32, skip1, sc_idx, sc_status (T,) int32 and hscale (T,) f32."""
    pb32 = pb.with_dtype(torch.float32)
    run = _loop(path)
    if path == "K1":
        outs = [run(pb32, c) for c in caps]
    else:
        state0 = fast._init_fast(pb32, SolverOptions(max_iter=max_iter).with_(
            dtype=torch.float32, zero_z_threshold=1e-6))
        outs = [run(pb32, state0, c) for c in caps]
    ints = ("q", "it", "term") + (("skip1", "sc_idx", "sc_status") if full
                                  else ())
    got = {"status": np.stack([o["status"][0].cpu().numpy().astype(np.int8)
                               for o in outs]),
           "x": np.stack([o["x"][0].cpu().numpy() for o in outs]),
           **{k: np.array([int(o[k].reshape(-1)[0]) for o in outs],
                          np.int32) for k in ints}}
    if full:
        for k, dt in (("H", np.float32), ("Ns", np.float32),
                      ("u", np.float32), ("aorder", np.int32)):
            got[k] = np.stack([o[k][0].cpu().numpy().astype(dt)
                               for o in outs])
        got["hscale"] = np.array([float(o["hscale"].reshape(-1)[0])
                                  for o in outs], np.float32)
    return got


def outcomes(res, pbs: QPProblem) -> list[dict]:
    """Per lane: status, iterations, KKT residual, pass, active set, x."""
    kkt = kkt_residual(res.x, res.multipliers, pbs).cpu().numpy()
    st = res.status.cpu().numpy()
    it = res.iterations.cpu().numpy()
    act = res.active_set.cpu().numpy().astype(np.int8)
    x = res.x.cpu().numpy()
    return [{"status": int(st[i]), "iterations": int(it[i]),
             "kkt": float(kkt[i]),
             "passed": bool(st[i] == 0 and kkt[i] <= GATE),
             "active_set": act[i], "x": x[i]} for i in range(len(st))]


def same_outcome(a: dict, b: dict) -> bool:
    """Same status, iterations, pass or fail and active set."""
    return (a["status"] == b["status"] and a["iterations"] == b["iterations"]
            and a["passed"] == b["passed"]
            and np.array_equal(a["active_set"], b["active_set"]))


def lane_problem(rec: dict, device) -> QPProblem:
    """A saved lane as a batch of one on ``device``."""
    return problem_from_numpy(**{k: rec["arrays"][k][None] for k in ARRAYS},
                              device=device)


def solve_alone(rec: dict, device) -> dict:
    """The lane alone on ``device`` by its path's kernel and plain version
    (on the CPU both are the plain version): {kernel, plain} outcomes."""
    pb = lane_problem(rec, device)
    mi, ir = rec["max_iter"], rec["ir_steps"]
    return {"kernel": outcomes(solve_path(rec["path"], pb, mi, ir), pb)[0],
            "plain": outcomes(solve_path(rec["path"], pb, mi, ir, plain=True),
                              pb)[0]}


def kernel_trajectory(rec: dict, device) -> dict:
    """The kernel's trajectory on the lane alone, caps 0 .. one past the
    last iteration any recorded outcome took (at most ``max_iter``)."""
    last = max(o["iterations"] for o in rec["outcomes"].values())
    caps = range(0, min(last + 1, rec["max_iter"]) + 1)
    return trajectory(rec["path"], lane_problem(rec, device),
                      rec["max_iter"], caps)


# ---- the card's own states around each parting, for op_split ----

WINDOW = 6          # caps before a parting's last shared state


def split_caps(rec: dict) -> list[int]:
    """The caps whose whole state :func:`card_states` keeps for a lane
    whose card kernel parts from the JAX kernel on a slack (its
    ``verdict``): the last shared state lo and the ``WINDOW`` before it;
    and, where the lane's ``verdict_stages`` follows the port's error
    back, every cap of that range (from the cap where the port's error
    stays above the JAX kernel's)."""
    v = rec.get("verdict") or {}
    if not str(v.get("kind", "")).startswith("select: slack"):
        return []
    lo = v["iteration"] - 1
    caps = set(range(max(0, lo - WINDOW), lo + 1))
    stages = rec.get("verdict_stages") or {}
    start = stages.get("port_above_from_cap")
    if start is not None:
        caps |= set(range(start, lo + 1))
    return sorted(caps)


def card_states(lane_files: dict, device) -> list[dict]:
    """For every lane of ``lane_files`` ({name: path}) with caps by
    :func:`split_caps`, its path's kernel's whole state at those caps on
    ``device``: {file, lane, path, caps, states}."""
    out = []
    for which, path in lane_files.items():
        for rec in load_lanes(path)[0]:
            caps = split_caps(rec)
            if not caps:
                continue
            states = trajectory(rec["path"], lane_problem(rec, device),
                                rec["max_iter"], caps, full=True)
            out.append({"file": which, "lane": lane_id(rec),
                        "path": rec["path"], "caps": np.array(caps, np.int32),
                        "states": states})
            print(json.dumps({"states": lane_id(rec), "file": which,
                              "caps": caps}), flush=True)
    return out


# ---- the file: JSON for scalars, one array per key ----

def _flatten(tree, arrays: dict):
    """``tree`` with each array replaced by {"@array": key}, the array
    stored in ``arrays`` under that key."""
    if isinstance(tree, np.ndarray):
        key = f"a{len(arrays)}"
        arrays[key] = tree
        return {"@array": key}
    if isinstance(tree, dict):
        return {k: _flatten(v, arrays) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, arrays) for v in tree]
    return tree


def _unflatten(tree, z):
    if isinstance(tree, dict):
        if set(tree) == {"@array"}:
            return z[tree["@array"]]
        return {k: _unflatten(v, z) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflatten(v, z) for v in tree]
    return tree


def save_lanes(path: str, lanes: list[dict], summary: dict) -> None:
    """Write lane records and a summary (counts per set) to ``path``."""
    arrays: dict = {}
    meta = _flatten({"lanes": lanes, "summary": summary}, arrays)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, meta=np.array(json.dumps(meta)), **arrays)


def load_lanes(path: str) -> tuple[list[dict], dict]:
    """(lane records, summary) of a file written by :func:`save_lanes`."""
    with np.load(path) as z:
        tree = _unflatten(json.loads(str(z["meta"])), z)
    return tree["lanes"], tree["summary"]


def lane_id(rec: dict) -> str:
    """``set-seed-lane``, and ``-n<n>`` for a sweep lane."""
    size = f"-n{rec['n']}" if rec["set"] == "size_sweep" else ""
    return f"{rec['set']}-{rec['seed']}{size}-{rec['lane']}"


# ---- the census on the card ----

def _draws(device):
    """(set, path, seed, batch) of every batch of :data:`SETS`."""
    for name, path, keys in SETS:
        for k in keys:
            if name == "size_sweep":
                yield name, path, 0, (lambda k=k: sweep_batch(k, device))
            else:
                yield name, path, k, (lambda k=k: headline_batch(k, device))


def census(device) -> tuple[list[dict], dict]:
    """Every set on ``device``: the lanes the kernel or its plain version
    misses, with their outcomes, and the counts per set."""
    lanes, summary = [], {}
    for name, path, seed, draw in _draws(device):
        t0 = time.perf_counter()
        pbs = draw()
        mi, ir = set_options(name)
        k = outcomes(solve_path(path, pbs, mi, ir), pbs)
        p = outcomes(solve_path(path, pbs, mi, ir, plain=True), pbs)
        miss_k = {i for i, o in enumerate(k) if not o["passed"]}
        miss_p = {i for i, o in enumerate(p) if not o["passed"]}
        idx = sorted(miss_k | miss_p)
        f64 = []
        if idx:
            sub = pbs._map(lambda t: t[torch.tensor(idx, device=t.device)])
            f64 = outcomes(dense.solve_batch(sub, SolverOptions(max_iter=mi)),
                           sub)
        key = f"{name}/{seed}" + (f"/n{pbs.n}" if name == "size_sweep"
                                  else "")
        new = [{"set": name, "path": path, "seed": seed, "lane": i,
                "n": pbs.n, "m": pbs.m, "max_iter": mi, "ir_steps": ir,
                "missed_by": [w for w, s in (("kernel_card", miss_k),
                                             ("plain_card", miss_p))
                              if i in s],
                "arrays": {a: getattr(pbs, a)[i].cpu().numpy()
                           for a in ARRAYS},
                "outcomes": {"kernel_card": k[i], "plain_card": p[i],
                             "f64_jr_card": f64[j]}}
               for j, i in enumerate(idx)]
        card_outcomes(new, device)
        for rec in new:
            o = rec["outcomes"]
            rec["alone_reproduces"] = (
                same_outcome(o["kernel_card_alone"], o["kernel_card"])
                and same_outcome(o["plain_card_alone"], o["plain_card"]))
        lanes += new
        summary[key] = {"lanes": pbs.batch, "kernel_misses": len(miss_k),
                        "plain_misses": len(miss_p),
                        "both_miss": len(miss_k & miss_p),
                        "saved": [lane_id(r) for r in new]}
        print(json.dumps({"set": key, "path": path, **summary[key],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del pbs
    return lanes, summary


def card_outcomes(lanes: list[dict], device) -> None:
    """Add each lane's outcomes alone on the card by its path's kernel and
    plain version, and the kernel's trajectory, in place."""
    for rec in lanes:
        alone = solve_alone(rec, device)
        rec["outcomes"]["kernel_card_alone"] = alone["kernel"]
        rec["outcomes"]["plain_card_alone"] = alone["plain"]
        rec["kernel_card_trajectory"] = kernel_trajectory(rec, device)
        print(json.dumps({"lane": lane_id(rec), "path": rec["path"],
                          **{w: [o["status"], o["iterations"], o["kkt"],
                                 o["passed"]] for w, o in alone.items()}}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="the file to write")
    ap.add_argument("--jax-lanes", default=None,
                    help="a file of lanes to solve alone on the card")
    ap.add_argument("--states", nargs="+", default=None, metavar="NAME=PATH",
                    help="files of lanes whose kernel states to keep "
                         "around each parting (split_caps)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("miss_census runs on a CUDA card; none is visible")
    import jrlqp_tpu_torch  # noqa: F401  (pins full-f32 matmuls)

    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.states:
        files = dict(a.split("=", 1) for a in args.states)
        save_lanes(args.out, card_states(files, device), {"card": card})
        return 0
    if args.jax_lanes:
        lanes, summary = load_lanes(args.jax_lanes)
        card_outcomes(lanes, device)
        summary["card"] = card
        save_lanes(args.out, lanes, summary)
        return 0
    lanes, summary = census(device)
    summary["card"] = card
    save_lanes(args.out, lanes, summary)
    print(json.dumps({"saved": len(lanes), "file": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
