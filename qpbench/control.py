"""The control of the correctness check: the plain reference, computed in
float32, put in the program's place.

    python3 qpbench/control.py --workload <cell> --seeds 21,22,23 \
        [--workers 8] [--out build/qpbench/control.json]

The configurations state float64 answers (KKT residual within 1e-8), so the
nearest precision below is float32. For each seed this drives a whole run
of the cell (its inputs from the seed, the window, the judging and the
reference comparison) with :class:`ReferenceEntry` as the entry point: every
lane of each call solved by :func:`qpbench.reference.solve` in float32 in a
pool of worker processes. The window holds one call of the cell's own size
(no warm-up calls; a trajectory's steps are each solved cold). Each run's
``checks`` are the control's readings; the check must find every run not
correct. The benchmark's own runs never start this.
"""
from __future__ import annotations

import os

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("G", "a", "C", "l", "u", "xl", "xu")


def _solve_chunk(qp: dict, max_iter: int, dtype) -> list:
    from qpbench import reference

    return [reference.solve(*(qp[k][i] for k in KEYS), max_iter=max_iter,
                             dtype=dtype) for i in range(len(qp["a"]))]


class ReferenceEntry:
    """An entry point that solves every lane by the plain reference in
    ``dtype``, ``workers`` processes at a time (0: in this process)."""

    carries = False

    def __init__(self, dtype=np.float32, workers: int = 8,
                 max_iter: int = 1000, chunks: int = 64):
        self.dtype, self.workers = dtype, workers
        self.max_iter, self.chunks = max_iter, chunks
        self.pool = None
        if workers:
            ctx = multiprocessing.get_context("spawn")
            self.pool = ctx.Pool(workers, initializer=_init_worker,
                                 initargs=(str(ROOT),))

    def close(self):
        if self.pool is not None:
            self.pool.close()
            self.pool.join()
            self.pool = None

    def prepare(self, batch):
        return batch

    def solve(self, batch, carry=None):
        qp = batch.dense()
        host = {k: getattr(qp, k).cpu().numpy().astype(self.dtype)
                for k in KEYS}
        device = qp.a.device
        del qp
        B = len(host["a"])
        bounds = np.linspace(0, B, min(self.chunks, B) + 1).astype(int)
        parts = [{k: v[lo:hi] for k, v in host.items()}
                 for lo, hi in zip(bounds[:-1], bounds[1:])]
        jobs = [(p, self.max_iter, self.dtype) for p in parts]
        if self.pool is None:
            done = [_solve_chunk(*j) for j in jobs]
        else:
            done = self.pool.starmap(_solve_chunk, jobs)
        answers = [a for part in done for a in part]

        def t(v, dt):
            return torch.as_tensor(np.stack(v)).to(device=device, dtype=dt)

        x = t([a.x for a in answers], torch.float64)
        mult = t([a.multipliers for a in answers], torch.float64)
        status = t([a.status for a in answers], torch.int32)
        it = t([a.iterations for a in answers], torch.int32)
        return types.SimpleNamespace(
            x=x, multipliers=mult, status=status, iterations=it,
            active_set=(mult != 0).to(torch.int32)), None


def _init_worker(root: str) -> None:
    sys.path.insert(0, root)


def run_control(cell, seed: int, devices, entry, log=print) -> dict:
    """One run of ``cell`` with ``entry`` in the program's place: one call
    in the window, no warm-up."""
    from qpbench import harness

    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  warmup_calls=0))
    return harness.run(cell, seed, 1e-9, False, devices, time.perf_counter(),
                       entry=entry, log=log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from qpbench import harness

    if not torch.cuda.is_available():
        print("qpbench control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    entry = ReferenceEntry(workers=args.workers,
                           max_iter=int(cell.settings["reference_max_iter"]))
    rows = []
    try:
        for s in (int(v) for v in args.seeds.split(",") if v):
            t = time.perf_counter()
            out = run_control(cell, s, [torch.device("cuda", 0)], entry,
                              log=lambda m: print(m, file=sys.stderr))
            row = {"seed": s, "correct": out["correct"],
                   "attempted": out["attempted"], "failed": out["failed"],
                   "checks": out["checks"], "misses": out["misses"],
                   "wall_s": time.perf_counter() - t}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        entry.close()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "control": "reference in float32",
             "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
