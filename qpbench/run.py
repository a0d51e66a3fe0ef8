"""The port's benchmark: one run of one cell.

    python3 qpbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs the cell that ``BENCHMARK.json`` names on the first ``chips`` CUDA
cards of this machine (see ``qpbench/README.md``) and prints one JSON
object as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number of the correctness check
beside its limit (also the last lines of standard error). Exits non-zero,
printing no result, without enough CUDA cards, without the program
``jrlqp_tpu_torch`` beside this folder, or when the process holds a JAX
module once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# one process with few threads: the reference's numpy runs single-threaded
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
# no library the program uses may load JAX behind its back
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def _fail(msg: str, code: int = 2) -> int:
    print(f"qpbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "jrlqp_tpu_torch" / "__init__.py").is_file():
        return _fail(f"the program jrlqp_tpu_torch is not in {ROOT}")
    sys.path.insert(0, str(ROOT))
    from qpbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{args.workload} needs {cell.chips} CUDA devices, "
                     f"{torch.cuda.device_count()} found")
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    torch.cuda.set_device(devices[0])

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      devices, T_START, log=log)
    bad = harness.forbidden_modules()
    if bad:
        return _fail(f"the process holds {', '.join(bad)} once the window "
                     f"has closed")
    for name, c in out["checks"].items():
        log(f"qpbench check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
