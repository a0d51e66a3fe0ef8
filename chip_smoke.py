#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (jrlqp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Builds the CUDA kernels from jrlqp_tpu_torch/csrc/, checks each kernel
against its plain PyTorch version on the card, then drives the main path
``solve_refined_kernel`` once at n=50, m=100, batch 16384 (the headline
solve) and gates it on KKT <= 1e-8 and SUCCESS. Any failed check raises, so
the exit code is nonzero. The last two lines of standard output are the
per-kernel JSON record and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the package beside it, it exits nonzero and prints no
result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N, M, ACT_FRAC, MAX_ITER, IR_STEPS = 50, 100, 0.3, 150, 1
BATCH = 16384        # main-path solve (the headline batch)
CHECK_BATCH = 1024   # K1-vs-plain comparison
K2_BATCH = 4096      # K2-vs-plain comparison
SEED = 0


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _cuda_ms(fn, reps: int = 3) -> float:
    """Best device time of ``fn`` in ms, by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import jrlqp_tpu_torch  # noqa: F401  (pins full-f32 matmuls)
    from jrlqp_tpu_torch import SolverOptions, solve_refined_kernel
    from jrlqp_tpu_torch.ops.cuda import _build, block_llt, gi_kernel
    from jrlqp_tpu_torch.solver import fast
    from jrlqp_tpu_torch.testing.batch_gen import random_qp_batch
    from jrlqp_tpu_torch.testing.kkt import kkt_residual

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f32, f64 = torch.float32, torch.float64
    np_ = gi_kernel._round_up(N + 1, 8)
    opt = SolverOptions(max_iter=MAX_ITER)

    # ---- phase 1: the card and the build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_info['seconds']:.2f} s, "
          f"cached={_build.build_info['cached']})")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    print(f"gi_fused shared memory per block: "
          f"{lib.jrlqp_gi_fused_smem_bytes(np_, gi_kernel._round_up(M, 8))} B")

    # ---- phase 2: K2 (block Cholesky + inverse) vs plain ----
    pb = random_qp_batch(gen, K2_BATCH, N, M, ACT_FRAC, dtype=f32)
    A = gi_kernel.prepare(pb)[0][0]          # identity-padded G, as K1 sees it
    n_bad = 8
    A[:n_bad, N - 1, N - 1] = -1.0          # non-SPD blocks
    A[:n_bad, N - 1, :N - 1] = 0.0
    A[:n_bad, :N - 1, N - 1] = 0.0
    L, Li, pd = block_llt.chol_inv_b(A)
    torch.cuda.synchronize()
    Lp = block_llt.chol_b_plain(A)
    Lip = block_llt.tri_inv_b_plain(Lp)
    pdp = block_llt.posdef_plain(Lp)
    _require(torch.equal(pd, pdp), "K2 non-SPD flags differ from plain")
    _require(int((~pd).sum()) == n_bad, f"K2 flags {int((~pd).sum())} "
             f"non-SPD blocks, expected {n_bad}")
    spd = pd
    k2_err = max(float((L[spd] - Lp[spd]).abs().max()),
                 float((Li[spd] - Lip[spd]).abs().max()))
    _require(torch.allclose(L[spd], Lp[spd], rtol=1e-4, atol=1e-5),
             "K2 L differs from plain")
    _require(torch.allclose(Li[spd], Lip[spd], rtol=1e-4, atol=1e-5),
             "K2 L^-1 differs from plain")
    print(f"K2 vs plain: {K2_BATCH} blocks of {np_}x{np_}, "
          f"{n_bad} non-SPD flagged alike, max |err| {k2_err:.3e}")

    # ---- phase 3: K1 (fused GI) vs plain, then both refined ----
    pbc = random_qp_batch(gen, CHECK_BATCH, N, M, ACT_FRAC, dtype=f32)
    ok_k = gi_kernel.run_loop_fused(pbc, MAX_ITER)
    ok_p = gi_kernel.gi_fused_plain(pbc, MAX_ITER)
    torch.cuda.synchronize()
    Bc = CHECK_BATCH
    differ = {k: ok_k[k] != ok_p[k] for k in ("term", "it", "q", "status",
                                               "aorder")}
    differ = {k: (v.any(dim=1) if v.dim() == 2 else v)
              for k, v in differ.items()}
    counts = {k: int(v.sum()) for k, v in differ.items()}
    print(f"K1 vs plain: {Bc} lanes; lanes that differ: {counts}")
    _require(counts["term"] <= 0.001 * Bc, "K1 term differs on > 0.1% of "
             "lanes")
    for name in ("it", "status", "aorder"):
        _require(counts[name] <= 0.01 * Bc,
                 f"K1 {name} differs on > 1% of lanes")
    # raw f32 outputs, on the lanes that took the same path
    same = ~torch.stack(list(differ.values())).any(dim=0)
    raw_err = {k: float((ok_k[k][same] - ok_p[k][same]).abs().max())
               for k in ("x", "u", "H", "Ns")}
    k1_err = max(raw_err.values())
    print(f"K1 vs plain raw f32 outputs on {int(same.sum())} lanes with "
          f"the same path: max |err| {raw_err}")
    _require(k1_err <= 1e-4, "K1 raw x/u/H/Ns differ from plain by > 1e-4")
    pbc64 = pbc.with_dtype(f64)
    rk = fast._refine_batch(pbc64, fast._state_from_kernel_out(ok_k, Bc),
                            IR_STEPS)
    rp = fast._refine_batch(pbc64, fast._state_from_kernel_out(ok_p, Bc),
                            IR_STEPS)
    both = (rk.status == 0) & (rp.status == 0)
    ref_err = float((rk.x[both] - rp.x[both]).abs().max())
    print(f"K1 vs plain after refinement: {int(both.sum())} lanes SUCCESS "
          f"in both, max |x err| {ref_err:.3e}")
    _require(ref_err <= 1e-7, "refined x differs from plain by > 1e-7")

    # ---- phase 4: the main path ----
    def problems():
        # made in f32, solved in f64, as bench.py:96-97 does
        return random_qp_batch(gen, BATCH, N, M, ACT_FRAC,
                               dtype=f32).with_dtype(f64)

    pbs = problems()
    torch.cuda.synchronize()
    gi_kernel.launches = 0
    block_llt.launches = 0
    res = solve_refined_kernel(pbs, opt, ir_steps=IR_STEPS)
    torch.cuda.synchronize()
    launches = {"gi_fused": gi_kernel.launches,
                "chol_inv_b": block_llt.launches}
    # K2 has no launch of its own on the main path: its device functions
    # run inside K1's prologue, so its count stays 0 here
    print(f"main path launches: {launches}")
    _require(launches["gi_fused"] > 0, "main path did not launch K1")
    _require(res.x.shape == (BATCH, N)
             and res.multipliers.shape == (BATCH, M + N),
             "main path output shapes")
    _require(bool(torch.isfinite(res.x).all()), "non-finite x")
    resid = kkt_residual(res.x, res.multipliers, pbs)
    passed = (resid <= 1e-8) & (res.status == 0)
    rate = float(passed.double().mean())
    mean_it = float(res.iterations.double().mean())
    max_it = int(res.iterations.max())
    print(f"main path: batch {BATCH}, n={N}, m={M}: KKT<=1e-8 & "
          f"SUCCESS rate {rate!r}, max KKT {float(resid.max())!r}, "
          f"mean_it {mean_it!r}, max_it {max_it}")
    _require(rate >= 0.999, f"pass rate {rate} < 0.999")

    def timed_solves(run_loop, reps=3):
        best = float("inf")
        for _ in range(reps):
            p = problems()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fast._solve_refined(p, opt, IR_STEPS, run_loop)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return BATCH / best

    sps_k1 = timed_solves(gi_kernel.run_loop_fused)
    sps_plain = timed_solves(gi_kernel.gi_fused_plain)
    print(f"solves/s (best of 3, batch {BATCH}, {card}): "
          f"kernel {sps_k1!r}, plain {sps_plain!r}")

    # kernel device times at the main path's shapes, beside the plain ones
    inputs, (n, m) = gi_kernel.prepare(pbs.with_dtype(f32))
    k1_ms = _cuda_ms(lambda: gi_kernel._gi_fused_cuda_raw(
        *inputs, n, m, MAX_ITER))
    k1_plain_ms = _cuda_ms(lambda: gi_kernel._gi_fused_plain_raw(
        *inputs, n, m, MAX_ITER), reps=1)
    G_main = inputs[0]
    k2_ms = _cuda_ms(lambda: block_llt.chol_inv_b(G_main))
    k2_plain_ms = _cuda_ms(lambda: block_llt.tri_inv_b_plain(
        block_llt.chol_b_plain(G_main)), reps=1)
    print(f"device ms at batch {BATCH} ({card}): K1 {k1_ms!r} "
          f"(plain {k1_plain_ms!r}), K2 {k2_ms!r} (plain {k2_plain_ms!r})")

    kernels = [
        {"name": "gi_fused", "route": "cuda",
         "source": "jrlqp_tpu_torch/csrc/gi_kernel.cu",
         "replaces": "jrlqp_tpu/ops/pallas/gi_kernel.py:674",
         "launches": launches["gi_fused"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "chol_inv_b", "route": "cuda",
         "source": "jrlqp_tpu_torch/csrc/block_llt.cuh",
         "replaces": "jrlqp_tpu/ops/pallas/block_llt.py:89",
         "launches": launches["chol_inv_b"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "runs_inside": "gi_fused"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
