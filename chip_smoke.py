#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (jrlqp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Builds the CUDA kernels from jrlqp_tpu_torch/csrc/, checks each kernel
against its plain PyTorch version on the card, and drives the port's paths,
the dense ones at n=50, m=100 and the structured one at the multi-robot IK
width (9 robots x 43 dof, n=387, m=36):

1. the card and the build (the CUDA kernels, and the host C++ readers of
   ``jrlqp_tpu_torch/csrc/host/``);
2. K2 (block Cholesky and inverse) against its plain version;
3. K1 (the fused GI solve) against its plain version, 1024 lanes;
4. the main path ``solve_refined_kernel`` at batch 16384 (the headline
   solve), gated on KKT <= 1e-8 and SUCCESS, with solves/s;
5. K3 (the loop from a given state) against its plain version, 1024 lanes,
   from the warm init of two kinds of hints;
6. K4 (the loop from a carried operator) against its plain version, 1024
   lanes, at bound drifts 0.02 and 0.5, from the carry in the kernels' own
   layout as the entry point returns it, and the same step from a carry of
   plain tensors;
7. the control-loop warm paths at batch 16384: a cold step and 10 warm K4
   steps of ``solve_refined_kernel_carry`` at bound drift 0.02, each on the
   carry the step before returned and held against a cold solve, and one
   ``solve_refined_warm_kernel`` hint step (K3), each gated like the main
   path, with solves/s, device times and the split of a warm step
   (preparation, K4, remap, refinement; beside it the step from a carry of
   plain tensors, which casts and pads G and C again);
8. K5-K8 (the structured block-LLT chains) against their plain versions at
   the IK shape, batch 1024: tri-block-diagonal (with lower_only) and
   block-arrow down and up, with device times (lower_only and the up arrow
   too), K5's and K7's launch configuration (threads, shared memory and
   resident blocks per SM), their times at batch 132, one full wave of
   resident blocks and 1024, K6's and K8's rhs tile width and resident
   blocks per SM, and the
   cost of K6's padded layout (K6 on K5's padded factor and the shared
   identity, as the path calls it, against an unpadded factor or rhs,
   copied per call);
9. the structured cold batch ``solve_structured_fast_batch`` at batch 1024
   (K5 + K6, the GI loop in one K11 launch, f64 refinement on the structure:
   K13 and K14 once to start and once a step), gated at a
   pass rate of 1.0 and held against the port's dense engine
   ``solve_refined``; K13 and K14 held against their plain versions on
   the batch's own final states (the refinement's start and first step; g
   within 1e-13 and the tracked state within 1e-12, absolute plus
   relative), with their ms by events around the wrapper's call, the plain
   versions' and their bounds; the two arrow layouts (K7 + K8 + K11) gated
   alike;
   solves/s of the kernel route, the composed ``"blocks"`` route and the
   dense engine, and the time split; K11 (the explicit-form loop) against
   its plain version on the cold batch's own state and at the headline set
   (batch 1024, f32 and f64; the same status, iterations, active count and
   active set on >= 0.99 of the lanes in f32, every lane in f64, each lane
   that parts printed with its first parting iteration and deciding
   margins, ``testing.fast_parting``), with its device ms, the plain
   version's, its bound, the time of the bytes its design streams, and its
   launch configuration (threads, shared bytes, blocks per SM, registers);
10. the IK trajectory: a cold step and 9 warm steps of
   ``solve_structured_fast_carry`` at batch 1024 (10,240 solves; K5 and K6
   on the cold step, K12 once per warm step, K11 once per step, K13 and
   K14 four times a step), fresh 0.02 N(0, 1) noise on a and
   a 0.02 N(0, 1) shift of l and u per step, each gated at a pass rate of
   1.0 and held against a cold solve of the step; and K12 (the carry
   init) against its plain version on the last warm step's carry, with
   its device ms, the plain version's, its bound and its launch
   configuration;
11. K9 (the compact-slot loop) against its plain version, 1024 lanes from
   the torch cold init, and lane for lane against the XLA engine's loop
   in its plain version (``fast.fast_loop_plain``);
12. the compact path ``solve_refined_kernel_compact`` at batch 16384 (one
   K9 launch, no K1), gated like the main path, with solves/s beside the
   main path's and the split: init, prepare, K9, remap, refinement;
13. the rescue ``solve_refined_kernel_rescued`` at batch 16384: pass rate
   1.0 at act_frac 0.3 and >= 0.9999 at act_frac 0.9, with the rescued
   count, the rescue's wall ms and its launches (K3 once, K10 once when a
   lane is rescued);
14. the J/R engines: ``solve_batch`` at batch 1024 (the torch init, then
   K10 once and no other kernel), K10 against its plain version on the same
   state (the same status, iterations and active set on >= 0.999 of the
   lanes, x within 1e-10 on those, KKT <= 1e-8 on every SUCCESS lane; the
   plain version run as the traced pass loop, which launches no kernel),
   K10's device ms beside its plain version's and its bound, in f64 and in
   f32 (``solve_mixed``'s first stage; >= 0.99 of the lanes the same);
   ``solve_batch`` against the main path (same status and active set, x
   within 1e-7), ``solve_warm`` from its active set (0 iterations), and
   ``solve_structured`` at the IK width, batch 256, against
   ``solve_structured_fast_batch``;
15. observability on 256 lanes: ``solve_fast_traced`` against K11's plain
   version (bit for bit) and ``solve_fast`` (K11, lane for lane), and
   ``solve_traced`` against K10's plain version (bit for bit) and
   ``solve_batch`` (K10, lane for lane),
   ``capture_kernel_trajectory`` on one lane
   (one K9 launch per cap) against the f32 fast trace, ``dump_matlab``, and
   ``no_retrace`` around repeated solves at two shapes;
16. the small solvers: the closed-form ``solve_box`` at batch 16384, n=16
   (the box benchmark's data, numpy seed 0), KKT <= 1e-8 on every SUCCESS
   lane and held against ``solve_box_gi`` on 1024 lanes, with solves/s;
   ``solve_mixed`` at batch 1024 of the headline set (K10 in f32, then in
   f64), gated like the main path and held against the f64 ``solve_batch``;
17. ``solve_refined_kernel(..., fused_init=False)`` (the torch init, then
   K3) at batch 16384, gated like the main path; ``solve_sharded`` with the
   engines "pallas" (K1, then K3), "f64" (K10) and "refined" (K11) over
   ``make_mesh()``
   (every card; the cards' K1 and K3 shards solved at the same time, a host
   thread per card) and over four shards on ``cuda:0`` (one after another on the
   card's one stream), each lane for lane
   against its unsharded solve and bit for bit against its shards solved
   alone, its ``BatchStats`` against the result's sums, with each shard's
   engine call and kernel start and end (ms, CUDA events on a clock shared
   by the cards, ``testing.shard_timeline``) and how far the shards'
   kernels overlap; the one-card mesh's overhead against the bare engine;
18. the corpus: ``run_corpus`` over the vendored Maros-Meszaros files of
   ``tests/data/qps/`` -- the 8 strictly convex ones through "f64" and
   "pallas_rescued" (SUCCESS, f* within 1e-6, KKT <= 1e-8) and through
   "refined" and "pallas" (printed, not gated), the 8 singular ones
   through the unbucketed "f64" (SUCCESS at f*, or NON_POS_HESSIAN) -- and
   four synthesized problems of n up to 128 through "pallas_rescued",
   whose (128, 128) bucket runs K3 at (np, mp) = (136, 128); K3 against its
   plain version at that shape on 64 lanes of the headline distribution.
19. the benchmark harness (``jrlqp_tpu_torch.bench``) on the card:
   ``time_batch`` at the headline set ("pallas" and "pallas_rescued" at
   batch 16384, "f64", "mixed" and "refined" at 1024); the size sweep on
   K1 at batch 16384 up to n=100, m=200 (one block per SM there), with K1's
   device ms, shared memory and residency per size, K1 held to its plain
   version on the sweep's draws at each size (the whole batch at n <= 25,
   1024 lanes above), and each lane the row misses solved again by the
   plain version and the f64 J/R engine; the active-fraction sweep on K1;
   the warm-start trajectory on K1 and 11 K4 steps at batch 16384, and on
   the f64 J/R engine at batch 256; K5, K6 and K7 held to their plain
   versions on the decompositions' draws (s=48), then the decompositions
   (K5, K7, K5 + K6 beside the composed chains and
   ``torch.linalg.cholesky``) and the structured IK batch at batch 1024; the box batch; the scaling
   capture (mesh 1 on one card); the compacted solve
   ``solve_refined_kernel_compacted`` at batch 16384 (K3 twice) against one
   K3 launch lane for lane, with its phase-2 lane count; and the host C++
   QPS reader (built in phase 1) against the Python one on the vendored files. The kernel rows are gated where
   PERF.md section 2 gates the configuration and must show their kernel's
   launches; the other rows print their rates ungated.
20. the missed lanes: every lane of ``tests/data/missed_lanes_port.npz``
   (the lanes the port's kernels or their plain versions miss on the card,
   from ``python3 -m jrlqp_tpu_torch.testing.miss_census``) and of
   ``tests/data/missed_lanes_jax.npz`` (the lanes the JAX package misses on
   its own draws) solved alone by its path's kernel (K1, K3 or K9) and the
   kernel's plain version, each held to its recorded status, iterations,
   pass or fail and active set; the main path's missed lanes of phase 4
   held to the census's (the same lanes, the same arrays); one line with
   the counts per set and how many lanes each package passes of the
   other's misses; K1's whole solve replayed on this host's CPU in K1's
   own order (``jrlqp_tpu_torch.testing.k1_replay.k1_order_solve``) on
   every K1 lane of both files and held to K1's own launch on the same
   lane, the whole f32 state bit for bit, with the replay's CPU seconds;
   and K1's per-operation split on the three lanes of
   queue 3d (``jrlqp_tpu_torch.testing.op_split``): its states at the
   census's caps taken again on the card and held to
   ``tests/data/split_states_card.npz`` bit for bit, each iteration
   replayed in K1's order and held to the next state, and the deciding
   slack's error at the parting split into the dot's own rounding, the x
   error inherited from the previous vertex, and what the last step added;
   and every lane with an f64 J/R record (``f64_jr_card``) solved alone by
   ``solve_batch`` (K10) and held to its status, pass and x within 1e-7.

Every kernel's line in the JSON record carries ``bound_ms``, the least time
the card could take for the kernel's work on this run's inputs: the larger
of the bytes it must move (each input read once, each output written once)
at 3.35 TB/s and its operations at 67 TFLOP/s (f32 outside the tensor
cores; H100 SXM data sheet), or 33.5 TFLOP/s for K10, K11, K13 and K14 in
f64. Both are counted at the unpadded sizes, from this run's iteration and
active counts, with triangular factors counted as triangles, by
``_gi_flops``, ``_gi_bytes``, ``jr_kernel.jr_flops``,
``jr_kernel.jr_bytes``, ``fast_loop.fast_loop_flops``,
``fast_loop.fast_loop_bytes``, the phase 4 and 8 blocks and phase 9's
``refine_kernels_check``. Phase 9's own K11 line (not the ``kernels`` line) also
carries ``stream_ms``, a model and not a measurement: the bytes K11's
design moves (H, N* and G stay in device memory and are streamed every
iteration, ``fast_loop.fast_loop_stream_bytes``) over 3.35 TB/s.
``library_ms`` is the time of PyTorch's own calls for the same function
where there are some: ``torch.linalg.cholesky_ex`` then
``torch.linalg.solve_triangular`` on the identity beside K2 (two calls,
named in its ``library`` key), ``torch.linalg.cholesky_ex`` of the dense G
beside K5 and K7, ``torch.cholesky_solve`` with the dense factor beside K6
and K8; else null. Phases 2 and 3 print the sha1 digests of K2's outputs
and of K1's outputs at iteration cap 0 (its prologue), phase 8 K5's, K7's
(down and up) and K6's, so two versions of the kernels can be compared bit
for bit. The lines of the four GI kernels, K5 and K7 also carry their
threads per block and resident blocks per SM, and the run prints the GI
kernels' µs per GI iteration per resident block (ms x SMs x blocks per SM
/ the iterations of the timed launch; for K3 and K4, whose launches run about
two iterations, the figure is mostly their state load and closed form, and
is printed as such).

Each path runs with the launch counts set to 0 just before it and read
just after; phases 16-19 print one JSON line per path with its wall ms and
counts. Any failed check raises, so the exit code is nonzero. The last
two lines of standard output are the per-kernel JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N, M, ACT_FRAC, MAX_ITER, IR_STEPS = 50, 100, 0.3, 150, 1
WARM_ACT_FRAC = 0.4  # the warm-start workload (harness.py:194-223)
BATCH = 16384        # main path and warm paths (the headline batch)
CHECK_BATCH = 1024   # kernel-vs-plain comparisons
K2_BATCH = 4096      # K2-vs-plain comparison
STEPS, DRIFT = 10, 0.02
HINT_IR_STEPS, HINT_MIN_RATE = 3, 0.998  # the hint step's (see phase 7)
SEED = 0
IK_NB, IK_S, IK_MC = 9, 43, 4  # the reference's Sequential IK
IK_BATCH, IK_MAX_ITER, IK_IR_STEPS = 1024, 200, 3
IK_STEPS, IK_DRIFT = 10, 0.02
RESCUE_ACT_FRAC = 0.9       # phase 13's hard set
OBS_BATCH, SJR_BATCH = 256, 256
BOX_BATCH, BOX_N = 16384, 16  # the box benchmark (harness.py:375-407)
DEC_NB, DEC_S = 9, 48       # bench_decompositions' default chain
SWEEP_SIZES = (10, 25, 50, 75, 100)  # bench_size_sweep's n, at m = 2n
# phase 20's lanes, written by the miss census (tests/missed_lanes_census.py)
MISSED_LANE_FILES = {w: os.path.join(ROOT, "tests", "data",
                                     f"missed_lanes_{w}.npz")
                     for w in ("port", "jax")}
# the card's kernel states around each of its slack partings
# (miss_census --states), and the three lanes of queue 3d whose split
# phase 20 prints from this run's own states
SPLIT_STATES_FILE = os.path.join(ROOT, "tests", "data",
                                 "split_states_card.npz")
SPLIT_3D_LANES = (("port", "headline-3-9615"),
                  ("port", "size_sweep-0-n100-6448"),
                  ("jax", "headline-6-13413"))
# the vendored corpus (tests/test_corpus.py:137-140) and the synthesized
# large buckets, (n, n_ineq, n_strong_active, bounds, double_sided)
# (tests/test_corpus.py:184-190), drawn with numpy seed 7 as that test does
VENDORED_STRICT = ("hs21", "hs35", "hs35mod", "hs76", "qptest", "hs118",
                   "hs268", "s268")
VENDORED_SINGULAR = ("hs51", "hs52", "hs53", "genhs28", "tame",
                     "cvxqp1_s", "cvxqp2_s", "cvxqp3_s")
LARGE_SPECS = ((48, 40, 16, False, False), (64, 50, 20, False, True),
               (96, 80, 30, False, False), (128, 100, 40, True, False))
PEAK_F32, PEAK_BW = 67e12, 3.35e12   # H100 SXM: FLOP/s (f32, no TC), B/s
PEAK_F64 = 33.5e12                   # H100 SXM: FLOP/s (f64, no TC)


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


def _wall_s(fn, reps: int = 3) -> float:
    """Best wall-clock seconds of ``fn``, closed by a synchronize."""
    import torch

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    return best


def _sha1(*tensors) -> str:
    """First 12 hex digits of the sha1 of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def _bound(flops: float, nbytes: int, peak: float = PEAK_F32):
    """(bound ms, what binds): the larger of the operation and byte times,
    at the operations' ``peak`` FLOP/s."""
    t_op, t_b = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BW
    return (max(t_op, t_b), "operations" if t_op >= t_b else "bytes")


def _gi_flops(it, q0, q_end, n: int, m: int) -> float:
    """FLOPs of GI loop iterations at (n, m), summed over the lanes; ``it``,
    ``q0`` and ``q_end`` are (B,) tensors of each lane's iterations and its
    active count at the start and at the end. Per iteration: the selection
    C x (2mn), z = H n+ (2n^2) and r = N* n+ over the q active rows (2nq),
    and the rank-one update of H (2n^2) and of those q rows of N* (2nq). A
    lane's q summed over its iterations is taken as it (q0 + q_end - 1) / 2,
    exact for a lane that only adds."""
    it, q0, q_end = (v.double() for v in (it, q0, q_end))
    q_sum = (it * (q0 + q_end - 1) / 2).clamp_min(0)
    return float((it * (2 * m * n + 4 * n * n) + 4 * n * q_sum).sum())


def _gi_bytes(batch: int, n: int, m: int, state_words: int) -> int:
    """Bytes a GI kernel must move at the unpadded (n, m), 4 per f32 or
    i32 word: the problem (G, C, l, u, xl, xu), ``state_words`` per problem
    of what it starts from, and its outputs (x, u, status, aorder, eight
    scalars, K = [H | N*^T] and tr0)."""
    problem = n * n + m * n + 2 * m + 2 * n
    outputs = 2 * n * n + 4 * n + m + 9
    return 4 * batch * (problem + state_words + outputs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import jrlqp_tpu_torch  # noqa: F401  (pins full-f32 matmuls)
    from jrlqp_tpu_torch import (
        LogFlags,
        SolverOptions,
        capture_kernel_trajectory,
        dump_matlab,
        no_retrace,
        solve_batch,
        solve_fast,
        solve_fast_traced,
        solve_refined_kernel,
        solve_refined_kernel_carry,
        solve_refined_kernel_compact,
        solve_refined_kernel_rescued,
        solve_refined_warm_kernel,
        solve_traced,
        solve_warm,
    )
    from jrlqp_tpu_torch.ops.cuda import (
        _build,
        block_llt,
        carry_init,
        fast_loop,
        gi_kernel,
        jr_kernel,
        struct_refine,
    )
    from jrlqp_tpu_torch.solver import dense, fast
    from jrlqp_tpu_torch.structured import (
        GType,
        solve_structured,
        solve_structured_fast_batch,
        solve_structured_fast_carry,
        structured_from_numpy,
        structured_qp_problem,
    )
    from jrlqp_tpu_torch.structured import solver as ssolver
    from jrlqp_tpu_torch.testing.batch_gen import random_qp_batch
    from jrlqp_tpu_torch.testing.ik_gen import ik_batch, ik_step
    from jrlqp_tpu_torch.testing.kkt import kkt_residual
    from jrlqp_tpu_torch import pad_problem, solve_box, solve_mixed
    from jrlqp_tpu_torch.solver.mixed import F32_ZERO_Z
    from jrlqp_tpu_torch.io import run_corpus, write_qps
    from jrlqp_tpu_torch.io.maros_meszaros import (
        MAROS_MESZAROS,
        MarosMeszarosEntry,
    )
    from jrlqp_tpu_torch.parallel import make_mesh, shard_batch, solve_sharded
    from jrlqp_tpu_torch.testing import shard_timeline
    from jrlqp_tpu_torch.utils import spans
    from jrlqp_tpu_torch.solver.box_single import box_qp_problem, solve_box_gi
    from jrlqp_tpu_torch.testing import ProblemCharacteristics, random_problem
    from jrlqp_tpu_torch import solve_refined_kernel_compacted
    from jrlqp_tpu_torch.bench import harness
    from jrlqp_tpu_torch.io import native, read_qps
    from jrlqp_tpu_torch.types import MAX_ITER_REACHED
    from jrlqp_tpu_torch.testing import (
        fast_parting,
        k1_replay,
        miss_census,
        op_split,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f32, f64 = torch.float32, torch.float64
    np_ = gi_kernel._round_up(N + 1, 8)
    opt = SolverOptions(max_iter=MAX_ITER)
    opt_w = opt.with_(warm_start=True)
    opt32_w = opt_w.with_(dtype=f32, zero_z_threshold=1e-6)

    def reset_counts():
        spans.reset("launch")

    def counts():
        return {"gi_fused": gi_kernel.launches,
                "chol_inv_b": block_llt.launches,
                "gi_loop": gi_kernel.loop_launches,
                "gi_warm": gi_kernel.warm_launches,
                "gi_compact": gi_kernel.compact_launches,
                "tri_block_llt": block_llt.tri_llt_launches,
                "tri_block_solve": block_llt.tri_solve_launches,
                "block_arrow_llt": block_llt.arrow_llt_launches,
                "block_arrow_solve": block_llt.arrow_solve_launches,
                "jr_loop": jr_kernel.launches,
                "fast_loop": fast_loop.launches,
                "struct_gmul": spans.counter("launch.K13"),
                "struct_update": spans.counter("launch.K14"),
                "carry_init": spans.counter("launch.K12")}

    def drifted(pb, scale):
        """``pb`` with l and u shifted together by scale * N(0, 1)."""
        d = scale * torch.randn(pb.l.shape, generator=gen, device=dev,
                                dtype=f32).to(pb.l.dtype)
        return dataclasses.replace(pb, l=pb.l + d, u=pb.u + d)

    def gate(name, res, pbs, min_rate=0.999):
        """KKT <= 1e-8 & SUCCESS on >= min_rate of the lanes."""
        _require(res.x.shape == (pbs.batch, pbs.n)
                 and res.multipliers.shape == (pbs.batch, pbs.m + pbs.n),
                 f"{name}: output shapes")
        _require(bool(torch.isfinite(res.x).all()), f"{name}: non-finite x")
        resid = kkt_residual(res.x, res.multipliers, pbs)
        passed = (resid <= 1e-8) & (res.status == 0)
        rate = float(passed.double().mean())
        _require(rate >= min_rate, f"{name}: pass rate {rate} < {min_rate}")
        return rate, float(resid.max()), passed

    def against_plain(name, ok_k, ok_p, pb64, same_path=False):
        """Kernel vs plain outputs: term may differ on <= 0.1% of the
        lanes, it, status and aorder on <= 1%; raw x, u, H and Ns within
        1e-4 times max(1, the lane's largest entry) on the lanes that take
        the same path and end SUCCESS (far from the start, near a vertex,
        multipliers reach tens and the summation order moves them by ~1e-4
        relative); refined x within 1e-7 on the lanes SUCCESS in both, or
        with ``same_path`` on those of them that took the same path (at
        full width an f32 near-tie sends a lane down another path in one
        of the two, to another active set whose refined x lies ~1e-6 away;
        the path gates count those lanes). Returns the max raw f32
        error."""
        Bc = pb64.batch
        differ = {k: ok_k[k] != ok_p[k] for k in ("term", "it", "q",
                                                   "status", "aorder")}
        differ = {k: (v.any(dim=1) if v.dim() == 2 else v)
                  for k, v in differ.items()}
        cnt = {k: int(v.sum()) for k, v in differ.items()}
        print(f"{name} vs plain: {Bc} lanes; lanes that differ: {cnt}")
        _require(cnt["term"] <= 0.001 * Bc,
                 f"{name} term differs on > 0.1% of lanes")
        for k in ("it", "status", "aorder"):
            _require(cnt[k] <= 0.01 * Bc,
                     f"{name} {k} differs on > 1% of lanes")
        same = ~torch.stack(list(differ.values())).any(dim=0)
        ok = same & (ok_p["term"] == 0)
        raw, scaled = {}, {}
        for k in ("x", "u", "H", "Ns"):
            e = (ok_k[k][ok] - ok_p[k][ok]).abs().flatten(1).amax(dim=1)
            mag = ok_p[k][ok].abs().flatten(1).amax(dim=1).clamp_min(1.0)
            raw[k], scaled[k] = float(e.max()), float((e / mag).max())
        err = max(raw.values())
        print(f"{name} vs plain raw f32 outputs on {int(ok.sum())} lanes "
              f"with the same path ending SUCCESS ({int((same & ~ok).sum())}"
              f" same-path lanes end otherwise): max |err| {raw}, "
              f"max |err| / max(1, |lane|) {scaled}")
        _require(max(scaled.values()) <= 1e-4,
                 f"{name} raw x/u/H/Ns differ from plain by > 1e-4 "
                 f"max(1, |lane|)")
        rk = fast._refine_batch(pb64, fast._state_from_kernel_out(ok_k, Bc),
                                IR_STEPS)
        rp = fast._refine_batch(pb64, fast._state_from_kernel_out(ok_p, Bc),
                                IR_STEPS)
        both = (rk.status == 0) & (rp.status == 0)
        if same_path:
            off = both & ~same
            print(f"{name}: lanes SUCCESS in both on another path: "
                  f"{off.nonzero()[:, 0].tolist()[:8]}, refined |x err| "
                  f"{(rk.x[off] - rp.x[off]).abs().amax(1).tolist()[:8]}")
            both = both & same
        ref_err = float((rk.x[both] - rp.x[both]).abs().max())
        print(f"{name} vs plain after refinement: {int(both.sum())} lanes "
              f"SUCCESS in both{' on the same path' * same_path}, max |x "
              f"err| {ref_err:.3e}")
        _require(ref_err <= 1e-7,
                 f"{name} refined x differs from plain by > 1e-7")
        return err

    struct_err = {"K5": 0.0, "K6": 0.0, "K7": 0.0, "K8": 0.0}

    def rel_err(ours, ref):
        return float((ours - ref).abs().max()
                     / ref.abs().max().clamp_min(1.0))

    def chain_pairs(kind, d32, o32, eye):
        """[(output, kernel, plain)] of one chain kind: the factorization
        and the solve on the identity ``eye``, on the same factor."""
        if kind.startswith("tri"):
            fac = block_llt.tri_block_llt(d32, o32)
            fac_p = block_llt.tri_block_llt_plain(d32, o32)
            lower = kind == "tri_lower"
            y = block_llt.tri_block_solve(fac[1], fac[2], eye, lower)
            y_p = block_llt.tri_block_solve_plain(fac[1], fac[2], eye, lower)
        else:
            up = kind == "arrow_up"
            fac = block_llt.block_arrow_llt(d32, o32, up=up)
            fac_p = block_llt.block_arrow_llt_plain(d32, o32, up=up)
            y = block_llt.block_arrow_solve(fac[1], fac[2], eye, up=up)
            y_p = block_llt.block_arrow_solve_plain(fac[1], fac[2], eye,
                                                    up=up)
        return [("factor", k, p) for k, p in zip(fac, fac_p)] + [
            ("solve", y, y_p)]

    def hold_chains(kinds, d32, o32, eye, where):
        """Each chain kind's kernels against their plain versions on
        (d32, o32) and the identity: every output within 1e-5 relative
        (to max(1, |plain|)); the largest |err| goes into ``struct_err``.
        Returns {kind: max relative error}."""
        rels = {}
        for kind in kinds:
            pairs = chain_pairs(kind, d32, o32, eye)
            torch.cuda.synchronize()
            for what, k, p in pairs:
                _require(k.shape == p.shape and bool(torch.isfinite(k).all()),
                         f"{kind} {what} ({where}): shape or non-finite "
                         f"output")
                rel = rel_err(k, p)
                _require(rel <= 1e-5, f"{kind} {what} ({where}): kernel vs "
                         f"plain {rel} > 1e-5 relative")
                name = {("tri", "factor"): "K5", ("tri", "solve"): "K6",
                        ("arr", "factor"): "K7", ("arr", "solve"): "K8"}[
                            (kind[:3], what)]
                struct_err[name] = max(struct_err[name],
                                       float((k - p).abs().max()))
            rels[kind] = max(rel_err(k, p) for _, k, p in pairs)
            print(f"K5-K8 vs plain ({kind}, {where}): max |err| / max(1, "
                  f"|plain|) {rels[kind]:.3e}")
        return rels

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
          f"(nvcc, one process per source, {_build.build_info['seconds']:.2f}"
          f" s, cached={_build.build_info['cached']})")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the host C++ readers build here too (g++, csrc/host/), outside every
    # timed window: run_corpus (phase 18) reads through read_qps("auto")
    _require(native.available(), f"native readers: {native._load_error}")
    print(f"native readers: {native.build_info}")

    def residency(entry, ms, iters, prologue=""):
        """Threads per block and blocks per SM of a GI kernel at (N, M),
        printed with its µs per GI iteration per resident block; K3's and
        K4's few iterations leave their entry (``prologue``) in that
        figure, so it is labelled with it."""
        threads, blocks = gi_kernel.residency(entry, N, M)
        us = 1e3 * ms * sms * blocks / max(iters, 1)
        incl = f", {prologue} included" if prologue else ""
        print(f"{entry}: {threads} threads per block, {blocks} blocks per "
              f"SM ({sms} SMs), {us!r} µs per GI iteration per resident "
              f"block{incl} ({card})")
        return {"threads": threads, "blocks_per_sm": blocks}

    print(f"shared memory per block (gi_fused, gi_loop, gi_warm and "
          f"gi_compact share one "
          f"layout): {lib.jrlqp_gi_smem_bytes(np_, gi_kernel._round_up(M, 8))}"
          f" B")

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
    print(f"K2 output digests (sha1): L {_sha1(L)}, L^-1 {_sha1(Li)}, "
          f"posdef {_sha1(pd)}")

    # ---- phase 3: K1 (fused GI) vs plain, then both refined ----
    pbc = random_qp_batch(gen, CHECK_BATCH, N, M, ACT_FRAC, dtype=f32)
    ins3, (n, m) = gi_kernel.prepare(pbc)
    prologue = gi_kernel._gi_fused_cuda_raw(*ins3, n, m, 0)
    print("K1 prologue output digests (sha1, iteration cap 0): "
          + ", ".join(f"{k} {_sha1(v)}" for k, v in zip(
              ("x", "u", "status", "aorder", "scal", "K", "hscale"),
              prologue)))
    del ins3, prologue
    ok_k = gi_kernel.run_loop_fused(pbc, MAX_ITER)
    ok_p = gi_kernel.gi_fused_plain(pbc, MAX_ITER)
    torch.cuda.synchronize()
    k1_err = against_plain("K1", ok_k, ok_p, pbc.with_dtype(f64))

    # ---- phase 4: the main path ----
    def problems(act_frac=ACT_FRAC):
        # made in f32, solved in f64, as bench.py:96-97 does
        return random_qp_batch(gen, BATCH, N, M, act_frac,
                               dtype=f32).with_dtype(f64)

    pbs = problems()
    torch.cuda.synchronize()
    reset_counts()
    res = solve_refined_kernel(pbs, opt, ir_steps=IR_STEPS)
    torch.cuda.synchronize()
    main_counts = counts()
    # K2 has no launch of its own on the main path: its device functions
    # run inside K1's prologue, so its count stays 0 here
    print(f"main path launches: {main_counts}")
    _require(main_counts["gi_fused"] > 0, "main path did not launch K1")
    rate, max_kkt, passed4 = gate("main path", res, pbs)
    # phase 20 holds these lanes to the census's record of the same draws
    missed4 = torch.nonzero(~passed4)[:, 0].tolist()
    census_lanes = {miss_census.lane_id(r): r for r in
                    miss_census.load_lanes(MISSED_LANE_FILES["port"])[0]
                    if r["set"] == "headline" and r["seed"] == SEED}
    arrays4 = {r["lane"]: {k: getattr(pbs, k)[r["lane"]].cpu().numpy()
                           for k in miss_census.ARRAYS}
               for r in census_lanes.values()}
    mean_it = float(res.iterations.double().mean())
    max_it = int(res.iterations.max())
    print(f"main path: batch {BATCH}, n={N}, m={M}: KKT<=1e-8 & "
          f"SUCCESS rate {rate!r}, max KKT {max_kkt!r}, "
          f"mean_it {mean_it!r}, max_it {max_it}")

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
    # library yardstick of K2 (2 calls): the Cholesky, then L^-1 by a
    # triangular solve on the identity
    eye_main = torch.eye(np_, device=dev).expand(BATCH, np_, np_)
    k2_lib_ms = _cuda_ms(lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky_ex(G_main)[0], eye_main, upper=False))
    del eye_main
    print(f"device ms at batch {BATCH} ({card}): K1 {k1_ms!r} "
          f"(plain {k1_plain_ms!r}), K2 {k2_ms!r} (plain {k2_plain_ms!r}, "
          f"library: torch.linalg.cholesky_ex + solve_triangular, 2 calls, "
          f"{k2_lib_ms!r})")
    outs1 = gi_kernel._gi_fused_cuda_raw(*inputs, n, m, MAX_ITER)
    it1 = int(outs1[4][:, 1].sum())
    # K1's loop starts at q = the equalities and fixed variables it replays;
    # prologue: Cholesky, L^-1, H0 = L^-T L^-1 (~n^3) and x0 (2n^2)
    q0_1 = (pbs.l == pbs.u).sum(dim=1) + (pbs.xl == pbs.xu).sum(dim=1)
    k1_bound = _bound(_gi_flops(outs1[4][:, 1], q0_1, outs1[4][:, 0], N, M)
                      + BATCH * (N ** 3 + 2 * N * N),
                      _gi_bytes(BATCH, N, M, N))
    # K2 on the n x n G (its padding is the identity): Cholesky and
    # triangular inverse, 2/3 n^3; G's lower triangle in, L and L^-1 out
    k2_bound = _bound(BATCH * 2 / 3 * N ** 3,
                      4 * BATCH * 3 * N * (N + 1) // 2)
    print(f"bounds ({card}): K1 {k1_bound} ({it1} iterations), K2 {k2_bound}")
    res_k1 = residency("jrlqp_gi_fused", k1_ms, it1)
    del inputs, G_main, outs1

    # ---- phase 5: K3 (loop from a given state) vs plain ----
    base5 = random_qp_batch(gen, CHECK_BATCH, N, M, WARM_ACT_FRAC,
                            dtype=f32).with_dtype(f64)
    hints = solve_refined_kernel(base5, opt, ir_steps=IR_STEPS).active_set
    half = hints.clone()
    half[:, ::2] = 0
    pb5 = drifted(base5, DRIFT)
    pb5_32 = pb5.with_dtype(f32)
    k3_err = 0.0
    for label, h in (("cold active set", hints),
                     ("every second cleared", half)):
        state0 = fast._init_fast_warm(pb5_32, h, opt32_w)
        ok_k = gi_kernel.run_loop(pb5_32, state0, MAX_ITER)
        ok_p = gi_kernel.gi_loop_plain(pb5_32, state0, MAX_ITER)
        torch.cuda.synchronize()
        k3_err = max(k3_err, against_plain(f"K3 ({label} hints)", ok_k,
                                           ok_p, pb5))

    # ---- phase 6: K4 (loop from a carried operator) vs plain ----
    _, carry6 = solve_refined_kernel_carry(base5, None, opt,
                                           ir_steps=IR_STEPS)
    co6 = (carry6.H, carry6.Ns, carry6.status, carry6.aorder, carry6.q)
    k4_err = 0.0
    for scale in (DRIFT, 0.5):
        pb6 = drifted(base5, scale)
        ins6, (n, m) = gi_kernel.prepare_warm_carry(
            pb6, carry6.raw, carry6.q, carry6.reset, carry6.first)
        ok_k = gi_kernel.postprocess(
            gi_kernel._gi_warm_cuda_raw(*ins6, n, m, MAX_ITER), n, m)
        ok_p = gi_kernel.postprocess(
            gi_kernel._gi_warm_plain_raw(*ins6, n, m, MAX_ITER), n, m)
        torch.cuda.synchronize()
        k4_err = max(k4_err, against_plain(f"K4 (drift {scale})", ok_k,
                                           ok_p, pb6))
        # the same step from the five plain tensors: K0 is then packed
        # anew, with zeros where K1 left the identity on H's padded
        # diagonal, which no output may feel
        ok_t = gi_kernel.run_warm_loop(pb6.with_dtype(f32), *co6, MAX_ITER)
        _require(all(torch.equal(ok_k[k], ok_t[k]) for k in ok_k),
                 f"K4 (drift {scale}): the carry of plain tensors gives "
                 f"another step than the kernel-layout carry")
    print("K4: the carry of plain tensors gives the kernel-layout carry's "
          "step, bit for bit")
    del base5, pb5, pb5_32, carry6, co6, ok_k, ok_p, ok_t, ins6

    # ---- phase 7: the warm paths at full width ----
    base7 = problems(WARM_ACT_FRAC)
    steps = [drifted(base7, DRIFT) for _ in range(STEPS)]
    torch.cuda.synchronize()
    reset_counts()
    res, carry = solve_refined_kernel_carry(base7, None, opt,
                                            ir_steps=IR_STEPS)
    warm = []
    for pbw in steps:
        carry_in = carry
        res, carry = solve_refined_kernel_carry(pbw, carry, opt,
                                                ir_steps=IR_STEPS)
        warm.append(res)
    torch.cuda.synchronize()
    traj_counts = counts()
    print(f"trajectory launches (cold step + {STEPS} warm steps): "
          f"{traj_counts}")
    _require(traj_counts["gi_fused"] == 1 and traj_counts["gi_warm"] == STEPS,
             "the trajectory did not run K1 once and K4 on every warm step")

    def against_cold(name, res_w, pbw, min_rate=0.999):
        """The gate, and warm x against a cold solve's on the lanes that
        pass the gate in both with the same active set (a lane that ends
        SUCCESS above the KKT limit counts against the pass rate)."""
        res_c = solve_refined_kernel(pbw, opt, ir_steps=IR_STEPS)
        rate, max_kkt, passed = gate(name, res_w, pbw, min_rate)
        passed_c = kkt_residual(res_c.x, res_c.multipliers, pbw) <= 1e-8
        same = (res_w.active_set == res_c.active_set).all(dim=1)
        both = same & (res_w.status == 0) & (res_c.status == 0)
        ok = both & passed & passed_c
        x_err = float((res_w.x[ok] - res_c.x[ok]).abs().max())
        _require(x_err <= 1e-7, f"{name}: |x_warm - x_cold| {x_err} > 1e-7")
        row = dict(
            warm_mean_it=float(res_w.iterations.double().mean()),
            warm_max_it=int(res_w.iterations.max()),
            cold_mean_it=float(res_c.iterations.double().mean()),
            cold_max_it=int(res_c.iterations.max()),
            same_active_set=float(same.double().mean()),
            pass_rate=rate, max_kkt=max_kkt, x_err=x_err,
            same_set_success_above_kkt=int((both & ~ok).sum()))
        print(f"{name}: {row}")
        return row

    rows = [against_cold(f"warm step {s + 1}", r, p)
            for s, (r, p) in enumerate(zip(warm, steps))]
    print(f"warm steps: mean_it {sum(r['warm_mean_it'] for r in rows) / STEPS!r}"
          f" (cold {sum(r['cold_mean_it'] for r in rows) / STEPS!r})")

    # the hint path: step 10's batch from step 9's active set. Its f32
    # warm init (shared with the JAX package) keeps hinted constraints
    # whose multiplier lies in [-1e-5, 0) and builds H and N* from an f32
    # Cholesky of M = N^T G^-1 N; ~0.3% of the lanes end SUCCESS above
    # KKT 1e-8 after one refinement step and 0.05-0.11% after two or more,
    # as in the JAX package. So it runs the entry point's default 3 steps
    # and is gated at 0.998; its pass rate with 1 step is printed.
    pb10, hints9 = steps[-1], warm[-2].active_set
    reset_counts()
    res_h = solve_refined_warm_kernel(pb10, hints9, opt_w,
                                      ir_steps=HINT_IR_STEPS)
    torch.cuda.synchronize()
    hint_counts = counts()
    print(f"hint path launches: {hint_counts}")
    _require(hint_counts["gi_loop"] == 1, "the hint path did not run K3")
    against_cold(f"hint step (ir_steps {HINT_IR_STEPS})", res_h, pb10,
                 HINT_MIN_RATE)
    res_h1 = solve_refined_warm_kernel(pb10, hints9, opt_w,
                                       ir_steps=IR_STEPS)
    passed1 = ((kkt_residual(res_h1.x, res_h1.multipliers, pb10) <= 1e-8)
               & (res_h1.status == 0))
    print(f"hint step (ir_steps {IR_STEPS}, not gated): KKT<=1e-8 & SUCCESS "
          f"rate {float(passed1.double().mean())!r}")

    # K4 at full width on step 10's inputs as the trajectory hands them
    # (the carry's own reset flags and cold state), with every other lane
    # flagged besides, so that both of K4's starts meet its plain version;
    # and a flagged lane's step is K4's step from the cold state itself,
    # bit for bit
    reset10 = int(carry_in.reset.sum())
    print(f"K4 inputs of warm step 10: {reset10} of {BATCH} lanes flagged "
          f"for reset by step 9")
    flags = carry_in.reset | (torch.arange(BATCH, device=dev) % 2).to(
        torch.int32)
    ins7, (n, m) = gi_kernel.prepare_warm_carry(
        pb10, carry_in.raw, carry_in.q, flags, carry_in.first)
    ok_k = gi_kernel.postprocess(
        gi_kernel._gi_warm_cuda_raw(*ins7, n, m, MAX_ITER), n, m)
    ok_p = gi_kernel.postprocess(
        gi_kernel._gi_warm_plain_raw(*ins7, n, m, MAX_ITER), n, m)
    ins_c, _ = gi_kernel.prepare_warm_carry(
        pb10, carry_in.raw[:2] + carry_in.first[:3], carry_in.first[3],
        torch.zeros_like(flags), carry_in.first)
    from_cold = gi_kernel.postprocess(
        gi_kernel._gi_warm_cuda_raw(*ins_c, n, m, MAX_ITER), n, m)
    torch.cuda.synchronize()
    put = flags.bool()
    _require(all(torch.equal(ok_k[k][put], from_cold[k][put])
                 for k in ok_k),
             "K4: a lane flagged for reset does not take the step from the "
             "cold state")
    print(f"K4 (batch {BATCH}): the {int(put.sum())} flagged lanes take the "
          f"step from the cold state, bit for bit")
    k4_err = max(k4_err, against_plain(
        f"K4 (batch {BATCH}, every other lane reset)", ok_k, ok_p, pb10,
        same_path=True))
    del ins7, ins_c, ok_k, ok_p, from_cold, flags, put

    # timing on step 10's batch
    pb10_32 = pb10.with_dtype(f32)
    co = (carry_in.H, carry_in.Ns, carry_in.status, carry_in.aorder,
          carry_in.q)
    carry_plain = fast.WarmCarry(*co)   # no kernel layout: packed each step
    state0 = fast._init_fast_warm(pb10_32, hints9, opt32_w)
    wall = {
        "warm K4 step": _wall_s(lambda: solve_refined_kernel_carry(
            pb10, carry_in, opt, ir_steps=IR_STEPS)),
        "warm K4 step from a carry of plain tensors": _wall_s(
            lambda: solve_refined_kernel_carry(pb10, carry_plain, opt,
                                               ir_steps=IR_STEPS)),
        "cold K1 step": _wall_s(lambda: solve_refined_kernel(
            pb10, opt, ir_steps=IR_STEPS)),
        "hint step": _wall_s(lambda: solve_refined_warm_kernel(
            pb10, hints9, opt_w, ir_steps=HINT_IR_STEPS)),
        "hint step: torch warm init": _wall_s(lambda: fast._init_fast_warm(
            pb10_32, hints9, opt32_w)),
        "hint step: K3": _wall_s(lambda: gi_kernel.run_loop(
            pb10_32, state0, MAX_ITER)),
        "K3 plain": _wall_s(lambda: gi_kernel.gi_loop_plain(
            pb10_32, state0, MAX_ITER)),
        "K4 with its packing from plain tensors": _wall_s(
            lambda: gi_kernel.run_warm_loop(pb10_32, *co, MAX_ITER)),
        "K4 plain": _wall_s(lambda: gi_kernel.gi_warm_plain(
            pb10_32, *co, MAX_ITER)),
    }
    for k, s in wall.items():
        print(f"solves/s (best of 3, batch {BATCH}, {card}): {k} "
              f"{BATCH / s!r} ({s * 1e3!r} ms)")

    def split7():
        """Wall ms of a warm step's stages, each closed by a sync."""
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        ins, (n_, m_) = gi_kernel.prepare_warm_carry(
            pb10, carry_in.raw, carry_in.q, carry_in.reset, carry_in.first)
        mark()
        raw = gi_kernel._gi_warm_cuda_raw(*ins, n_, m_, MAX_ITER)
        mark()
        out = gi_kernel.postprocess(raw, n_, m_)
        mark()
        fast._refine_batch(pb10, fast._state_from_kernel_out(out, BATCH),
                           IR_STEPS)
        mark()
        return [1e3 * (b - a_) for a_, b in zip(marks, marks[1:])]

    split7()
    parts7 = min((split7() for _ in range(3)), key=sum)
    pack_ms = 1e3 * _wall_s(lambda: gi_kernel.prepare_warm(
        pb10.with_dtype(f32), *co))
    print(f"warm K4 step split, wall ms ({card}): preparation (a and the "
          f"bounds padded) {parts7[0]!r}, K4 {parts7[1]!r}, remap "
          f"{parts7[2]!r}, refinement {parts7[3]!r}; the preparation from a "
          f"carry of plain tensors (cast to f32, G, C, K, status and aorder "
          f"packed) {pack_ms!r}")
    ins3, (n, m) = gi_kernel.prepare_state(pb10_32, state0)
    ins4, _ = gi_kernel.prepare_warm_carry(pb10, carry_in.raw, carry_in.q,
                                           carry_in.reset, carry_in.first)
    k3_ms = _cuda_ms(lambda: gi_kernel._gi_loop_cuda_raw(*ins3, n, m,
                                                         MAX_ITER))
    k3_plain_ms = _cuda_ms(lambda: gi_kernel._gi_loop_plain_raw(
        *ins3, n, m, MAX_ITER), reps=1)
    k4_ms = _cuda_ms(lambda: gi_kernel._gi_warm_cuda_raw(*ins4, n, m,
                                                         MAX_ITER))
    k4_plain_ms = _cuda_ms(lambda: gi_kernel._gi_warm_plain_raw(
        *ins4, n, m, MAX_ITER), reps=1)
    print(f"device ms at batch {BATCH} ({card}): K3 {k3_ms!r} "
          f"(plain {k3_plain_ms!r}), K4 {k4_ms!r} (plain {k4_plain_ms!r})")
    outs3 = gi_kernel._gi_loop_cuda_raw(*ins3, n, m, MAX_ITER)
    outs4 = gi_kernel._gi_warm_cuda_raw(*ins4, n, m, MAX_ITER)
    it3_l = outs3[4][:, 1] - ins3[12][:, 1]
    it3, it4 = int(it3_l.sum()), int(outs4[4][:, 1].sum())
    # K3 starts from K0, x0, u0, status, aorder, statk, scalars and tr0
    k3_bound = _bound(_gi_flops(it3_l, ins3[12][:, 0], outs3[4][:, 0], N, M),
                      _gi_bytes(BATCH, N, M, 2 * N * N + 5 * N + M + 9))
    # K4 from a, K, status, aorder and q (a flagged lane's from the cold
    # state); its closed form x = K [-a; b] and u = (a + G x)^T K, ~6n^2
    q4 = torch.where(carry_in.reset.bool(), carry_in.first[3], carry_in.q)
    k4_bound = _bound(_gi_flops(outs4[4][:, 1], q4, outs4[4][:, 0], N, M)
                      + BATCH * 6 * N * N,
                      _gi_bytes(BATCH, N, M, 2 * N * N + 3 * N + M + 1))
    print(f"bounds ({card}): K3 {k3_bound} ({it3} iterations), K4 "
          f"{k4_bound} ({it4} iterations)")
    res_k3 = residency("jrlqp_gi_loop", k3_ms, it3, "the state load")
    res_k4 = residency("jrlqp_gi_warm", k4_ms, it4,
                       "the state load and closed form")
    del outs3, outs4

    del pbs, base7, steps, warm, carry, carry_in, carry_plain, co, state0
    del ins3, ins4

    # ---- phase 8: K5-K8 (structured block-LLT chains) vs plain ----
    ik = ik_batch(IK_BATCH, IK_NB, IK_S, IK_MC, seed=SEED)
    n_ik = IK_NB * IK_S
    diag32 = torch.from_numpy(ik["diag"]).to(dev, f32)
    off32 = torch.from_numpy(ik["off"]).to(dev, f32)
    eye_ik = torch.eye(n_ik, device=dev).reshape(1, IK_NB, IK_S, n_ik)
    eye_ik = eye_ik.expand(IK_BATCH, -1, -1, -1).contiguous()
    # the identity as the structured path hands it to K6: one buffer with
    # rows of round4(n) floats, shared by the batch
    eye_sh = block_llt.identity_rhs(IK_BATCH, IK_NB, IK_S, device=dev)

    hold_chains(("tri", "tri_lower", "arrow_down", "arrow_up"), diag32,
                off32, eye_ik, f"batch {IK_BATCH}, nb={IK_NB}, s={IK_S}")
    Ld, Lo, Li = block_llt.tri_block_llt(diag32, off32)
    aLd, aLo, aLi = block_llt.block_arrow_llt(diag32, off32)
    uLd, uLo, uLi = block_llt.block_arrow_llt(diag32, off32, up=True)
    struct_ms = {
        "K5": (_cuda_ms(lambda: block_llt.tri_block_llt(diag32, off32)),
               _cuda_ms(lambda: block_llt.tri_block_llt_plain(diag32, off32),
                        reps=1)),
        "K6": (_cuda_ms(lambda: block_llt.tri_block_solve(Lo, Li, eye_sh)),
               _cuda_ms(lambda: block_llt.tri_block_solve_plain(
                   Lo, Li, eye_ik), reps=1)),
        "K6 lower_only": (
            _cuda_ms(lambda: block_llt.tri_block_solve(Lo, Li, eye_sh,
                                                       True)),
            _cuda_ms(lambda: block_llt.tri_block_solve_plain(
                Lo, Li, eye_ik, True), reps=1)),
        "K7": (_cuda_ms(lambda: block_llt.block_arrow_llt(diag32, off32)),
               _cuda_ms(lambda: block_llt.block_arrow_llt_plain(
                   diag32, off32), reps=1)),
        "K8": (_cuda_ms(lambda: block_llt.block_arrow_solve(aLo, aLi,
                                                            eye_ik)),
               _cuda_ms(lambda: block_llt.block_arrow_solve_plain(
                   aLo, aLi, eye_ik), reps=1)),
        "K8 up": (
            _cuda_ms(lambda: block_llt.block_arrow_solve(uLo, uLi, eye_ik,
                                                         up=True)),
            _cuda_ms(lambda: block_llt.block_arrow_solve_plain(
                uLo, uLi, eye_ik, up=True), reps=1)),
    }
    # K6's padded layout, costed: K5 writes its factor with rows of
    # round4(s) floats and the path's identity is one padded buffer, so the
    # path's call copies nothing; an unpadded factor or rhs is copied once
    # per call
    Lo_u, Li_u = Lo.contiguous(), Li.contiguous()
    k6_fac_copy = _cuda_ms(lambda: block_llt.tri_block_solve(Lo_u, Li_u,
                                                             eye_sh))
    k6_rhs_copy = _cuda_ms(lambda: block_llt.tri_block_solve(Lo, Li, eye_ik))
    y_sh = block_llt.tri_block_solve(Lo, Li, eye_sh)
    _require(all(torch.equal(y_sh, y) for y in (
        block_llt.tri_block_solve(Lo_u, Li_u, eye_sh),
        block_llt.tri_block_solve(Lo, Li, eye_ik))),
        "K6 gives other bits on unpadded operands")
    print(f"K6 layout ({card}): on K5's padded factor and the shared "
          f"identity {struct_ms['K6'][0]!r} ms (nothing copied); on an "
          f"unpadded factor (L_off and Linv copied) {k6_fac_copy!r} ms; on "
          f"an unpadded identity (copied) {k6_rhs_copy!r} ms; same bits; "
          f"output digest (sha1) {_sha1(y_sh)}")
    del Lo_u, Li_u, y_sh
    for key, entry in (("K6", "jrlqp_tri_block_solve"),
                       ("K8", "jrlqp_block_arrow_solve")):
        print(f"{key} launch configuration at s={IK_S}, k={n_ik} ({card}): "
              f"{block_llt.solve_config(entry, IK_S, n_ik)}")
    print(f"device ms at batch {IK_BATCH}, nb={IK_NB}, s={IK_S} ({card}): "
          + ", ".join(f"{k} {v[0]!r} (plain {v[1]!r})"
                      for k, v in struct_ms.items()))
    # K5's and K7's launch configuration (one thread block per problem),
    # their time against the batch (one problem per SM, one full wave of
    # resident blocks, the IK batch; problems repeated past the IK batch)
    # and the digests of their outputs, so two versions of the kernels can
    # be compared bit for bit
    fac_cfg = {k: block_llt.factor_config(e, IK_S) for k, e in (
        ("K5", "jrlqp_tri_block_llt"), ("K7", "jrlqp_block_arrow_llt"))}
    for key, fac in (("K5", block_llt.tri_block_llt),
                     ("K7", block_llt.block_arrow_llt)):
        wave = fac_cfg[key]["blocks_per_sm"] * sms
        sweep = {}
        for B in (sms, wave, IK_BATCH):
            idx = torch.arange(B, device=dev) % IK_BATCH
            d_b, o_b = diag32[idx], off32[idx]
            sweep[B] = _cuda_ms(lambda: fac(d_b, o_b))
        print(f"{key} launch configuration at s={IK_S} ({card}): "
              f"{fac_cfg[key]}, {wave} problems resident at once on {sms} "
              f"SMs; device ms by batch {sweep} (batch {sms}: one problem "
              f"per SM, {wave}: one full wave, {IK_BATCH}: the IK batch)")
    print(f"K5 output digests (sha1) at batch {IK_BATCH}, nb={IK_NB}, "
          f"s={IK_S}: L_diag {_sha1(Ld)}, L_off {_sha1(Lo)}, Linv_diag "
          f"{_sha1(Li)}; K7 down: L_diag {_sha1(aLd)}, L_side {_sha1(aLo)}, "
          f"Linv_diag {_sha1(aLi)}; K7 up: L_diag {_sha1(uLd)}, L_side "
          f"{_sha1(uLo)}, Linv_diag {_sha1(uLi)}")
    # Both chains have nb diagonal blocks and nb - 1 coupling blocks. A
    # factor: per diagonal block its Cholesky and inverse (2/3 s^3), per
    # coupling block the product with a triangular inverse (s^3) and the
    # symmetric Schur update (s^3). A solve, per rhs column: forward and
    # backward, per diagonal block a triangular product (s^2) and per
    # coupling block a dense one (2 s^2), (6 nb - 4) s^2 in all. Bytes:
    # symmetric and triangular blocks as triangles, coupling blocks whole.
    tri_w, sq_w = IK_S * (IK_S + 1) // 2, IK_S * IK_S
    fac_flops = IK_BATCH * (IK_NB * 2 / 3 + (IK_NB - 1) * 2) * IK_S ** 3
    sol_flops = IK_BATCH * (6 * IK_NB - 4) * sq_w * n_ik
    fac_bytes = 4 * IK_BATCH * (3 * IK_NB * tri_w + 2 * (IK_NB - 1) * sq_w)
    sol_bytes = 4 * IK_BATCH * (IK_NB * tri_w + (IK_NB - 1) * sq_w
                                + 2 * n_ik * n_ik)
    struct_bound = {
        "K5": _bound(fac_flops, fac_bytes),
        "K6": _bound(sol_flops, sol_bytes),
        "K7": _bound(fac_flops, fac_bytes),
        "K8": _bound(sol_flops, sol_bytes),
    }
    # library yardsticks on the dense G of the same chain: the solves,
    # torch.cholesky_solve with the dense factor on the same identity; the
    # factorizations, torch.linalg.cholesky_ex
    from jrlqp_tpu_torch.structured import blocks as sblocks
    eye_d = eye_ik.reshape(IK_BATCH, n_ik, n_ik)
    lib_ms = {}
    for fac, sol, G_d in (
            ("K5", "K6", sblocks.tri_block_to_dense(diag32, off32)),
            ("K7", "K8", sblocks.block_arrow_to_dense(diag32, off32,
                                                      up=False))):
        L_d = torch.linalg.cholesky(G_d)
        lib_ms[sol] = _cuda_ms(lambda: torch.cholesky_solve(eye_d, L_d))
        lib_ms[fac] = _cuda_ms(lambda: torch.linalg.cholesky_ex(G_d))
        del G_d, L_d
    print(f"bounds ({card}): {struct_bound}; library ms "
          f"(K5, K7: torch.linalg.cholesky_ex of the dense G; K6, K8: "
          f"torch.cholesky_solve, dense factor): {lib_ms}")
    del Ld, Lo, Li, aLd, aLo, aLi, uLd, uLo, uLi, eye_ik, eye_d, eye_sh

    def refine_kernels_check(args):
        """K13 and K14 against their plain versions on the same card
        tensors, at the main path's shape: the refinement of the cold
        batch's own final states, its start (G x, then the update from
        zero) and its first step; the kernels' max_abs_err (gated as the
        card test gates them: g within 1e-13, the tracked state within
        1e-12, absolute plus relative), ms, plain_ms and bound_ms."""
        sg, a_, sc, lo_, up_ = args
        pbs_, _, _, st = ssolver._solve_structured_states(
            sg, a_, sc, lo_, up_, None, None, opt_ik, "auto")
        seen = []
        fast._refine_batch(pbs_, st, 0, products=lambda sl: seen.append(
            ssolver._BlockProducts(sg, sc, sl)) or seen[-1])
        ops = seen[0]
        B_, n_ = ops.a.shape
        m_, width = ops.C.shape[1], ops.C.shape[2]
        gm = (ops.diag, ops.off, ops.gtype)
        tail = (ops.C, ops.mc, ops.idx, ops.sgn, ops.a, ops.b)
        lam32 = torch.where(ops.sgn != 0, st.u[:, :n_], 0.0).contiguous()
        x32 = st.x.contiguous()
        torch.cuda.synchronize()
        reset_counts()

        def err(got, want, tol):
            d = (got - want).abs()
            return float(d.max()), bool((d <= tol + tol * want.abs()).all())

        # the start: G x, then the tracked quantities from zero
        _, gx = struct_refine.struct_gmul(*gm, None, x32, None)
        _, gx_p = struct_refine.struct_gmul_plain(*gm, None, x32, None)
        zero = tuple(torch.zeros_like(ops.a) for _ in range(5))
        st_k, st_p = zero, tuple(z.clone() for z in zero)
        r_k = struct_refine.struct_update(*tail, x32, lam32, gx, st_k)
        r_p = struct_refine.struct_update_plain(*tail, x32, lam32, gx, st_p)
        e_g, e_state, e_t, e_r = [err(gx, gx_p, 1e-13)], [], [], []
        e_state += [err(k, p_, 1e-12) for k, p_ in zip(st_k, st_p)]
        e_r += [err(k, p_, 1e-5) for k, p_ in zip(r_k, r_p)]
        # the first step, from the kernels' residuals
        r1, r2 = r_k
        nstr2 = fast._bmtv(st.Ns, r2)
        dx = fast._bmv(st.H, r1) + nstr2
        t, g = struct_refine.struct_gmul(*gm, nstr2, dx, r1)
        t_p, g_p = struct_refine.struct_gmul_plain(*gm, nstr2, dx, r1)
        e_g.append(err(g, g_p, 1e-13))
        e_t.append(err(t, t_p, 1e-5))
        dlam = fast._bmv(st.Ns, t)
        st_p = tuple(z.clone() for z in st_k)
        r_k = struct_refine.struct_update(*tail, dx, dlam, g, st_k)
        r_p = struct_refine.struct_update_plain(*tail, dx, dlam, g, st_p)
        e_state += [err(k, p_, 1e-12) for k, p_ in zip(st_k, st_p)]
        e_r += [err(k, p_, 1e-5) for k, p_ in zip(r_k, r_p)]
        torch.cuda.synchronize()
        c = counts()
        _require({k: v for k, v in c.items() if v}
                 == {"struct_gmul": 2, "struct_update": 2},
                 f"the K13/K14 check did not launch each kernel twice: {c}")
        _require(all(ok for _, ok in e_g + e_t),
                 f"K13 and its plain version differ: g {e_g}, t {e_t}")
        _require(all(ok for _, ok in e_state + e_r),
                 f"K14 and its plain version differ: state {e_state}, "
                 f"residuals {e_r}")
        # times, on scratch copies of the state (K14 updates in place)
        scratch = tuple(z.clone() for z in st_k)
        ms = {"struct_gmul": (
            _cuda_ms(lambda: struct_refine.struct_gmul(*gm, nstr2, dx, r1)),
            _cuda_ms(lambda: struct_refine.struct_gmul_plain(
                *gm, nstr2, dx, r1))),
            "struct_update": (
            _cuda_ms(lambda: struct_refine.struct_update(
                *tail, dx, dlam, g, scratch)),
            _cuda_ms(lambda: struct_refine.struct_update_plain(
                *tail, dx, dlam, g, scratch)))}
        # bounds: each operand read once and each output written once, f64
        # operations at the f64 peak. K13: G's f64 blocks, u, v, r (f32)
        # in, t (f32) and g (f64) out; two columns through nb diagonal and
        # nb - 1 off blocks, each off block twice (M and M^T)
        nb_, s_ = ops.diag.shape[1], ops.diag.shape[2]
        g_bytes = (8 * (ops.diag.numel() + ops.off.numel())
                   + B_ * n_ * (3 * 4 + 4 + 8))
        g_flops = 2 * 2 * s_ * s_ * (nb_ + 2 * (nb_ - 1)) * B_
        # K14: C, idx (int32), sgn, a, b, dy (f64), dx, dlam (f32) in; the
        # five tracked f64 vectors in and out, r1 and r2 (f32) out; N^T dx
        # over the active general rows and C^T mu over all of C's rows
        general = int(((ops.sgn != 0) & (ops.idx < m_)).sum())
        u_bytes = (8 * ops.C.numel()
                   + B_ * n_ * (4 + 4 * 8 + 2 * 4 + 5 * 16 + 2 * 4))
        u_flops = 2 * width * general + 2 * ops.C.numel()
        bound = {"struct_gmul": _bound(g_flops, g_bytes, PEAK_F64),
                 "struct_update": _bound(u_flops, u_bytes, PEAK_F64)}
        out = {
            "struct_gmul": {
                "max_abs_err": max(e for e, _ in e_g),
                "max_abs_err_t": max(e for e, _ in e_t)},
            "struct_update": {
                "max_abs_err": max(e for e, _ in e_state),
                "max_abs_err_residuals": max(e for e, _ in e_r)}}
        for k in out:
            out[k].update(ms=ms[k][0], plain_ms=ms[k][1],
                          bound_ms=bound[k][0], bound_by=bound[k][1])
        print(f"K13/K14 against their plain versions (the cold batch's "
              f"states, B={B_}, n={n_}, m={m_}, {card}): {out}")
        return out

    # ---- phase 9: the structured cold batch ----
    opt_ik = SolverOptions(max_iter=IK_MAX_ITER)
    ik_t = {k: torch.from_numpy(ik[k]).to(dev) for k in ("a", "l", "u")}

    def ik_args(d, gtype=GType.TRI_BLOCK_DIAGONAL):
        sg, sc = structured_from_numpy(diag=ik["diag"], off=ik["off"],
                                       gtype=gtype, blocks=ik["blocks"],
                                       device=dev)
        return sg, d["a"], sc, d["l"], d["u"]

    args9 = ik_args(ik_t)
    pb9 = structured_qp_problem(*args9)
    torch.cuda.synchronize()
    reset_counts()
    res9 = solve_structured_fast_batch(*args9, opt=opt_ik,
                                       ir_steps=IK_IR_STEPS)
    torch.cuda.synchronize()
    cold_counts = counts()
    print(f"structured cold batch launches: {cold_counts}")
    # the refinement on the structure: K13 and K14 once to start and once
    # a step
    refine_launches = {"struct_gmul": 1 + IK_IR_STEPS,
                       "struct_update": 1 + IK_IR_STEPS}
    _require({k: v for k, v in cold_counts.items() if v}
             == {"tri_block_llt": 1, "tri_block_solve": 1, "fast_loop": 1,
                 **refine_launches},
             "the structured cold batch did not run K5, K6 and K11 once "
             "each and K13 and K14 once a refinement step and once more "
             "(and nothing else)")
    rate9, kkt9, _ = gate("structured cold batch", res9, pb9, 1.0)
    dense9 = fast.solve_refined(pb9, opt_ik, ir_steps=IK_IR_STEPS)
    same_st = int((res9.status != dense9.status).sum())
    same_as = int((res9.active_set != dense9.active_set).any(dim=1).sum())
    ok9 = (res9.status == 0) & (dense9.status == 0)
    x9 = float((res9.x[ok9] - dense9.x[ok9]).abs().max())
    print(f"structured vs dense engine: status differs on {same_st} lanes, "
          f"active set on {same_as}, max |x err| {x9!r}")
    _require(same_st == 0 and same_as == 0,
             "structured and dense engines disagree on status or active set")
    _require(x9 <= 1e-9, f"structured vs dense x differ by {x9} > 1e-9")
    k13_14 = refine_kernels_check(args9)
    it9 = res9.iterations.double()
    print(f"structured cold batch: batch {IK_BATCH}, n={n_ik}, "
          f"m={IK_NB * IK_MC}: KKT<=1e-8 & SUCCESS rate {rate9!r}, max KKT "
          f"{kkt9!r}, mean_it {float(it9.mean())!r}, max_it "
          f"{int(res9.iterations.max())}, active constraints "
          f"{int((res9.active_set != 0).sum(1).min())}-"
          f"{int((res9.active_set != 0).sum(1).max())}")
    arrow_counts = {}
    for gtype in (GType.BLOCK_ARROW_DOWN, GType.BLOCK_ARROW_UP):
        args_a = ik_args(ik_t, gtype)
        reset_counts()
        res_a = solve_structured_fast_batch(*args_a, opt=opt_ik,
                                            ir_steps=IK_IR_STEPS)
        torch.cuda.synchronize()
        arrow_counts[gtype.name] = c = counts()
        print(f"structured cold batch ({gtype.name}) launches: {c}")
        _require({k: v for k, v in c.items() if v}
                 == {"block_arrow_llt": 1, "block_arrow_solve": 1,
                     "fast_loop": 1, **refine_launches},
                 f"{gtype.name}: did not run K7, K8 and K11 once each, "
                 f"K13 and K14 {1 + IK_IR_STEPS} times each")
        rate_a, kkt_a, _ = gate(f"structured {gtype.name}", res_a,
                                structured_qp_problem(*args_a))
        print(f"structured cold batch ({gtype.name}): rate {rate_a!r}, "
              f"max KKT {kkt_a!r}, mean_it "
              f"{float(res_a.iterations.double().mean())!r}")
    del res_a, args_a

    sps9 = {
        "kernel route (K5+K6)": IK_BATCH / _wall_s(
            lambda: solve_structured_fast_batch(*args9, opt=opt_ik,
                                                ir_steps=IK_IR_STEPS)),
        "blocks route": IK_BATCH / _wall_s(
            lambda: solve_structured_fast_batch(*args9, opt=opt_ik,
                                                ir_steps=IK_IR_STEPS,
                                                backend="blocks")),
        "dense engine": IK_BATCH / _wall_s(
            lambda: fast.solve_refined(pb9, opt_ik, ir_steps=IK_IR_STEPS)),
    }
    for k, v in sps9.items():
        print(f"solves/s (best of 3, batch {IK_BATCH}, IK, {card}): {k} "
              f"{v!r}")

    def split9():
        """Wall ms of the cold batch's stages, each closed by a sync."""
        sg, a, sc, lo_, up_ = args9
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        pbs_, pb32, opt32 = ssolver._problems(sg, a, sc, lo_, up_, None,
                                              None, opt_ik)
        mark()
        H, posdef = ssolver._structured_inverse_kernel_batch(
            sg.diag.to(f32), sg.off.to(f32), sg.gtype)
        mark()
        x = torch.where(posdef[:, None], -fast._bmv(H, pb32.a), 0.0)
        st = fast._run_loop(pb32, fast._init_fast_from_ops(
            pb32, H, x, posdef, opt32), opt32)
        mark()
        ssolver._refine_structured(pbs_, sg, sc, st, IK_IR_STEPS)
        mark()
        return [1e3 * (b - a_) for a_, b in zip(marks, marks[1:])]

    split9()
    parts = min((split9() for _ in range(3)), key=sum)
    print(f"structured cold batch split, wall ms ({card}): dense problem "
          f"{parts[0]!r}, K5+K6 {parts[1]!r}, init + K11 "
          f"{parts[2]!r}, refinement {parts[3]!r}")
    del dense9

    # K11 (the explicit-form loop) against its plain version: the IK cold
    # batch's own state (K5 + K6, then the torch init), and the headline
    # set at batch 1024 in f32 and f64
    def k11_against_plain(name, pb_, st0_, opt_, min_same, x_tol):
        """K11's state against the plain version's from ``st0_``
        (``testing.fast_parting.against_plain``): status, iterations,
        active count and active set equal on >= min_same of the lanes,
        every lane that parts at a near tie of its first parting iteration
        (printed with the deciding margins of both sides) and with sound
        outcomes on both sides (``fast_parting.outcomes``), x within x_tol
        max(1, |x|) on the same lanes whose x is an answer. Returns (K11's
        state, the same share, the relative and the absolute x error, the
        partings)."""
        cmp = fast_parting.against_plain(pb_, st0_, opt_)
        share = float(cmp["same"].double().mean())
        err, partings = cmp["rel_x_err"], cmp["partings"]
        print(f"{name} vs plain: {len(partings)} of {len(cmp['same'])} lanes "
              f"part: {partings}; max |x err| / max(1, |x|) on the rest "
              f"{err!r}")
        _require(share >= min_same, f"{name}: the same lanes {share} < "
                 f"{min_same}")
        _require(all(p["near_ties"] for p in partings.values()),
                 f"{name}: a lane parts at no near tie")
        _require(all(p["outcome"]["sound"] for p in partings.values()),
                 f"{name}: a parting lane's outcomes are not sound together")
        _require(err <= x_tol, f"{name}: x differs by {err} > {x_tol}")
        return cmp["k11"], share, err, cmp["abs_x_err"], partings

    def k11_row(name, pb_, st0_, opt_, min_same, x_tol, peak):
        """K11 held to its plain version, its device ms (best of 3) and
        the plain version's (1 run), the bound and the streamed bytes'
        time."""
        B_, n_ = st0_.x.shape
        m_ = pb_.m
        got, share, err, abs_err, partings = k11_against_plain(
            name, pb_, st0_, opt_, min_same, x_tol)
        its = got.it - st0_.it
        isz = st0_.x.element_size()
        bd = _bound(fast_loop.fast_loop_flops(its, st0_.q, got.q, n_, m_),
                    fast_loop.fast_loop_bytes(B_, n_, m_, isz), peak)
        return {
            "batch": B_, "n": n_, "m": m_, "dtype": str(st0_.x.dtype),
            "ms": _cuda_ms(lambda: fast_loop.fast_loop(pb_, st0_, opt_)),
            "plain_ms": _cuda_ms(lambda: fast.fast_loop_plain(
                pb_, st0_, opt_), reps=1),
            "bound_ms": bd[0], "bound_by": bd[1],
            "stream_ms": 1e3 * fast_loop.fast_loop_stream_bytes(
                its, st0_.q, got.q, n_, m_, isz) / PEAK_BW,
            "iterations": int(its.sum()), "max_it": int(its.max()),
            "same_lanes": share, "max_rel_x_err": err,
            "max_abs_x_err": abs_err,
            "partings": {str(k): v for k, v in partings.items()},
            "config": fast_loop.fast_loop_config(n_, m_, st0_.x.dtype)}

    sg9, a9, sc9, lo9, up9 = args9
    _, pb32_9, opt32_9 = ssolver._problems(sg9, a9, sc9, lo9, up9, None,
                                           None, opt_ik)
    H9, pd9 = ssolver._structured_inverse_kernel_batch(
        sg9.diag.to(f32), sg9.off.to(f32), sg9.gtype)
    H9 = torch.where(pd9[:, None, None], H9, torch.eye(n_ik, device=dev))
    st0_9 = fast._init_fast_from_ops(
        pb32_9, H9, torch.where(pd9[:, None], -fast._bmv(H9, pb32_9.a), 0.0),
        pd9, opt32_9)
    k11 = {"IK cold": k11_row("K11 (IK cold, f32)", pb32_9, st0_9, opt32_9,
                              0.99, 1e-3, PEAK_F32)}
    del H9, st0_9
    pbh = random_qp_batch(gen, CHECK_BATCH, N, M, ACT_FRAC, dtype=f32)
    opt_h32 = opt.with_(dtype=f32, zero_z_threshold=1e-6)
    k11["headline f32"] = k11_row(
        "K11 (headline, f32)", pbh, fast._init_fast(pbh, opt_h32), opt_h32,
        0.99, 1e-3, PEAK_F32)
    pbh64 = pbh.with_dtype(f64)
    k11["headline f64"] = k11_row(
        "K11 (headline, f64)", pbh64, fast._init_fast(pbh64, opt), opt, 1.0,
        1e-10, PEAK_F64)
    print(json.dumps({"phase": 9, "K11": k11, "card": card}))
    del pbh, pbh64

    # ---- phase 10: the IK trajectory (a cold step, then warm steps) ----
    rng = np.random.default_rng(SEED + 1)
    traj = [{k: torch.from_numpy(v).to(dev) for k, v in
             ik_step(ik, IK_DRIFT, rng).items() if k in ("a", "l", "u")}
            for _ in range(IK_STEPS)]
    torch.cuda.synchronize()
    reset_counts()
    res_t, carry_t = solve_structured_fast_carry(
        *ik_args(traj[0]), None, opt=opt_ik, ir_steps=IK_IR_STEPS)
    results = [res_t]
    for d in traj[1:]:
        carry_prev = carry_t
        res_t, carry_t = solve_structured_fast_carry(
            *ik_args(d), carry_t, opt=opt_ik, ir_steps=IK_IR_STEPS)
        results.append(res_t)
    torch.cuda.synchronize()
    traj_ik_counts = counts()
    print(f"IK trajectory launches (cold step + {IK_STEPS - 1} warm steps): "
          f"{traj_ik_counts}")
    _require({k: v for k, v in traj_ik_counts.items() if v}
             == {"tri_block_llt": 1, "tri_block_solve": 1,
                 "carry_init": IK_STEPS - 1, "fast_loop": IK_STEPS,
                 **{k: IK_STEPS * v for k, v in refine_launches.items()}},
             "the IK trajectory did not launch K5 and K6 once (the cold "
             "step), K12 once per warm step, K11 once per step and K13 "
             "and K14 once per refinement step and once more, and nothing "
             "else")
    rows_ik = []
    for i, (r_, d) in enumerate(zip(results, traj)):
        args_s = ik_args(d)
        pb_s = structured_qp_problem(*args_s)
        res_c = solve_structured_fast_batch(*args_s, opt=opt_ik,
                                            ir_steps=IK_IR_STEPS)
        rate, max_kkt, passed = gate(f"IK step {i}", r_, pb_s, 1.0)
        passed_c = ((kkt_residual(res_c.x, res_c.multipliers, pb_s) <= 1e-8)
                    & (res_c.status == 0))
        same = (r_.active_set == res_c.active_set).all(dim=1)
        ok = same & passed & passed_c
        x_err = float((r_.x[ok] - res_c.x[ok]).abs().max())
        _require(x_err <= 1e-7, f"IK step {i}: |x - x_cold| {x_err} > 1e-7")
        row = dict(step=i, kind="cold" if i == 0 else "warm",
                   mean_it=float(r_.iterations.double().mean()),
                   max_it=int(r_.iterations.max()),
                   cold_mean_it=float(res_c.iterations.double().mean()),
                   same_active_set=float(same.double().mean()),
                   pass_rate=rate, max_kkt=max_kkt, x_err=x_err)
        rows_ik.append(row)
        print(f"IK step {i}: {row}")
    warm_it = sum(r["mean_it"] for r in rows_ik[1:]) / (IK_STEPS - 1)
    print(f"IK warm steps: mean_it {warm_it!r} (cold "
          f"{sum(r['cold_mean_it'] for r in rows_ik) / IK_STEPS!r})")
    last = ik_args(traj[-1])
    warm_s = _wall_s(lambda: solve_structured_fast_carry(
        *last, carry_prev, opt=opt_ik, ir_steps=IK_IR_STEPS))
    cold_s = _wall_s(lambda: solve_structured_fast_carry(
        *last, None, opt=opt_ik, ir_steps=IK_IR_STEPS))
    print(f"IK trajectory solves/s (best of 3, batch {IK_BATCH}, {card}): "
          f"warm step {IK_BATCH / warm_s!r} ({warm_s * 1e3!r} ms), cold "
          f"step {IK_BATCH / cold_s!r} ({cold_s * 1e3!r} ms); "
          f"{IK_STEPS} steps = {IK_STEPS * IK_BATCH} solves")

    # K12 (the carry init) against its plain version on the last warm
    # step's own carry: status, aorder, q, it and term equal, the floats
    # within the card test's tolerances (test_torch_card._k12_against_plain)
    _, pb32_10, _ = ssolver._problems(*last, None, None, opt_ik)
    carry10 = (carry_prev.H, carry_prev.Ns, carry_prev.status,
               carry_prev.aorder, carry_prev.q)
    got12 = carry_init.carry_init(pb32_10, *carry10)
    want12 = fast._init_fast_from_carry(pb32_10, *carry10)
    for k in ("status", "aorder", "q", "it", "term", "skip1", "sc_idx",
              "sc_status"):
        _require(torch.equal(getattr(got12, k), getattr(want12, k)),
                 f"K12 vs plain: {k} differs")
    k12_err = {}
    for k, tol in (("x", 2e-5), ("u", 2e-5), ("f", 2e-5), ("hscale", 2e-5),
                   ("H", 1e-6), ("Ns", 1e-6)):
        g_, w_ = (getattr(s_, k).reshape(IK_BATCH, -1)
                  for s_ in (got12, want12))
        k12_err[k] = float(((g_ - w_).abs().amax(dim=1)
                            / w_.abs().amax(dim=1).clamp_min(1.0)).max())
        _require(k12_err[k] <= tol, f"K12 vs plain: {k} differs by "
                 f"{k12_err[k]} > {tol}")
    its12 = want12.it
    bd12 = _bound(carry_init.carry_init_flops(carry_prev.q, its12, n_ik),
                  carry_init.carry_init_bytes(carry_prev.q, n_ik,
                                              IK_NB * IK_MC))
    k12 = {"batch": IK_BATCH, "n": n_ik, "m": IK_NB * IK_MC,
           "ms": _cuda_ms(lambda: carry_init.carry_init(pb32_10, *carry10)),
           "plain_ms": _cuda_ms(lambda: fast._init_fast_from_carry(
               pb32_10, *carry10), reps=1),
           "bound_ms": bd12[0], "bound_by": bd12[1],
           "stream_ms": 1e3 * carry_init.carry_init_stream_bytes(
               carry_prev.q, its12, n_ik, IK_NB * IK_MC) / PEAK_BW,
           "deactivations": torch.bincount(its12).tolist(),
           "max_rel_err": k12_err,
           "config": carry_init.carry_init_config(n_ik, IK_NB * IK_MC)}
    print(json.dumps({"phase": 10, "K12": k12, "card": card}))
    del got12, want12, carry10, pb32_10

    del results, traj, carry_t, carry_prev, res9, pb9, args9
    opt32 = opt.with_(dtype=f32, zero_z_threshold=1e-6)

    # ---- phase 11: K9 (the compact-slot loop) vs plain and the XLA loop ----
    pb11 = random_qp_batch(gen, CHECK_BATCH, N, M, ACT_FRAC, dtype=f32)
    st11 = fast._init_fast(pb11, opt32)
    ok_k = gi_kernel.run_loop_compact(pb11, st11, MAX_ITER)
    ok_p = gi_kernel.gi_compact_plain(pb11, st11, MAX_ITER)
    torch.cuda.synchronize()
    k9_err = against_plain("K9", ok_k, ok_p, pb11.with_dtype(f64))
    xla = fast.fast_loop_plain(pb11, st11, opt32)
    ok_x = {f.name: getattr(xla, f.name) for f in dataclasses.fields(xla)}
    ok_x["u"] = xla.u[:, :N]
    against_plain("K9 (reference: the XLA engine's plain loop)", ok_k, ok_x,
                  pb11.with_dtype(f64))
    del pb11, st11, ok_k, ok_p, ok_x, xla

    # ---- phase 12: the compact path at the headline batch ----
    pb12 = problems()
    torch.cuda.synchronize()
    reset_counts()
    res12 = solve_refined_kernel_compact(pb12, opt, ir_steps=IR_STEPS)
    torch.cuda.synchronize()
    compact_counts = counts()
    print(f"compact path launches: {compact_counts}")
    _require(compact_counts["gi_compact"] == 1
             and sum(compact_counts.values()) == 1,
             "the compact path did not run K9 once (and nothing else)")
    rate12, kkt12, _ = gate("compact path", res12, pb12)
    print(f"compact path: batch {BATCH}, n={N}, m={M}: KKT<=1e-8 & SUCCESS "
          f"rate {rate12!r}, max KKT {kkt12!r}, mean_it "
          f"{float(res12.iterations.double().mean())!r}, max_it "
          f"{int(res12.iterations.max())}")
    sps12 = {
        "solve_refined_kernel (K1)": BATCH / _wall_s(
            lambda: solve_refined_kernel(pb12, opt, ir_steps=IR_STEPS)),
        "solve_refined_kernel_compact (K9)": BATCH / _wall_s(
            lambda: solve_refined_kernel_compact(pb12, opt,
                                                 ir_steps=IR_STEPS)),
    }
    for k, v in sps12.items():
        print(f"solves/s (best of 3, batch {BATCH}, {card}): {k} {v!r}")

    def split12():
        """Wall ms of the compact path's stages, each closed by a sync."""
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        p32 = pb12.with_dtype(f32)
        st = fast._init_fast(p32, opt32)
        mark()
        ins, (n_, m_) = gi_kernel.prepare_state(p32, st)
        mark()
        raw = gi_kernel._gi_compact_cuda_raw(*ins, n_, m_, MAX_ITER)
        mark()
        out = gi_kernel.postprocess(raw, n_, m_)
        mark()
        fast._refine_batch(pb12, fast._state_from_kernel_out(out, BATCH),
                           IR_STEPS)
        mark()
        return [1e3 * (b - a_) for a_, b in zip(marks, marks[1:])]

    split12()
    parts12 = min((split12() for _ in range(3)), key=sum)
    print(f"compact path split, wall ms ({card}): cast + torch init "
          f"{parts12[0]!r}, prepare {parts12[1]!r}, K9 {parts12[2]!r}, remap "
          f"{parts12[3]!r}, refinement {parts12[4]!r}")
    pb12_32 = pb12.with_dtype(f32)
    ins9, (n, m) = gi_kernel.prepare_state(pb12_32,
                                           fast._init_fast(pb12_32, opt32))
    k9_ms = _cuda_ms(lambda: gi_kernel._gi_compact_cuda_raw(*ins9, n, m,
                                                            MAX_ITER))
    k9_plain_ms = _cuda_ms(lambda: gi_kernel._gi_compact_plain_raw(
        *ins9, n, m, MAX_ITER), reps=1)
    outs9 = gi_kernel._gi_compact_cuda_raw(*ins9, n, m, MAX_ITER)
    it9_l = outs9[4][:, 1] - ins9[12][:, 1]
    it9 = int(it9_l.sum())
    k9_bound = _bound(_gi_flops(it9_l, ins9[12][:, 0], outs9[4][:, 0], N, M),
                      _gi_bytes(BATCH, N, M, 2 * N * N + 5 * N + M + 9))
    print(f"device ms at batch {BATCH} ({card}): K9 {k9_ms!r} (plain "
          f"{k9_plain_ms!r}); bound {k9_bound} ({it9} iterations)")
    res_k9 = residency("jrlqp_gi_compact", k9_ms, it9)
    del ins9, outs9, pb12_32

    # ---- phase 13: the rescue at the headline batch ----
    rescue_rows, rescue_launches = {}, 0
    for act_frac, min_rate in ((ACT_FRAC, 1.0), (RESCUE_ACT_FRAC, 0.9999)):
        pb13 = pb12 if act_frac == ACT_FRAC else problems(act_frac)
        torch.cuda.synchronize()
        reset_counts()
        res13 = solve_refined_kernel_rescued(pb13, opt, ir_steps=IR_STEPS)
        torch.cuda.synchronize()
        c13 = counts()
        rate13, kkt13, _ = gate(f"rescue (act_frac {act_frac})", res13, pb13,
                                min_rate)
        # the stages, timed apart: the first stage, the check, the rescue
        t = time.perf_counter()
        first = fast._solve_refined_from_init(pb13, opt, IR_STEPS,
                                              gi_kernel.run_loop)
        resid = fast._batch_kkt(pb13, first.x, first.multipliers)
        bad = torch.nonzero((resid > 1e-8) | (first.status != 0))[:, 0]
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t
        t = time.perf_counter()
        if bad.numel():
            sub = fast._rescue_subbatch(pb13._map(lambda v: v[bad]), opt)
            _require(bool((sub.status == 0).all()),
                     "a rescued lane did not end SUCCESS")
        torch.cuda.synchronize()
        t_rescue = time.perf_counter() - t
        # the first stage runs K3 once, the rescue K10 once if a lane failed
        want13 = {"gi_loop": 1, "jr_loop": int(bad.numel() > 0)}
        _require({k: v for k, v in c13.items() if v} == {
            k: v for k, v in want13.items() if v},
            f"rescue at act_frac {act_frac}: launches {c13}, expected "
            f"{want13}")
        rescue_launches += c13["jr_loop"]
        rescue_rows[act_frac] = row = dict(
            pass_rate=rate13, max_kkt=kkt13, rescued=int(bad.numel()),
            launches={k: v for k, v in c13.items() if v},
            first_stage_ms=1e3 * t_first, rescue_ms=1e3 * t_rescue,
            first_stage_pass_rate=float(((resid <= 1e-8)
                                         & (first.status == 0)).double()
                                        .mean()),
            solves_per_s=BATCH / _wall_s(lambda: solve_refined_kernel_rescued(
                pb13, opt, ir_steps=IR_STEPS), reps=2))
        print(f"rescue (act_frac {act_frac}, batch {BATCH}, {card}): {row}")
        del res13, first, resid
    del pb13

    # ---- phase 14: the J/R engines ----
    pb14 = random_qp_batch(gen, CHECK_BATCH, N, M, ACT_FRAC,
                           dtype=f32).with_dtype(f64)
    # solve_batch's stages: the torch init, the loop (one K10 launch), the
    # multipliers
    torch.cuda.synchronize()
    reset_counts()
    t14 = [time.perf_counter()]

    def mark14():
        torch.cuda.synchronize()
        t14.append(time.perf_counter())

    st0_14 = dense.init_state(pb14, opt)
    mark14()
    st14 = dense.run_loop(pb14, st0_14, opt)
    mark14()
    res14 = dense.finalize(pb14, st14)
    mark14()
    jr_counts = counts()
    init14, loop14, fin14 = (1e3 * (b - a_) for a_, b in zip(t14, t14[1:]))
    _require({k: v for k, v in jr_counts.items() if v} == {"jr_loop": 1},
             f"solve_batch: launches {jr_counts}, expected K10 once and no "
             f"other kernel")
    rate14, kkt14, pass14 = gate("solve_batch (J/R, f64)", res14, pb14)
    kkt_ok14 = kkt_residual(res14.x, res14.multipliers, pb14)[
        res14.status == 0]
    _require(float(kkt_ok14.max()) <= 1e-8,
             "solve_batch: a SUCCESS lane above KKT 1e-8")
    # K10 against its plain version on the same state: the traced pass loop
    # (on_pass) runs the plain version's passes and launches no kernel
    passes = []
    reset_counts()
    pl14 = dense.run_loop(pb14, st0_14, opt,
                          on_pass=lambda a_, b_: passes.append(1))
    torch.cuda.synchronize()
    _require(sum(counts().values()) == 0,
             "the J/R pass loop (on_pass) launched a kernel")

    def jr_against_plain(name, got, want, min_same, x_tol):
        """K10's state against the plain version's: status, iterations and
        active set equal on >= min_same of the lanes, x within x_tol on
        those. Returns (share of same lanes, max |x err| on them)."""
        same = ((got.term == want.term) & (got.it == want.it)
                & (got.status == want.status).all(dim=1))
        share = float(same.double().mean())
        err = float((got.x[same] - want.x[same]).abs().max())
        print(f"{name} vs plain: {got.x.shape[0]} lanes, the same status, "
              f"iterations and active set on {share!r} (lanes that part: "
              f"{torch.nonzero(~same)[:, 0].tolist()}), max |x err| on "
              f"them {err!r}")
        _require(share >= min_same, f"{name}: the same lanes {share} < "
                 f"{min_same}")
        _require(err <= x_tol, f"{name}: x differs by {err} > {x_tol}")
        return share, err

    k10_same, k10_err = jr_against_plain("K10 (f64)", st14, pl14, 0.999,
                                         1e-10)
    k10_ms = _cuda_ms(lambda: jr_kernel.jr_loop(pb14, st0_14, opt))
    k10_plain_ms = _cuda_ms(lambda: dense.jr_loop_plain(pb14, st0_14, opt),
                            reps=1)
    k10_bound = _bound(jr_kernel.jr_flops(st14.it - st0_14.it, st0_14.q,
                                          st14.q, N, M),
                       jr_kernel.jr_bytes(CHECK_BATCH, N, M, 8), PEAK_F64)
    # f32, solve_mixed's first stage, on the same problems
    opt32_m = opt.with_(dtype=f32, zero_z_threshold=F32_ZERO_Z)
    pb14_32 = pb14.with_dtype(f32)
    st0_32 = dense.init_state(pb14_32, opt32_m)
    k10_32 = jr_kernel.jr_loop(pb14_32, st0_32, opt32_m)
    k10_same32, k10_err32 = jr_against_plain(
        "K10 (f32)", k10_32, dense.jr_loop_plain(pb14_32, st0_32, opt32_m),
        0.99, 1e-3)
    k10_ms32 = _cuda_ms(lambda: jr_kernel.jr_loop(pb14_32, st0_32, opt32_m))
    k10_plain_ms32 = _cuda_ms(lambda: dense.jr_loop_plain(
        pb14_32, st0_32, opt32_m), reps=1)
    k10_bound32 = _bound(jr_kernel.jr_flops(k10_32.it, st0_32.q, k10_32.q,
                                            N, M),
                         jr_kernel.jr_bytes(CHECK_BATCH, N, M, 4))
    print(json.dumps({"phase": 14, "K10": {
        "batch": CHECK_BATCH, "n": N, "m": M,
        "f64": {"ms": k10_ms, "plain_ms": k10_plain_ms,
                "bound_ms": k10_bound[0], "bound_by": k10_bound[1],
                "iterations": int((st14.it - st0_14.it).sum()),
                "plain_passes": len(passes), "same_lanes": k10_same,
                "max_abs_x_err": k10_err},
        "f32": {"ms": k10_ms32, "plain_ms": k10_plain_ms32,
                "bound_ms": k10_bound32[0], "bound_by": k10_bound32[1],
                "iterations": int(k10_32.it.sum()), "same_lanes": k10_same32,
                "max_abs_x_err": k10_err32}}, "card": card}))
    del pl14, st0_32, pb14_32, k10_32
    ref14 = solve_refined_kernel(pb14, opt, ir_steps=IR_STEPS)
    same14 = ((res14.status == ref14.status)
              & (res14.active_set == ref14.active_set).all(dim=1))
    _require(float(same14.double().mean()) >= 0.999,
             "solve_batch and the main path disagree on > 0.1% of lanes")
    ok14 = same14 & pass14 & (ref14.status == 0)
    x14 = float((res14.x[ok14] - ref14.x[ok14]).abs().max())
    _require(x14 <= 1e-7, f"solve_batch vs main path x differ by {x14}")
    sps14 = CHECK_BATCH / _wall_s(lambda: solve_batch(pb14, opt), reps=2)
    print(f"solve_batch (J/R, f64, batch {CHECK_BATCH}, {card}): pass rate "
          f"{rate14!r}, max KKT {kkt14!r}, mean_it "
          f"{float(res14.iterations.double().mean())!r}, same status and "
          f"active set as the main path on {float(same14.double().mean())!r}"
          f", x within {x14!r}; wall ms: init {init14!r}, loop (K10) "
          f"{loop14!r}, finalize {fin14!r}; solves/s {sps14!r}")
    # the pass loop's Givens sweep (the structured J/R solver and the
    # tracer run it): one masked rotation per row pair, a dozen small
    # launches each, for every lane at once
    from jrlqp_tpu_torch.ops.linalg import givens_remove
    sweep = {}
    for B_, n_, q_ in ((CHECK_BATCH, N, N), (SJR_BATCH, n_ik, IK_NB * IK_MC)):
        eye_ = torch.eye(n_, dtype=f64, device=dev).expand(B_, n_, n_)
        R_ = torch.triu(torch.rand((B_, n_, n_), generator=gen, device=dev,
                                   dtype=f64)) + eye_
        q_t = torch.full((B_,), q_, dtype=torch.int32, device=dev)
        l_t = torch.zeros((B_,), dtype=torch.int32, device=dev)
        sweep[(B_, n_, q_ - 1)] = _cuda_ms(
            lambda: givens_remove(eye_, R_, q_t, l_t))
        del eye_, R_
    print(f"Givens sweep, device ms per removal pass ({card}), keyed (batch, "
          f"n, rotations): {sweep}")
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    res14w = solve_warm(pb14, res14.active_set, opt.with_(warm_start=True))
    torch.cuda.synchronize()
    warm14_ms, c14w = 1e3 * (time.perf_counter() - t), counts()
    _require({k: v for k, v in c14w.items() if v} == {"jr_loop": 1},
             f"solve_warm: launches {c14w}, expected K10 once")
    zero14 = float((res14w.iterations == 0).double().mean())
    _require(zero14 >= 0.999, f"solve_warm: 0 iterations on {zero14} < 0.999")
    print(f"solve_warm from the J/R active set: 0 iterations on {zero14!r} "
          f"of the lanes, status SUCCESS on "
          f"{float((res14w.status == 0).double().mean())!r}; wall "
          f"{warm14_ms!r} ms, K10 launched once")
    ik14 = ik_batch(SJR_BATCH, IK_NB, IK_S, IK_MC, seed=SEED + 2)
    sg14, sc14 = structured_from_numpy(diag=ik14["diag"], off=ik14["off"],
                                       gtype=GType.TRI_BLOCK_DIAGONAL,
                                       blocks=ik14["blocks"], device=dev)
    a14, l14, u14 = (torch.from_numpy(ik14[k]).to(dev) for k in "alu")
    opt_ik = SolverOptions(max_iter=IK_MAX_ITER)
    t = time.perf_counter()
    rs14 = solve_structured(sg14, a14, sc14, l14, u14, opt=opt_ik)
    torch.cuda.synchronize()
    ts14 = time.perf_counter() - t
    pbs14 = structured_qp_problem(sg14, a14, sc14, l14, u14)
    rates14, kkts14, _ = gate("solve_structured (J/R, f64)", rs14, pbs14, 1.0)
    rf14 = solve_structured_fast_batch(sg14, a14, sc14, l14, u14, opt=opt_ik,
                                       ir_steps=IK_IR_STEPS)
    same_s = int((rs14.active_set != rf14.active_set).any(dim=1).sum())
    _require(same_s == 0, f"solve_structured and the fast structured batch "
             f"disagree on the active set of {same_s} lanes")
    print(f"solve_structured (J/R, f64, batch {SJR_BATCH}, n={n_ik}, "
          f"{card}): pass rate {rates14!r}, max KKT {kkts14!r}, mean_it "
          f"{float(rs14.iterations.double().mean())!r}, same active set as "
          f"solve_structured_fast_batch on every lane, max |x err| "
          f"{float((rs14.x - rf14.x).abs().max())!r}; wall "
          f"{1e3 * ts14!r} ms ({SJR_BATCH / ts14!r} solves/s)")
    del st14, st0_14, res14w, rs14, rf14, sg14, sc14, pbs14

    # ---- phase 15: observability ----
    pb15 = pb14._map(lambda v: v[:OBS_BATCH])
    pb15_32 = pb15.with_dtype(f32)
    flags = (LogFlags.ITERATION_BASIC_DETAILS | LogFlags.ACTIVE_SET
             | LogFlags.ITERATION_ADVANCE_DETAILS)
    def jr_plain(p_, o_):
        """solve_batch with K10's plain version in place of K10: the
        tracer's passes are the plain version's."""
        return dense.finalize(p_, dense.jr_loop_plain(
            p_, dense.init_state(p_, o_), o_))

    def fast_plain(p_, o_):
        """solve_fast with K11's plain version in place of K11."""
        return dense.finalize(p_, fast.fast_loop_plain(
            p_, fast._init_fast(p_, o_), o_))

    for name, traced, plain, p_, o_ in (
            ("solve_fast_traced (f32)", solve_fast_traced, fast_plain,
             pb15_32, opt32),
            ("solve_traced (J/R, f64)", solve_traced, jr_plain, pb15,
             opt)):
        rt, tr = traced(p_, o_, flags)
        rp = plain(p_, o_)
        _require(torch.equal(rt.iterations, rp.iterations)
                 and torch.equal(rt.status, rp.status)
                 and torch.equal(rt.x, rp.x),
                 f"{name} differs from its untraced solve")
        last = (rt.iterations.long() - 1).clamp_min(0)
        row = tr.x[torch.arange(OBS_BATCH, device=dev), last]
        has = rt.iterations > 0
        _require(torch.equal(row[has], rt.x[has]),
                 f"{name}: the last valid row is not x")
        _require(torch.equal(tr.valid.sum(dim=1), rt.iterations.long()),
                 f"{name}: valid rows != iterations")
        if name.startswith("solve_fast"):
            fast_trace, fast_res = tr, rt
            # and against solve_fast (K11) lane for lane: f32, so >= 0.99
            # of the lanes the same (each lane that parts printed), x
            # within 1e-3 max(1, |x|) on them
            rk = solve_fast(p_, o_)
            same15 = ((rt.status == rk.status)
                      & (rt.iterations == rk.iterations)
                      & (rt.active_set == rk.active_set).all(dim=1))
            rel15 = ((rt.x - rk.x).abs().amax(dim=1)
                     / rt.x.abs().amax(dim=1).clamp_min(1.0))[same15]
            print(f"{name} vs solve_fast (K11): lanes that part "
                  f"{torch.nonzero(~same15)[:, 0].tolist()}, max |x err| / "
                  f"max(1, |x|) {float(rel15.max())!r}")
            _require(float(same15.double().mean()) >= 0.99
                     and float(rel15.max()) <= 1e-3,
                     f"{name}: differs from solve_fast (K11)")
        else:   # and against solve_batch (K10) lane for lane
            rk = solve_batch(p_, o_)
            for k in ("status", "iterations", "active_set"):
                _require(torch.equal(getattr(rt, k), getattr(rk, k)),
                         f"{name}: {k} differs from solve_batch (K10)")
            _require(float((rt.x - rk.x).abs().max()) <= 1e-10,
                     f"{name}: x differs from solve_batch (K10)")
    print(f"traced solves (batch {OBS_BATCH}): equal to the untraced ones "
          f"with the plain versions of K11 and K10 bit for bit, and to K11 "
          f"and K10 lane for lane; the last valid row is x on every lane")
    n_it = int(fast_res.iterations[0])
    reset_counts()
    cap = capture_kernel_trajectory(pb15._map(lambda v: v[:1]), opt,
                                    n_iters=n_it + 1)
    torch.cuda.synchronize()
    cap_counts = counts()
    _require(cap_counts["gi_compact"] == n_it + 1
             and sum(cap_counts.values()) == n_it + 1,
             f"capture: {cap_counts}, expected {n_it + 1} K9 launches")
    cap_err = 0.0
    for k in range(n_it):
        ref_x = fast_trace.x[0, k]
        e = float((cap["x"][k, 0] - ref_x).abs().max()
                  / ref_x.abs().max().clamp_min(1.0))
        cap_err = max(cap_err, e)
    _require(cap_err <= 1e-4, f"capture vs fast trace: {cap_err} > 1e-4")
    _require(int(cap["term"][n_it, 0]) == 0, "capture: no SUCCESS at the "
             "last cap")
    script = dump_matlab("log", fast_trace, fast_res)
    print(f"capture_kernel_trajectory on lane 0: {n_it + 1} caps, launches "
          f"{cap_counts}, max |x - trace x| / max(1, |x|) {cap_err!r}, "
          f"SUCCESS at the last cap; dump_matlab: "
          f"{len(script.splitlines())} lines")
    small = random_qp_batch(gen, OBS_BATCH, 20, 30, ACT_FRAC,
                            dtype=f32).with_dtype(f64)
    solve_refined_kernel_compact(small, opt, ir_steps=IR_STEPS)
    with no_retrace():
        for p_ in (pb15, small, pb15, small):
            solve_refined_kernel(p_, opt, ir_steps=IR_STEPS)
            solve_refined_kernel_compact(p_, opt, ir_steps=IR_STEPS)
    print(f"no_retrace: 8 solves at (n, m) = ({N}, {M}) and (20, 30) built "
          f"and loaded nothing (library loads {_build.loads})")
    del pb14, pb15, pb15_32, small, fast_trace, cap

    # ---- phases 16-18: the small solvers, sharding and the corpus ----
    t_new = time.perf_counter()

    def timed(fn):
        """(fn's value, wall ms, launch counts) of one call, the counts set
        to 0 just before it."""
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t), counts()

    def phase_line(phase, path, wall_ms, launched, **extra):
        print(json.dumps({"phase": phase, "path": path, "wall_ms": wall_ms,
                          "launches": {k: v for k, v in launched.items()
                                       if v}, **extra}))

    def same_lanes(name, res, ref, x_tol):
        """Status, iterations and active set equal on every lane, x within
        x_tol."""
        for k in ("status", "iterations", "active_set"):
            _require(torch.equal(getattr(res, k), getattr(ref, k)),
                     f"{name}: {k} differs from the unsharded solve")
        err = float((res.x - ref.x).abs().max())
        _require(err <= x_tol, f"{name}: x differs by {err} > {x_tol}")
        return err

    # ---- phase 16: the small solvers ----
    rng16 = np.random.default_rng(SEED)
    shape16 = (BOX_BATCH, BOX_N)
    x0 = rng16.standard_normal(shape16)
    c16 = rng16.standard_normal(shape16)
    xl16 = -np.abs(rng16.standard_normal(shape16)) - 0.1
    xu16 = np.abs(rng16.standard_normal(shape16)) + 0.1
    bl16 = ((c16 * np.clip(x0, xl16, xu16)).sum(axis=1)
            + rng16.uniform(-0.5, 0.5, BOX_BATCH))
    box = [torch.from_numpy(v).to(dev) for v in (x0, c16, bl16, xl16, xu16)]
    opt_box = SolverOptions(max_iter=3 * BOX_N)
    res16, box_ms, c16_counts = timed(lambda: solve_box(*box, opt_box))
    _require(sum(c16_counts.values()) == 0, "solve_box launched a kernel")
    _require(res16.x.shape == shape16 and bool(torch.isfinite(res16.x).all()),
             "solve_box: output shape or non-finite x")
    ok16 = res16.status == 0
    kkt16 = float(kkt_residual(res16.x, res16.multipliers,
                               box_qp_problem(*box))[ok16].max())
    _require(kkt16 <= 1e-8, f"solve_box: KKT {kkt16} > 1e-8 on a SUCCESS "
             f"lane")
    gi16, _, c16g = timed(lambda: solve_box_gi(
        *[v[:CHECK_BATCH] for v in box], opt_box))
    _require({k: v for k, v in c16g.items() if v} == {"jr_loop": 1},
             f"solve_box_gi: launches {c16g}, expected K10 once")
    cf16 = res16.status[:CHECK_BATCH]
    _require(torch.equal(gi16.status, cf16),
             "solve_box and solve_box_gi end lanes with another status")
    both16 = gi16.status == 0
    gi_err16 = float((gi16.x[both16] - res16.x[:CHECK_BATCH][both16])
                     .abs().max())
    _require(gi_err16 <= 1e-10, f"solve_box vs solve_box_gi: x differs by "
             f"{gi_err16} > 1e-10")
    box_rate16 = float(ok16.double().mean())
    phase_line(16, "solve_box", box_ms, c16_counts, batch=BOX_BATCH, n=BOX_N,
               success_rate=box_rate16,
               infeasible=int((res16.status == 3).sum()),
               active_rate=float((res16.iterations > 0).double().mean()),
               max_kkt_success=kkt16,
               vs_solve_box_gi={"lanes": CHECK_BATCH,
                                "same_status": True,
                                "success_lanes": int(both16.sum()),
                                "max_abs_x_err": gi_err16,
                               "launches": {"jr_loop": 1}},
               solves_per_s=BOX_BATCH / _wall_s(
                   lambda: solve_box(*box, opt_box)), card=card)
    pb16 = random_qp_batch(gen, CHECK_BATCH, N, M, ACT_FRAC,
                           dtype=f32).with_dtype(f64)
    res16m, mixed_ms, c16m = timed(lambda: solve_mixed(pb16, opt))
    _require({k: v for k, v in c16m.items() if v} == {"jr_loop": 2},
             f"solve_mixed: launches {c16m}, expected K10 twice (f32, then "
             f"f64) and no other kernel")
    rate16m, kkt16m, pass16m = gate("solve_mixed", res16m, pb16)
    ref16, jr_ms, c16r = timed(lambda: solve_batch(pb16, opt))
    _require({k: v for k, v in c16r.items() if v} == {"jr_loop": 1},
             f"solve_batch: launches {c16r}, expected K10 once")
    _, _, pass16r = gate("solve_batch (J/R, f64)", ref16, pb16)
    both16m = pass16m & pass16r
    same16m = ((res16m.status == ref16.status)
               & (res16m.active_set == ref16.active_set).all(dim=1))
    _require(bool(same16m[both16m].all()), "solve_mixed and solve_batch "
             "differ in status or active set on a lane that passes both")
    x16m = float((res16m.x[both16m] - ref16.x[both16m]).abs().max())
    _require(x16m <= 1e-7, f"solve_mixed vs solve_batch: x differs by {x16m}")
    phase_line(16, "solve_mixed", mixed_ms, c16m, batch=CHECK_BATCH, n=N, m=M,
               pass_rate=rate16m, max_kkt=kkt16m,
               mean_it=float(res16m.iterations.double().mean()),
               vs_solve_batch={"lanes_passing_both": int(both16m.sum()),
                               "same_status_and_active_set": True,
                               "max_abs_x_err": x16m,
                               "solve_batch_wall_ms": jr_ms}, card=card)
    mixed_launches = c16m["jr_loop"] + c16r["jr_loop"] + c16g["jr_loop"]
    del box, res16, gi16

    # ---- phase 17: the fused_init=False path and the sharded solve ----
    pb17 = problems()
    res17, k3_path_ms, c17 = timed(lambda: solve_refined_kernel(
        pb17, opt, ir_steps=IR_STEPS, fused_init=False))
    _require(c17["gi_loop"] == 1 and sum(c17.values()) == 1,
             "fused_init=False did not run K3 once (and nothing else)")
    rate17, kkt17, _ = gate("fused_init=False (K3)", res17, pb17)
    phase_line(17, "solve_refined_kernel(fused_init=False)", k3_path_ms, c17,
               batch=BATCH, pass_rate=rate17, max_kkt=kkt17,
               mean_it=float(res17.iterations.double().mean()),
               solves_per_s=BATCH / _wall_s(lambda: solve_refined_kernel(
                   pb17, opt, ir_steps=IR_STEPS, fused_init=False)),
               card=card)
    # solve_sharded refines with the engines' default ir_steps (3), as the
    # JAX package's does: its unsharded references do the same
    refs17 = {True: solve_refined_kernel(pb17, opt, fused_init=True),
              False: solve_refined_kernel(pb17, opt, fused_init=False),
              "refined": fast.solve_refined(pb17, opt)}
    mesh1 = make_mesh()
    cards = tuple(torch.device("cuda", i)
                  for i in range(torch.cuda.device_count()))
    _require(mesh1.devices == cards, f"make_mesh(): {mesh1.devices}, "
             f"expected every card {cards}")
    sharded_launches = {"gi_fused": 0, "gi_loop": 0, "jr_loop": 0,
                        "fast_loop": 0}
    for label, mesh in ((f"make_mesh() ({mesh1.size} card(s))", mesh1),
                        ("4 shards on cuda:0", make_mesh(devices=[dev] * 4))):
        for engine, fused, pb_, ref in (
                ("pallas", True, pb17, refs17[True]),
                ("pallas", False, pb17, refs17[False]),
                ("f64", False, pb16, ref16),
                ("refined", False, pb17, refs17["refined"])):
            name = f"solve_sharded({engine}, fused_init={fused}) over {label}"
            # the timeline's events are recorded in the timed call itself
            # (two per shard and two per kernel; they launch nothing)
            with shard_timeline.record() as tl17:
                (res, stats), ms, cnt = timed(lambda: solve_sharded(
                    pb_, opt, mesh=mesh, engine=engine, fused_init=fused))
            want = {"jr_loop" if engine == "f64" else
                    "fast_loop" if engine == "refined" else
                    "gi_fused" if fused else "gi_loop": mesh.size}
            _require({k: v for k, v in cnt.items() if v} == want,
                     f"{name}: launches {cnt}, expected {want}")
            for k, v in want.items():
                sharded_launches[k] += v
            err = same_lanes(name, res, ref, 1e-10)
            alone = [solve_refined_kernel(shard, opt, fused_init=fused)
                     if engine == "pallas" else
                     fast.solve_refined(shard, opt) if engine == "refined"
                     else solve_batch(shard, opt)
                     for shard in shard_batch(pb_, mesh)]
            for f in dataclasses.fields(res):
                _require(torch.equal(getattr(res, f.name), torch.cat(
                    [getattr(r, f.name) for r in alone])),
                    f"{name}: {f.name} is not its shards' solved alone")
            it = res.iterations.long()
            _require((stats.total_iterations, stats.n_success,
                      stats.max_iterations)
                     == (int(it.sum()), int((res.status == 0).sum()),
                         int(it.max())), f"{name}: BatchStats {stats}")
            ov17 = tl17.overlap()
            _require(len(tl17.shards) == mesh.size
                     and ov17["shards_with_kernels"] == mesh.size,
                     f"{name}: timeline {ov17}")
            print(json.dumps({"phase": 17, "timeline": name,
                              "overlap": ov17, "shards": tl17.shards,
                              "moves": tl17.moves}))
            phase_line(17, name, ms, cnt, batch=pb_.batch, shards=mesh.size,
                       max_abs_x_err_vs_unsharded=err,
                       bit_for_bit_vs_shards_alone=True,
                       loop_concurrency=ov17["concurrency"],
                       stats=dataclasses.asdict(stats), card=card)
    bare17 = _wall_s(lambda: solve_refined_kernel(pb17, opt))
    mesh17 = _wall_s(lambda: solve_sharded(pb17, opt, mesh=mesh1,
                                           engine="pallas", fused_init=True))
    print(json.dumps({"phase": 17, "path": f"make_mesh() ({mesh1.size} "
                      "card(s)) overhead (pallas, fused_init=True)",
                      "bare_ms": 1e3 * bare17,
                      "sharded_ms": 1e3 * mesh17,
                      "overhead_ms": 1e3 * (mesh17 - bare17), "card": card}))
    del pb17, res17, refs17, pb16, res16m, ref16

    # ---- phase 18: the corpus ----
    qdir = os.path.join(ROOT, "tests", "data", "qps")
    corpus_loop_launches = corpus_jr_launches = corpus_fast_launches = 0

    def corpus(entries, engine, phase_gate, bucketed=True, qps_dir=qdir,
               path=None):
        nonlocal corpus_loop_launches, corpus_jr_launches
        nonlocal corpus_fast_launches
        rows, ms, cnt = timed(lambda: run_corpus(
            qps_dir=qps_dir, entries=entries, engine=engine,
            bucketed=bucketed))
        _require(len(rows) == len(entries), f"corpus {engine}: "
                 f"{len(rows)} rows for {len(entries)} entries")
        # "pallas" engines: K3 per bucket, "pallas_rescued" K10 on the
        # lanes it rescues; "f64": K10 per bucket (per row unbucketed);
        # "refined": K11 per bucket
        kernels = engine.startswith("pallas")
        _require(cnt["gi_fused"] == 0 and (cnt["gi_loop"] > 0) == kernels
                 and (cnt["jr_loop"] > 0 if engine == "f64" else
                      engine == "pallas_rescued" or cnt["jr_loop"] == 0)
                 and (cnt["fast_loop"] > 0) == (engine == "refined")
                 and sum(cnt.values()) == (cnt["gi_loop"] + cnt["jr_loop"]
                                           + cnt["fast_loop"]),
                 f"corpus {engine}: launches {cnt}")
        corpus_loop_launches += cnt["gi_loop"]
        corpus_jr_launches += cnt["jr_loop"]
        corpus_fast_launches += cnt["fast_loop"]
        for r in rows:
            if phase_gate is not None:
                _require(phase_gate(r), f"corpus {engine}: row {r}")
        phase_line(18, path or f"run_corpus({engine})", ms, cnt, rows=[
            {k: r[k] for k in ("name", "status", "obj_ok", "kkt_residual",
                               "iterations")} for r in rows],
            gated=phase_gate is not None, card=card)

    def strict_gate(r):
        return (r["status"] == "SUCCESS" and r["obj_ok"]
                and r["kkt_residual"] <= 1e-8)

    strict = [e for e in MAROS_MESZAROS if e.name in VENDORED_STRICT]
    singular = [e for e in MAROS_MESZAROS if e.name in VENDORED_SINGULAR]
    _require(len(strict) == len(singular) == 8, "vendored corpus entries")
    for engine in ("f64", "pallas_rescued"):
        corpus(strict, engine, strict_gate)
    for engine in ("refined", "pallas"):
        corpus(strict, engine, None)
    corpus(singular, "f64", lambda r: (r["status"] == "SUCCESS" and r["obj_ok"])
           or r["status"] == "NON_POS_HESSIAN", bucketed=False,
           path="run_corpus(f64, unbucketed), singular G")
    smem = lib.jrlqp_gi_smem_bytes(136, 128)
    threads, blocks = gi_kernel.residency("jrlqp_gi_loop", 128, 128)
    print(json.dumps({"phase": 18, "K3 at (np, mp)": [136, 128],
                      "smem_bytes": smem, "limit": gi_kernel._SMEM_LIMIT,
                      "threads": threads, "blocks_per_sm": blocks}))
    _require(smem <= gi_kernel._SMEM_LIMIT and blocks >= 1,
             "K3 does not fit at (136, 128)")
    # K3 against its plain version at that shape: 64 lanes of the headline
    # distribution at n = 128, m = 100, padded to the bucket
    pb18 = pad_problem(random_qp_batch(gen, 64, 128, 100, ACT_FRAC,
                                       dtype=f32).with_dtype(f64), 128, 128)
    pb18_32 = pb18.with_dtype(f32)
    st18 = fast._init_fast(pb18_32, opt.with_(dtype=f32,
                                              zero_z_threshold=1e-6))
    k3_136 = against_plain("K3 at (136, 128)",
                           gi_kernel.run_loop(pb18_32, st18, 400),
                           gi_kernel.gi_loop_plain(pb18_32, st18, 400), pb18)
    del pb18, pb18_32, st18
    with tempfile.TemporaryDirectory() as tmp:
        rng18 = np.random.default_rng(7)
        large = []
        for i, (n, n_ineq, n_act, bnd, dbl) in enumerate(LARGE_SPECS):
            rp = random_problem(ProblemCharacteristics(
                n_var=n, n_obj=n, n_ineq=n_ineq, n_strong_act_ineq=n_act,
                bounds=bnd, n_strong_act_bounds=1 if bnd else 0,
                double_sided_ineq=dbl), rng18)
            d = rp.to_qp_arrays()
            r = rp.A @ rp.x - rp.b
            name = f"synth{i:02d}"
            with open(os.path.join(tmp, f"{name}.qps"), "w") as fh:
                fh.write(write_qps(name, d["G"], d["a"], d["C"], d["l"],
                                   d["u"], d["xl"], d["xu"],
                                   objcst=d["objcst"]))
            large.append(MarosMeszarosEntry(
                name=name, fstar=0.5 * float(r @ r), cond=1.0,
                nb_cstr=d["C"].shape[0], nb_var=n,
                nz=int(np.count_nonzero(d["C"])), qn=n, qnz=0))
        corpus(large, "pallas_rescued", strict_gate, qps_dir=tmp,
               path="run_corpus(pallas_rescued), LARGE_SPECS")
    new_s = time.perf_counter() - t_new
    print(json.dumps({"phases": "16-18", "wall_s": new_s}))

    # ---- phase 19: the harness, the compacted solve, the native readers ----
    t19 = time.perf_counter()
    harness_launches = dict.fromkeys(counts(), 0)
    opt_h = SolverOptions(max_iter=500)      # time_batch's default options

    def bench(path, fn, need, gate_rows=None, may=(), **extra):
        """Run the harness call ``fn`` with the counts set to 0 just before
        it and read just after; every kernel in ``need`` must have been
        launched, and no other but those in ``may``; ``gate_rows(row)`` ->
        (min rate, value) or None for each row. Prints the phase line and
        returns the rows."""
        out, ms, cnt = timed(fn)
        for k in need:
            _require(cnt[k] > 0, f"{path}: {k} was not launched")
        _require(all(cnt[k] == 0 for k in cnt
                     if k not in need and k not in may),
                 f"{path}: launches {cnt}, expected only {need}")
        for k, v in cnt.items():
            harness_launches[k] += v
        rows = [r.row() if dataclasses.is_dataclass(r) else r
                for r in (out if isinstance(out, list) else [out])]
        gated = []
        for r in rows:
            g = gate_rows(r) if gate_rows is not None else None
            if g is not None:
                _require(g[1] >= g[0], f"{path} {r['name']}: {g[1]} < {g[0]}")
                gated.append(r["name"])
        phase_line(19, path, ms, cnt, rows=rows, gated=gated, card=card,
                   **extra)
        return rows, cnt

    def kkt_gate(min_rate):
        return lambda r: (min_rate, r["kkt_pass_rate"])

    # time_batch at the headline set: the kernel engines at batch 16384,
    # the f64 J/R engines (launch-bound passes) at their 1024 cut
    pb19 = problems()
    bench("time_batch(pallas) headline", lambda: harness.time_batch(
        "headline/pallas", pb19, opt, solver="pallas"), ["gi_fused"],
        kkt_gate(0.999))
    bench("time_batch(pallas_rescued) headline", lambda: harness.time_batch(
        "headline/pallas_rescued", pb19, opt, solver="pallas_rescued"),
        ["gi_loop"], kkt_gate(1.0), may=["jr_loop"])
    pb19s = random_qp_batch(gen, CHECK_BATCH, N, M, ACT_FRAC,
                            dtype=f32).with_dtype(f64)
    for solver, min_rate, need in (("f64", 0.999, ["jr_loop"]),
                                   ("mixed", 0.999, ["jr_loop"]),
                                   ("refined", None, ["fast_loop"])):
        bench(f"time_batch({solver}) headline, batch {CHECK_BATCH}",
              lambda: harness.time_batch(f"headline/{solver}", pb19s, opt,
                                         solver=solver, n_rep=1), need,
              None if min_rate is None else kkt_gate(min_rate))
    del pb19, pb19s

    # the size sweep: K1 up to n = 100, m = 200 (one block per SM there).
    # At each size K1 is held to its plain version on the sweep's own
    # draws (the whole batch where the plain version is cheap, else its
    # first CHECK_BATCH lanes), and each lane the sweep's row misses
    # (time_batch: K1 and 3 refinement steps) is solved again by the plain
    # version alone and by the f64 J/R engine, so that a fault of K1 shows
    # apart from a lane that f32 cannot solve
    k1_sizes, k1_size_err = [], {}
    for n_ in SWEEP_SIZES:
        threads, blocks = gi_kernel.residency("jrlqp_gi_fused", n_, 2 * n_)
        smem = lib.jrlqp_gi_smem_bytes(gi_kernel._round_up(n_ + 1, 8),
                                       gi_kernel._round_up(2 * n_, 8))
        pb_n = harness._qp_batch(SEED, BATCH, n_, 2 * n_, ACT_FRAC,
                                 dev).with_dtype(f64)
        inputs, (n, m) = gi_kernel.prepare(pb_n.with_dtype(f32))
        ms = _cuda_ms(lambda: gi_kernel._gi_fused_cuda_raw(
            *inputs, n, m, opt_h.max_iter))
        its = int(gi_kernel._gi_fused_cuda_raw(
            *inputs, n, m, opt_h.max_iter)[4][:, 1].sum())
        del inputs
        lanes = BATCH if n_ <= 25 else CHECK_BATCH
        pb_c = pb_n._map(lambda t: t[:lanes])
        ok_k = gi_kernel.run_loop_fused(pb_c.with_dtype(f32), opt_h.max_iter)
        ok_p = gi_kernel.gi_fused_plain(pb_c.with_dtype(f32), opt_h.max_iter)
        torch.cuda.synchronize()
        err = against_plain(f"K1 at n={n_}, m={2 * n_} (the sweep's "
                            f"draws)", ok_k, ok_p, pb_c)
        k1_size_err[n_] = err
        res_n = solve_refined_kernel(pb_n, opt_h)
        kkt_n = kkt_residual(res_n.x, res_n.multipliers, pb_n)
        miss = torch.nonzero(~((res_n.status == 0) & (kkt_n <= 1e-8)))[:, 0]
        missed = []
        if miss.numel():
            sub = pb_n._map(lambda t: t[miss])
            sub_p = fast._solve_refined(sub, opt_h, 3, gi_kernel.gi_fused_plain)
            sub_64 = dense.solve_batch(sub, opt_h)
            kkt_p = kkt_residual(sub_p.x, sub_p.multipliers, sub)
            kkt_64 = kkt_residual(sub_64.x, sub_64.multipliers, sub)
            for j, lane in enumerate(miss.tolist()):
                row = {"lane": lane, "k1": [int(res_n.status[lane]),
                                            int(res_n.iterations[lane]),
                                            float(kkt_n[lane])],
                       "plain_alone": [int(sub_p.status[j]),
                                       int(sub_p.iterations[j]),
                                       float(kkt_p[j])],
                       "f64_jr": [int(sub_64.status[j]),
                                  int(sub_64.iterations[j]),
                                  float(kkt_64[j])]}
                if lane < lanes:   # held above: both raw terms there
                    row["raw_term_k1_plain"] = [int(ok_k["term"][lane]),
                                                int(ok_p["term"][lane])]
                missed.append(row)
            del sub, sub_p, sub_64
        k1_sizes.append({"n": n_, "m": 2 * n_, "smem_bytes": smem,
                         "threads": threads, "blocks_per_sm": blocks,
                         "k1_ms": ms, "mean_it": its / BATCH,
                         "us_per_iteration_per_block":
                             1e3 * ms * sms * blocks / its,
                         "lanes_vs_plain": lanes,
                         "max_abs_err_vs_plain": err,
                         "missed_lanes [status, iterations, kkt]": missed})
        del pb_n, pb_c, ok_k, ok_p, res_n, kkt_n
    print(json.dumps({"phase": 19, "K1 by size (batch 16384, max_iter "
                      f"{opt_h.max_iter})": k1_sizes, "card": card}))
    bench("bench_size_sweep(pallas)", lambda: harness.bench_size_sweep(
        SWEEP_SIZES, batch=BATCH, solver="pallas", seed=SEED, device=dev),
        ["gi_fused"], lambda r: (0.999, r["kkt_pass_rate"])
        if r["name"] == f"size/n={N}/m={M}" else None)
    bench("bench_active_sweep(pallas)", lambda: harness.bench_active_sweep(
        N, M, batch=BATCH, solver="pallas", seed=SEED, device=dev),
        ["gi_fused"], lambda r: (0.999, r["kkt_pass_rate"])
        if int(r["name"].split("/")[1][:-1]) <= 30 else None)

    # the warm-start trajectory: a cold K1 step, then K4 steps
    traj_steps = 12
    _, cnt = bench("bench_warm_start_trajectory(pallas)",
                 lambda: harness.bench_warm_start_trajectory(
                     N, M, steps=traj_steps, batch=BATCH, seed=SEED,
                     solver="pallas", time_window=10, device=dev),
                 ["gi_fused", "gi_warm"], lambda r: (0.999, min(
                     r["warm_success"], r["cold_success"])))
    _require(cnt["gi_warm"] == traj_steps - 1
             and cnt["gi_fused"] == traj_steps + 1,
             f"the warm trajectory: launches {cnt}, expected K1 "
             f"{traj_steps + 1} times (one cold step, {traj_steps} cold "
             f"solves) and K4 on each of its {traj_steps - 1} warm steps")
    bench("bench_warm_start_trajectory(f64), batch 256",
          lambda: harness.bench_warm_start_trajectory(
              steps=4, batch=256, seed=SEED, solver="f64", device=dev),
          ["jr_loop"])

    # the structured rows: K5, K7 and K5 + K6 beside the composed chains
    # and torch.linalg.cholesky; the IK batch on K5 + K6, the composed
    # blocks and the dense engine
    # K5, K6 and K7 on the decompositions' own draws first: no other path
    # runs s = 48 (K8 comes with the arrow chain's check)
    d_dec, o_dec = (torch.from_numpy(v).to(dev, f32) for v in
                    harness.decomposition_inputs(DEC_NB, DEC_S, IK_BATCH,
                                                 SEED))
    n_dec = DEC_NB * DEC_S
    eye_dec = torch.eye(n_dec, device=dev).reshape(1, DEC_NB, DEC_S, n_dec)
    eye_dec = eye_dec.expand(IK_BATCH, -1, -1, -1).contiguous()
    rel_dec = hold_chains(("tri", "arrow_down"), d_dec, o_dec, eye_dec,
                          f"the decompositions' draws, batch {IK_BATCH}, "
                          f"nb={DEC_NB}, s={DEC_S}")
    del d_dec, o_dec, eye_dec
    bench("bench_decompositions", lambda: harness.bench_decompositions(
        nb=DEC_NB, s=DEC_S, batch=IK_BATCH, seed=SEED, device=dev),
        ["tri_block_llt", "tri_block_solve", "block_arrow_llt"],
        max_rel_err_vs_plain=rel_dec)
    bench("bench_structured_ik", lambda: harness.bench_structured_ik(
        nb=IK_NB, s=IK_S, mc=IK_MC, batch=IK_BATCH, seed=SEED, device=dev),
        ["tri_block_llt", "tri_block_solve", "fast_loop", "struct_gmul",
         "struct_update"],
        lambda r: (0.999, r["success_rate"]))

    # the box batch: the draws of phase 16, whose KKT <= 1e-8 gate holds
    # on every SUCCESS lane
    rows, _ = bench("bench_box_single", lambda: harness.bench_box_single(
        BOX_N, batch=BOX_BATCH, seed=SEED, device=dev), [])
    _require(rows[0]["success_rate"] == box_rate16,
             "bench_box_single: another success rate than phase 16's solve")

    # weak scaling: one card runs mesh 1 alone
    rows, _ = bench("bench_scaling(pallas)", lambda: harness.bench_scaling(
        n=N, m=M, per_device_batch=BATCH, engine="pallas", seed=SEED),
        ["gi_fused"], lambda r: (0.999, r["success_rate"]),
        cards=torch.cuda.device_count())
    print(json.dumps({"phase": 19, "bench_scaling": "mesh sizes run: "
                      f"{[r['mesh_size'] for r in rows]} of (1, 2, 4, 8) on "
                      f"{torch.cuda.device_count()} card(s)"}))

    # the compacted solve against one K3 launch (fused_init=False)
    pb19 = problems()
    cap = max(1, min(int(MAX_ITER * 0.45), MAX_ITER))
    res_c, comp_ms, c19 = timed(lambda: solve_refined_kernel_compacted(
        pb19, opt, ir_steps=IR_STEPS, phase1_frac=0.45))
    _require(c19["gi_loop"] == 2 and sum(c19.values()) == 2,
             f"compacted solve: launches {c19}, expected K3 twice")
    res_1, one_ms, c19_1 = timed(lambda: solve_refined_kernel(
        pb19, opt, ir_steps=IR_STEPS, fused_init=False))
    harness_launches["gi_loop"] += c19["gi_loop"] + c19_1["gi_loop"]
    for k in ("status", "iterations"):
        _require(torch.equal(getattr(res_c, k), getattr(res_1, k)),
                 f"compacted solve: {k} differs from one K3 launch")
    comp_err = float((res_c.x - res_1.x).abs().max())
    _require(comp_err <= 1e-9, f"compacted solve: x differs by {comp_err}")
    rate19, kkt19, _ = gate("compacted solve", res_c, pb19)
    pb19_32 = pb19.with_dtype(f32)
    st19 = fast._state_from_kernel_out(gi_kernel.run_loop(
        pb19_32, fast._init_fast(pb19_32, opt.with_(
            dtype=f32, zero_z_threshold=1e-6)), cap), BATCH)
    capped = st19.term == MAX_ITER_REACHED
    phase2, pending = int(capped.sum()), int((capped & st19.skip1).sum())
    phase_line(19, "solve_refined_kernel_compacted", comp_ms, c19,
               batch=BATCH, phase1_cap=cap, phase2_lanes=phase2,
               phase2_pending_candidates=pending, pass_rate=rate19,
               max_kkt=kkt19, same_status_and_iterations=True,
               max_abs_x_err_vs_one_launch=comp_err,
               best_of_3_ms=1e3 * _wall_s(
                   lambda: solve_refined_kernel_compacted(
                       pb19, opt, ir_steps=IR_STEPS, phase1_frac=0.45)),
               one_launch_ms=one_ms, one_launch_best_of_3_ms=1e3 * _wall_s(
                   lambda: solve_refined_kernel(pb19, opt, ir_steps=IR_STEPS,
                                                fused_init=False)),
               card=card)
    del pb19, pb19_32, st19, res_c, res_1

    # the host C++ readers (built in phase 1) against the Python parser
    files = sorted(f for f in os.listdir(qdir) if f.endswith(".QPS"))
    for f in files:
        a = read_qps(os.path.join(qdir, f), engine="native")
        b = read_qps(os.path.join(qdir, f), engine="python")
        for k in ("G", "a", "C", "l", "u", "xl", "xu"):
            x, y = getattr(a, k), getattr(b, k)
            _require(x.dtype == y.dtype and x.tobytes() == y.tobytes(),
                     f"native reader: {f} {k} differs from the Python one")
        _require((a.name, a.objcst, a.n_eq) == (b.name, b.objcst, b.n_eq),
                 f"native reader: {f} header differs from the Python one")
    print(json.dumps({"phase": 19, "path": "read_qps(native) vs "
                      "read_qps(python)", "files": len(files),
                      "bitwise_equal": True, "build": native.build_info}))
    t19 = time.perf_counter() - t19
    print(json.dumps({"phase": 19, "wall_s": t19}))

    # ---- phase 20: the missed lanes of both packages ----
    t20 = time.perf_counter()
    k1_missed = sorted(r["lane"] for r in census_lanes.values()
                       if not r["outcomes"]["kernel_card"]["passed"])
    _require(missed4 == k1_missed,
             f"main path misses lanes {missed4}, the census {k1_missed}")
    for r in census_lanes.values():
        for k in miss_census.ARRAYS:
            _require(np.array_equal(arrays4[r["lane"]][k], r["arrays"][k]),
                     f"{miss_census.lane_id(r)}: {k} is not phase 4's draw")
    reset_counts()
    per_set, cross = {}, {}
    brief = ("status", "iterations", "passed")
    for which, path in MISSED_LANE_FILES.items():
        lanes20 = miss_census.load_lanes(path)[0]
        for r in lanes20:
            got = miss_census.solve_alone(r, dev)
            for w in ("kernel", "plain"):
                want = r["outcomes"][f"{w}_card_alone"]
                _require(miss_census.same_outcome(got[w], want),
                         f"{which} lane {miss_census.lane_id(r)}: {w} gives "
                         f"{[got[w][k] for k in brief]}, recorded "
                         f"{[want[k] for k in brief]}")
            key = f"{which}:{r['set']}"
            per_set[key] = per_set.get(key, 0) + 1
        # port-missed lanes the JAX kernel passes, JAX-missed lanes the
        # card's kernel passes (each lane alone)
        if which == "port":
            missed = [r for r in lanes20 if "kernel_card" in r["missed_by"]]
            other = "jax_pallas_alone"
        else:
            missed = [r for r in lanes20 if "jax_pallas" in r["missed_by"]]
            other = "kernel_card_alone"
        cross[which] = [len(missed), sum(r["outcomes"][other]["passed"]
                                         for r in missed)]
    # K10 on every lane with an f64 J/R record (f64_jr_card, the census's
    # solve_batch on the card): the lane alone through solve_batch, held to
    # the record's status, pass and x
    jr20, jr20_err = 0, 0.0
    for which, path in MISSED_LANE_FILES.items():
        for r in miss_census.load_lanes(path)[0]:
            want = r["outcomes"].get("f64_jr_card")
            if want is None:
                continue
            sub = miss_census.lane_problem(r, dev)
            got = miss_census.outcomes(solve_batch(
                sub, SolverOptions(max_iter=r["max_iter"])), sub)[0]
            lane = f"{which} lane {miss_census.lane_id(r)}"
            _require(got["status"] == want["status"] and got["passed"]
                     and want["passed"], f"{lane}: K10 gives "
                     f"{[got[k] for k in brief]}, f64_jr_card "
                     f"{[want[k] for k in brief]}")
            err = float(np.abs(got["x"] - want["x"]).max())
            _require(err <= 1e-7, f"{lane}: K10's x differs from "
                     f"f64_jr_card by {err} > 1e-7")
            jr20, jr20_err = jr20 + 1, max(jr20_err, err)
    _require(jr20 > 0, "phase 20 held no lane to f64_jr_card")
    # K1's order-exact replay (testing.k1_replay) on this host's CPU
    # against K1's own launch on every K1 lane of both files, the whole f32
    # state bit for bit (raw x by its bits)
    replay_lanes = replay_cpu_s = replay_wall_s = 0
    for which, path in MISSED_LANE_FILES.items():
        for r in miss_census.load_lanes(path)[0]:
            if r["path"] != "K1":
                continue
            pb32 = miss_census.lane_problem(r, dev).with_dtype(torch.float32)
            out = gi_kernel.run_loop_fused(pb32, r["max_iter"])
            card_raw = {k: (v[0] if v.dim() > 1 else v.reshape(-1)[0])
                        .cpu().numpy() for k, v in out.items()}
            t0, c0 = time.perf_counter(), time.process_time()
            rep = k1_replay.k1_order_solve(r["arrays"], r["max_iter"],
                                           r["ir_steps"])["raw"]
            replay_cpu_s += time.process_time() - c0
            replay_wall_s += time.perf_counter() - t0
            lane = f"{which} lane {miss_census.lane_id(r)}"
            _require(np.array_equal(rep["x"].view(np.int32),
                                    card_raw["x"].view(np.int32)),
                     f"{lane}: the replay's raw x differs from K1's")
            for k in k1_replay.STATE_KEYS:
                _require(np.array_equal(np.asarray(rep[k]), card_raw[k]),
                         f"{lane}: the replay's {k} differs from K1's")
            replay_lanes += 1
    _require(replay_lanes > 0, "phase 20 replayed no K1 lane")
    print(json.dumps({"phase": 20, "k1_order_solve_vs_k1_launch": {
        "lanes_equal_bit_for_bit": replay_lanes, "cpu_s": replay_cpu_s,
        "wall_s": replay_wall_s, "cpu_s_per_lane": replay_cpu_s / replay_lanes,
        "host_cpus": os.cpu_count(), "torch_threads":
            torch.get_num_threads()}, "card": card}))
    # K1's per-operation split on the lanes of queue 3d: its states at the
    # census's caps, taken again on this card and held to the committed
    # ones bit for bit, each iteration replayed in K1's order and held to
    # the next state, the deciding slack's error split at the parting
    saved = {(r["file"], r["lane"]): r
             for r in miss_census.load_lanes(SPLIT_STATES_FILE)[0]}
    split3d = {}
    for which, lane in SPLIT_3D_LANES:
        rec = next(r for r in miss_census.load_lanes(
            MISSED_LANE_FILES[which])[0] if miss_census.lane_id(r) == lane)
        caps = [int(c) for c in saved[(which, lane)]["caps"]]
        traj = miss_census.trajectory(rec["path"], miss_census.lane_problem(
            rec, dev), rec["max_iter"], caps, full=True)
        for k, v in saved[(which, lane)]["states"].items():
            _require(np.array_equal(traj[k], v),
                     f"split states of {lane}: {k} differs from the card's "
                     f"committed states")
        d = op_split.f32_data(rec["arrays"])
        for i in range(len(caps) - 1):
            if caps[i + 1] == caps[i] + 1:
                st, nxt = op_split.states_at(traj, caps, caps[i:i + 2])
                _require(op_split.same_next(op_split.k1_iteration(st, d),
                                            nxt),
                         f"{lane}: K1's replay of cap {caps[i]} differs")
        lo = rec["verdict"]["iteration"] - 1
        window = op_split.vertex_window(traj, caps, lo)
        got = op_split.split_at_parting(
            d, op_split.states_at(traj, caps, window),
            rec["verdict"]["constraint"])
        last = got["ops"][-2]
        split3d[lane] = {
            "caps": [window[0], lo], "replayed": got["replayed"],
            "parts_ulps": {k: round(v, 3) for k, v in got["split"].items()},
            "own_rounding_ulps": {
                "slack": round(got["ops"][-1]["slack"], 3),
                **{k: round(last[k], 3) for k in (
                    "z", "t1", "t2", "x_update", "rank_one") if k in last}}}
    print(json.dumps({"phase": 20, "k1_split_on_3d_lanes": split3d,
                      "card": card}))
    c20 = counts()
    torch.cuda.synchronize()
    for k in ("gi_fused", "gi_loop", "gi_compact", "jr_loop"):
        _require(c20[k] > 0, f"phase 20 did not launch {k}")
    print(json.dumps({
        "phase": 20, "lanes_per_file_and_set": per_set,
        "launches": c20, "all_outcomes_as_recorded": True,
        "main_path_missed_lanes": missed4,
        "k10_lanes_held_to_f64_jr_card": jr20,
        "k10_max_abs_x_err_vs_f64_jr_card": jr20_err,
        "port_kernel_missed, of them passed by the JAX kernel":
            cross["port"],
        "jax_kernel_missed, of them passed by the card's kernel":
            cross["jax"],
        "wall_s": time.perf_counter() - t20, "card": card}))

    src = "jrlqp_tpu_torch/csrc/gi_kernel.cu"
    pallas = "jrlqp_tpu/ops/pallas/gi_kernel.py"
    kernels = [
        {"name": "gi_fused", "route": "cuda", "source": src,
         "replaces": f"{pallas}:674",
         "launches": (main_counts["gi_fused"] + sharded_launches["gi_fused"]
                      + harness_launches["gi_fused"]),
         "launches_by_path": {"main": main_counts["gi_fused"],
                              "solve_sharded": sharded_launches["gi_fused"],
                              "harness": harness_launches["gi_fused"]},
         "max_abs_err": k1_err,
         "max_abs_err_by_sweep_size": k1_size_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None, **res_k1},
        {"name": "chol_inv_b", "route": "cuda",
         "source": "jrlqp_tpu_torch/csrc/block_llt.cuh",
         "replaces": "jrlqp_tpu/ops/pallas/block_llt.py:89",
         "launches": main_counts["chol_inv_b"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": k2_lib_ms,
         "library": "torch.linalg.cholesky_ex + torch.linalg."
                    "solve_triangular (2 calls)",
         "runs_inside": "gi_fused"},
        {"name": "gi_loop", "route": "cuda", "source": src,
         "replaces": f"{pallas}:628",
         "launches": (hint_counts["gi_loop"] + c17["gi_loop"]
                      + sharded_launches["gi_loop"] + corpus_loop_launches
                      + harness_launches["gi_loop"]),
         "launches_by_path": {"hint": hint_counts["gi_loop"],
                              "fused_init=False": c17["gi_loop"],
                              "solve_sharded": sharded_launches["gi_loop"],
                              "run_corpus": corpus_loop_launches,
                              "harness and compacted":
                                  harness_launches["gi_loop"]},
         "max_abs_err": k3_err, "max_abs_err_at_136x128": k3_136,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None, **res_k3},
        {"name": "gi_warm", "route": "cuda", "source": src,
         "replaces": f"{pallas}:836",
         "launches": traj_counts["gi_warm"] + harness_launches["gi_warm"],
         "launches_by_path": {"trajectory": traj_counts["gi_warm"],
                              "harness": harness_launches["gi_warm"]},
         "max_abs_err": k4_err, "reset_lanes": reset10,
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound[0],
         "bound_by": k4_bound[1], "library_ms": None, **res_k4},
        {"name": "gi_compact", "route": "cuda", "source": src,
         "replaces": f"{pallas}:104",
         "launches": compact_counts["gi_compact"], "max_abs_err": k9_err,
         "ms": k9_ms, "plain_ms": k9_plain_ms, "bound_ms": k9_bound[0],
         "bound_by": k9_bound[1], "library_ms": None, **res_k9},
    ]
    struct_src = "jrlqp_tpu_torch/csrc/struct_llt.cu"
    struct_pallas = "jrlqp_tpu/ops/pallas/block_llt.py"
    for key, name, line, launched in (
            ("K5", "tri_block_llt", 225, cold_counts),
            ("K6", "tri_block_solve", 283, cold_counts),
            ("K7", "block_arrow_llt", 350, arrow_counts["BLOCK_ARROW_UP"]),
            ("K8", "block_arrow_solve", 405,
             arrow_counts["BLOCK_ARROW_UP"])):
        kernels.append({
            "name": name, "route": "cuda", "source": struct_src,
            "replaces": f"{struct_pallas}:{line}",
            "launches": launched[name] + harness_launches[name],
            "launches_by_path": {"structured": launched[name],
                                 "harness": harness_launches[name]},
            "max_abs_err": struct_err[key],
            "ms": struct_ms[key][0], "plain_ms": struct_ms[key][1],
            "bound_ms": struct_bound[key][0],
            "bound_by": struct_bound[key][1],
            "library_ms": lib_ms.get(key), **({
                "threads": fac_cfg[key]["threads"],
                "blocks_per_sm": fac_cfg[key]["blocks_per_sm"]}
                if key in fac_cfg else {})})
    kernels.append({
        "name": "jr_loop", "route": "cuda",
        "source": "jrlqp_tpu_torch/csrc/jr_kernel.cu",
        "replaces": "jrlqp_tpu/solver/dense.py:403",
        "launches": jr_counts["jr_loop"],
        "launches_by_path": {
            "solve_batch": jr_counts["jr_loop"],
            "solve_warm": c14w["jr_loop"],
            "rescue": rescue_launches,
            "solve_mixed, solve_batch, solve_box_gi (phase 16)":
                mixed_launches,
            "solve_sharded": sharded_launches["jr_loop"],
            "run_corpus": corpus_jr_launches,
            "harness": harness_launches["jr_loop"]},
        "max_abs_err": k10_err, "max_abs_err_f32": k10_err32,
        "ms": k10_ms, "plain_ms": k10_plain_ms, "bound_ms": k10_bound[0],
        "bound_by": k10_bound[1], "library_ms": None,
        "f32": {"ms": k10_ms32, "plain_ms": k10_plain_ms32,
                "bound_ms": k10_bound32[0], "bound_by": k10_bound32[1]},
        "threads": 128})
    ik11 = k11["IK cold"]
    kernels.append({
        "name": "fast_loop", "route": "cuda",
        "source": "jrlqp_tpu_torch/csrc/fast_loop.cu",
        "replaces": "jrlqp_tpu/solver/fast.py:349",
        "launches": cold_counts["fast_loop"],
        "launches_by_path": {
            "structured cold batch (phase 9)": cold_counts["fast_loop"],
            "structured arrows (phase 9)": sum(
                c["fast_loop"] for c in arrow_counts.values()),
            "IK trajectory (phase 10)": traj_ik_counts["fast_loop"],
            "solve_sharded refined": sharded_launches["fast_loop"],
            "run_corpus refined": corpus_fast_launches,
            "harness": harness_launches["fast_loop"]},
        "max_abs_err": ik11["max_abs_x_err"],
        "ms": ik11["ms"], "plain_ms": ik11["plain_ms"],
        "bound_ms": ik11["bound_ms"], "bound_by": ik11["bound_by"],
        "library_ms": None,
        "shape": {k: ik11[k] for k in ("batch", "n", "m", "dtype")},
        "headline": {k: {f: k11[k][f] for f in (
            "ms", "plain_ms", "bound_ms", "bound_by", "same_lanes",
            "max_rel_x_err")}
            for k in ("headline f32", "headline f64")},
        **{k: ik11["config"][k] for k in ("threads", "blocks_per_sm",
                                          "registers", "smem_bytes")}})
    kernels.append({
        "name": "carry_init", "route": "cuda",
        "source": "jrlqp_tpu_torch/csrc/carry_init.cu", "kernel": "K12",
        "replaces": "jrlqp_tpu/solver/fast.py:851-895, :971-1009 (XLA)",
        "launches": traj_ik_counts["carry_init"],
        "launches_by_path": {
            "IK trajectory (phase 10)": traj_ik_counts["carry_init"]},
        "max_abs_err": k12["max_rel_err"]["x"],
        **{k: k12[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        **{k: k12["config"][k] for k in ("threads", "blocks_per_sm",
                                          "registers", "smem_bytes")}})
    for name, which in (("struct_gmul", "K13"), ("struct_update", "K14")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "jrlqp_tpu_torch/csrc/struct_refine.cu",
            "replaces": "jrlqp_tpu/solver/fast.py:397 (XLA ops)",
            "kernel": which, "launches": cold_counts[name],
            **k13_14[name],
            "launches_by_path": {
                "structured cold batch (phase 9)": cold_counts[name],
                "structured arrows (phase 9)": sum(
                    c[name] for c in arrow_counts.values()),
                "IK trajectory (phase 10)": traj_ik_counts[name],
                "harness": harness_launches[name]}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
