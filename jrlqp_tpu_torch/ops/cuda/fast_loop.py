"""K11: the explicit-form engine's GI loop as one CUDA kernel, its wrapper,
and its counts of work.

Counterpart of the loop that the JAX package compiles into one
``lax.while_loop`` of ``fast_iteration`` (``jrlqp_tpu/solver/fast.py:167-
246``): ``_run_fast`` (fast.py:349, behind ``solve_fast`` and
``solve_refined``), ``solve_fast_warm`` (fast.py:911) and the structured
solver's fast paths (``jrlqp_tpu/structured/solver.py:322``, :440, :506).
The JAX package has no Pallas kernel here: XLA compiles the loop. The
port's kernel, ``fast_loop_kernel`` in ``csrc/fast_loop.cu``, runs it from
a given ``FastState`` with one thread block per lane, each lane's
iterations back to back, in f32 (``jrlqp_fast_loop_f32``) and f64
(``jrlqp_fast_loop_f64``), H streamed from device memory; and its on-chip
instance ``fast_loop_kernel_onchip`` (``jrlqp_fast_loop_onchip_f32``), a
thread-block cluster per lane that holds the lane's H in its blocks' shared
memory, for f32 from n = 256 on where H fits a cluster of at most 8 blocks
(:func:`fast_loop_plan`). The two return the same bits. Its plain version is
:func:`jrlqp_tpu_torch.solver.fast.fast_loop_plain`, the masked passes of
:func:`~jrlqp_tpu_torch.solver.fast.fast_iteration` in a host loop;
``solver.fast._run_loop`` chooses between the two by the state's device.

:func:`fast_loop` launches the instance that :func:`fast_loop_plan`
chooses from (n, m, dtype) on a CUDA state; it raises for another dtype.
The kernel's result is the plain version's lane for lane up to the order
of its sums: the same status, iterations and active set, x within
rounding.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...problems import QPProblem
from ...solver.state import FastState
from ...types import SolverOptions
from ...utils import spans
from . import _build

__all__ = ["fast_loop", "fast_loop_config", "fast_loop_plan",
           "fast_loop_smem_bytes", "fast_loop_flops", "fast_loop_bytes",
           "fast_loop_stream_bytes", "fast_loop_onchip_bytes"]

_ENTRIES = {torch.float32: "jrlqp_fast_loop_f32",
            torch.float64: "jrlqp_fast_loop_f64"}
_ONCHIP_ENTRY = "jrlqp_fast_loop_onchip_f32"
# the dynamic shared memory one block may use on Hopper, less 2 KB for the
# kernel's static scratch (1,152 B at 256 threads in f64)
_SMEM_LIMIT = 232448 - 2048
# the on-chip instance: clusters of at most 8 blocks (the portable size), a
# warp lane's 20 columns in registers (n <= 640), 256 threads a block
_MAX_CLUSTER, _MAX_ONCHIP_N, _ONCHIP_MIN_N = 8, 640, 256


def fast_loop_smem_bytes(n: int, m: int, itemsize: int) -> int:
    """Dynamic shared memory of one K11 block at (n, m) (``smem_bytes`` in
    ``csrc/fast_loop.cu``): 8n + 2 + m words of the working type (x, u and
    the stepped u, n+, z, r, G n_l, the scaled update vector, C x) and
    m + 3n int32 (status, aorder and a removal's aorder), in 16 bytes."""
    raw = (8 * n + 2 + m) * itemsize + (m + 3 * n) * 4
    return (raw + 15) // 16 * 16


def fast_loop_plan(n: int, m: int, dtype=torch.float32) -> dict:
    """The K11 instance that (n, m, dtype) launches, as ``csrc/fast_loop.cu``
    sizes it: ``{"instance", "cluster", "smem_bytes"}``, the dynamic shared
    bytes of one block. f32 from n = 256 on (the 256-thread instance) runs
    on chip, in the smallest cluster whose blocks hold the streamed
    instance's vectors, the bounds and the next pass's z and r (2m + 4n
    words, in 16 bytes) and a band of ceil(n / c) rows of H within a block's
    shared memory (``onchip_smem_bytes``); everything else, and a width no
    cluster of 8 holds, is streamed."""
    if dtype == torch.float32 and _ONCHIP_MIN_N <= n <= _MAX_ONCHIP_N:
        base = fast_loop_smem_bytes(n, m, 4) + (8 * m + 16 * n + 15) // 16 * 16
        for c in range(2, _MAX_CLUSTER + 1):
            smem = base + -(-n // c) * n * 4
            if smem <= _SMEM_LIMIT:
                return {"instance": "onchip", "cluster": c,
                        "smem_bytes": smem}
    itemsize = torch.empty((), dtype=dtype).element_size()
    return {"instance": "streamed", "cluster": 1,
            "smem_bytes": fast_loop_smem_bytes(n, m, itemsize)}


def _require_fits(n: int, m: int, itemsize: int) -> None:
    """Raise if a K11 block at (n, m) needs more shared memory than a
    block may have."""
    smem = fast_loop_smem_bytes(n, m, itemsize)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fast_loop: n={n}, m={m} needs {smem} B of shared "
                         f"memory, more than a block's {_SMEM_LIMIT}")


def fast_loop_config(n: int, m: int, dtype=torch.float32,
                     instance: str = "streamed") -> dict:
    """The launch configuration of a K11 instance at (n, m) on the current
    card: of the streamed one, threads, shared bytes, resident blocks per
    SM, registers and spilled bytes per thread; of the on-chip one
    (``instance="onchip"``, f32, in the cluster :func:`fast_loop_plan`
    gives), threads, shared bytes a block, the cluster size, the clusters
    resident at once (``cudaOccupancyMaxActiveClusters``), registers and
    spilled bytes."""
    lib = _build.library()
    if instance == "onchip":
        out = (ctypes.c_int * 6)()
        _build.check(lib.jrlqp_fast_loop_onchip_config(
            n, m, fast_loop_plan(n, m, dtype)["cluster"], out),
            "jrlqp_fast_loop_onchip_config")
        return dict(zip(("threads", "smem_bytes", "cluster",
                         "active_clusters", "registers", "local_bytes"), out))
    out = (ctypes.c_int * 5)()
    _build.check(lib.jrlqp_fast_loop_config(
        n, m, int(dtype == torch.float64), out), "jrlqp_fast_loop_config")
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm", "registers",
                     "local_bytes"), out))


@functools.lru_cache(maxsize=None)
def _require_clusters(n: int, m: int, device: torch.device) -> None:
    """Raise if no cluster of the on-chip instance at (n, m) can be resident
    on the card ``device``."""
    with torch.cuda.device(device):
        cfg = fast_loop_config(n, m, torch.float32, "onchip")
    if cfg["active_clusters"] == 0:
        raise ValueError(f"fast_loop: no cluster of {cfg['cluster']} blocks "
                         f"with {cfg['smem_bytes']} B of shared memory each "
                         f"can be resident (n={n}, m={m})")


def fast_loop(pb: QPProblem, state: FastState, opt: SolverOptions,
              dep_eps: float) -> FastState:
    """Run the explicit-form GI loop from the CUDA state ``state`` until no
    lane is RUNNING: one launch of K11, counted as ``launch.K11``, of the
    instance :func:`fast_loop_plan` chooses (the on-chip one also counted as
    ``launch.K11.onchip``). ``dep_eps`` is the engine's relative threshold
    for a dependent candidate in the state's dtype."""
    B, n = state.x.shape
    m = state.status.shape[1] - n
    dt = state.x.dtype
    if dt not in _ENTRIES:
        raise TypeError(f"fast_loop: no kernel for {dt}")
    plan = fast_loop_plan(n, m, dt)
    onchip = plan["instance"] == "onchip"
    out = (_launch(_ONCHIP_ENTRY, pb, state, opt, dep_eps, plan["cluster"])
           if onchip else _launch(_ENTRIES[dt], pb, state, opt, dep_eps))
    if B:
        spans.count("launch.K11")
        if onchip:
            spans.count("launch.K11.onchip")
    return out


def _launch(entry: str, pb: QPProblem, state: FastState, opt: SolverOptions,
            dep_eps: float, cluster: int | None = None) -> FastState:
    """One launch of the K11 instance behind the C entry point ``entry``
    (the streamed ``jrlqp_fast_loop_f32`` / ``_f64``, or the on-chip
    ``jrlqp_fast_loop_onchip_f32`` in clusters of ``cluster``) on copies of
    ``state`` (none for an empty batch); counts nothing."""
    B, n = state.x.shape
    m = state.status.shape[1] - n
    dt, dev = state.x.dtype, state.x.device
    prob = (pb.G, pb.C, pb.l, pb.u, pb.xl, pb.xu)
    for name, t in zip(("G", "C", "l", "u", "xl", "xu"), prob):
        if t.device != dev or t.dtype != dt or t.shape[0] != B:
            raise ValueError(f"fast_loop: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dt} with batch {B} on {dev}")
    if pb.C.shape[1:] != (m, n) or pb.G.shape[1:] != (n, n):
        raise ValueError(f"fast_loop: G is {tuple(pb.G.shape)} and C "
                         f"{tuple(pb.C.shape)}, the state has n={n}, m={m}")
    if cluster is None:
        _require_fits(n, m, state.x.element_size())
    else:
        _require_clusters(n, m, dev)
    if B == 0:
        return state
    i32 = torch.int32
    ins = tuple(t.contiguous() for t in prob) + (
        state.hscale.to(dt).contiguous(),)
    x, f, H, Ns, u = (_build.own(t, dt) for t in (state.x, state.f, state.H,
                                                  state.Ns, state.u))
    status, aorder = (_build.own(state.status, i32),
                      _build.own(state.aorder, i32))
    scal = torch.stack([t.to(i32) for t in (
        state.q, state.it, state.term, state.skip1, state.sc_idx,
        state.sc_status)], dim=1)
    outs = (x, f, H, Ns, status, aorder, u, scal)
    lib = _build.library()
    # the runtime launches on the current device and sets the kernel's
    # shared-memory limit there: make it the tensors' card
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(
            *[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs],
            B, n, m, *(() if cluster is None else (cluster,)),
            int(opt.max_iter), float(opt.big_bnd),
            float(opt.zero_z_threshold), float(dep_eps), stream)
    _build.check(code, entry)
    q, it, term, skip1, sc_idx, sc_status = scal.t().contiguous()
    return FastState(x=x, f=f, H=H, Ns=Ns, status=status, aorder=aorder, u=u,
                     q=q, it=it, term=term, skip1=skip1.bool(),
                     sc_idx=sc_idx, sc_status=sc_status, hscale=state.hscale)


def _adds_removes(it, q0, q_end):
    """(adds, removals, mean active count) per lane: each iteration adds a
    constraint (q + 1) or removes one (q - 1)."""
    it, q0, q_end = (v.double() for v in (it, q0, q_end))
    dq = q_end - q0
    return (it + dq) / 2, (it - dq) / 2, ((q0 + q_end) / 2)


def fast_loop_flops(it, q0, q_end, n: int, m: int) -> float:
    """FLOPs of K11's iterations at (n, m), summed over the lanes; ``it``,
    ``q0`` and ``q_end`` are (B,) tensors of each lane's iterations and its
    active count at the start and at the end, which give its adds and
    removals exactly. Each is counted at the lane's mean active count q,
    with a general row's normal: every iteration forms z = H n+ (2n^2) and
    r = N* n+ over the q active rows (2qn); an add also the selection C x
    that chose its candidate (2mn) and the updates of H (2n^2) and of the
    q rows of N* (2qn); a removal v = G n_l (2n^2), w = N* v (2qn) and the
    same two updates. Exact where every candidate is a general row (the
    headline and IK sets have no variable bounds); a bound's z and r are a
    column read, so the count is above the kernel's on bound candidates."""
    adds, removes, q = _adds_removes(it, q0, q_end)
    per_add = 2 * m * n + 4 * n * n + 4 * q * n
    per_remove = 6 * n * n + 6 * q * n
    return float((adds * per_add + removes * per_remove).sum())


def fast_loop_bytes(batch: int, n: int, m: int, itemsize: int) -> int:
    """Bytes K11 must move at (n, m): the problem (G, C, l, u, xl, xu) and
    hscale read once, and the state (x, f, H, N*, u in the working type;
    status, aorder and six scalars in int32) read once and written once."""
    problem = itemsize * (n * n + m * n + 2 * m + 2 * n + 1)
    state = itemsize * (2 * n * n + 2 * n + 2) + 4 * (m + 2 * n + 6)
    return batch * (problem + 2 * state)


def fast_loop_stream_bytes(it, q0, q_end, n: int, m: int,
                           itemsize: int) -> float:
    """Bytes this design streams from device memory, summed over the lanes,
    where H, N* and G stay in the lane's slab (n = 387 in f32: 599 KB each,
    beyond a block's shared memory). Every iteration reads H for z (n^2)
    and the q active rows of N* for r (qn); an add also reads C (mn) and
    reads and writes H (2n^2) and those rows (2qn); a removal reads G
    (n^2) and the rows for w (qn), and reads and writes H and the rows.
    Normals and counts as in :func:`fast_loop_flops`."""
    adds, removes, q = _adds_removes(it, q0, q_end)
    per_add = m * n + 3 * n * n + 3 * q * n
    per_remove = 4 * n * n + 4 * q * n
    return float(itemsize * (adds * per_add + removes * per_remove).sum())


def fast_loop_onchip_bytes(it, q0, q_end, n: int, m: int, itemsize: int,
                           cluster: int) -> float:
    """Bytes the on-chip design moves between its clusters and L2 or device
    memory, summed over the lanes (``it``, ``q0``, ``q_end`` as in
    :func:`fast_loop_flops`): a lane that steps reads its H once and writes
    it once (2n^2); every iteration reads the q active rows of N* for r
    (qn); an add also reads C for the selection (mn) and the candidate's
    row in each of the ``cluster`` blocks (cn) and reads and writes the
    rows of N* (2qn); a removal reads G (n^2), the row n_l in each block
    (cn) and the rows of N* for w (qn), and reads and writes them. The rest
    stays on chip."""
    adds, removes, q = _adds_removes(it, q0, q_end)
    per_add = m * n + cluster * n + 3 * q * n
    per_remove = n * n + cluster * n + 4 * q * n
    stepped = (it.double() > 0).double() * 2 * n * n
    return float(itemsize * (stepped + adds * per_add
                             + removes * per_remove).sum())
