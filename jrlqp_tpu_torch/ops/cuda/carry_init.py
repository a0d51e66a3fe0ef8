"""K12: the explicit-form engine's warm init from a carried operator as one
CUDA kernel, its wrapper, and its byte counts.

Counterpart of the JAX package's ``_init_fast_from_carry``
(``jrlqp_tpu/solver/fast.py:971-1009``) and the ``lax.while_loop`` of its
deactivations (``_deactivate_negative_u``, :851-895), which XLA compiles;
there is no Pallas kernel behind them. The structured trajectory's warm
step (``structured.solve_structured_fast_carry``) starts its loop from it.
The kernel, ``carry_init_kernel`` in ``csrc/carry_init.cu``, runs the whole
init with one thread block per lane: the carried slots compacted, the
closed form through the carried operators, and the deactivations of the
negative multipliers one at a time, each a rank-one removal and the closed
form on the reduced set, with no host read. Its plain version is
:func:`jrlqp_tpu_torch.solver.fast._init_fast_from_carry`, a round of
masked passes over the batch per deactivation.

:func:`carry_init` takes the plain version for a problem on the CPU and the
kernel for one on a card, which must be f32; it raises for another device
or dtype. The kernel's state is the plain version's lane for lane up to
the order of its sums: the same status, active slots, active count,
iterations and term, x, u, H and N* within rounding.
"""
from __future__ import annotations

import ctypes

import torch

from ...problems import QPProblem
from ...solver import fast
from ...solver.fast import FastState
from ...utils import spans
from . import _build

__all__ = ["carry_init", "carry_init_config", "carry_init_flops",
           "carry_init_bytes", "carry_init_stream_bytes"]


def carry_init(pb: QPProblem, H, Ns, status, aorder, q) -> FastState:
    """The warm init of the explicit-form engine from a previous solve's
    operators H and N*, status, aorder and q, for the batch ``pb`` that
    shares that solve's G and C: K12 on a card (f32), its plain version
    :func:`~jrlqp_tpu_torch.solver.fast._init_fast_from_carry` on the CPU.
    Counts ``launch.K12``."""
    dev = pb.G.device
    if dev.type == "cpu":
        return fast._init_fast_from_carry(pb, H, Ns, status, aorder, q)
    if dev.type != "cuda":
        raise RuntimeError(f"carry_init: no kernel for device {dev}")
    return _carry_init_cuda(pb, H, Ns, status, aorder, q)


def carry_init_config(n: int, m: int) -> dict:
    """Threads, shared bytes, rows of N* in shared memory, resident blocks
    per SM, registers and spilled bytes per thread of K12 at (n, m), on the
    current card."""
    out = (ctypes.c_int * 6)()
    lib = _build.library()
    _build.check(lib.jrlqp_carry_init_config(n, m, out),
                 "jrlqp_carry_init_config")
    return dict(zip(("threads", "smem_bytes", "smem_rows", "blocks_per_sm",
                     "registers", "local_bytes"), out))


def _carry_init_cuda(pb: QPProblem, H, Ns, status, aorder, q) -> FastState:
    B, n = pb.a.shape
    m = pb.m
    dev, f32, i32 = pb.G.device, torch.float32, torch.int32
    floats = {"G": (pb.G, (B, n, n)), "l": (pb.l, (B, m)),
              "u": (pb.u, (B, m)), "xl": (pb.xl, (B, n)),
              "xu": (pb.xu, (B, n)), "a": (pb.a, (B, n)),
              "H": (H, (B, n, n)), "Ns": (Ns, (B, n, n))}
    ints = {"status": (status, (B, m + n)), "aorder": (aorder, (B, n)),
            "q": (q, (B,))}
    for name, (t, shape) in {**floats, **ints}.items():
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"carry_init: {name} is {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {dev}")
    for name, (t, _) in floats.items():
        if t.dtype != f32:
            raise TypeError(f"carry_init: {name} is {t.dtype}, the kernel "
                            f"takes float32")
    ins = [t.contiguous() for t, _ in floats.values()]
    ins += [t.to(i32).contiguous() for t, _ in ints.values()]
    x = torch.empty((B, n), dtype=f32, device=dev)
    f = torch.empty((B,), dtype=f32, device=dev)
    H_out, Ns_out = torch.empty_like(ins[6]), torch.empty_like(ins[7])
    status_out = torch.empty((B, m + n), dtype=i32, device=dev)
    aorder_out = torch.empty((B, n), dtype=i32, device=dev)
    u = torch.empty((B, n + 1), dtype=f32, device=dev)
    scal = torch.empty((B, 6), dtype=i32, device=dev)
    hscale = torch.empty((B,), dtype=f32, device=dev)
    outs = (x, f, H_out, Ns_out, status_out, aorder_out, u, scal, hscale)
    lib = _build.library()
    # the runtime launches on the current device and sets the kernel's
    # shared-memory limit there: make it the tensors' card
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.jrlqp_carry_init(*[t.data_ptr() for t in ins],
                                    *[t.data_ptr() for t in outs], B, n, m,
                                    stream)
    _build.check(code, "carry_init")
    spans.count("launch.K12")
    q_, it, term, skip1, sc_idx, sc_status = scal.t().contiguous()
    return FastState(x=x, f=f, H=H_out, Ns=Ns_out, status=status_out,
                     aorder=aorder_out, u=u, q=q_, it=it, term=term,
                     skip1=skip1.bool(), sc_idx=sc_idx, sc_status=sc_status,
                     hscale=hscale)


def carry_init_flops(q, it, n: int) -> float:
    """FLOPs of K12 at width n, summed over the lanes; ``q`` and ``it`` are
    the (B,) tensors of the carried active counts and of the init's
    iterations (its deactivations). The closed form: H a and G x (2n^2
    each), N*^T b and N* (a + G x) over the q rows (2qn each); a
    deactivation: G n_l (2n^2), w = N* G n_l (2qn), the rank-one update of
    H with H a (4n^2), the update of the q rows of N* (2qn), then the
    closed form again with G nb and G x in one pass (4n^2 + 4qn), counted
    at the carried q."""
    q = q.double().clamp(0, n)
    it = it.double()
    return float((4 * n * n + 4 * q * n
                  + it * (10 * n * n + 8 * q * n)).sum())


def carry_init_bytes(q, n: int, m: int, itemsize: int = 4) -> float:
    """Bytes K12 must move at (n, m), summed over the lanes; ``q`` is the
    (B,) tensor of the carried active counts. Each input read once, each
    output written once: H read and the state's H written, G read, the q
    valid rows of N* read and the state's n rows written, and the
    vectors (a, the bounds, status and aorder in and out, x, u, the
    scalars)."""
    q = q.double().clamp(0, n)
    B = q.numel()
    per_lane = itemsize * (4 * n * n + 4 * n + 2 * m + (n + 1) + 2) \
        + 4 * (2 * (m + n) + 2 * n + 7)
    return float(B * per_lane + itemsize * n * q.sum())


def carry_init_stream_bytes(q, it, n: int, m: int,
                            itemsize: int = 4) -> float:
    """Bytes this design streams from device memory, summed over the
    lanes: :func:`carry_init_bytes`, and per deactivation (``it``, the
    (B,) tensor of the init's iterations) G read twice (G n_l, then G nb
    and G x in one pass) and H read and written once more."""
    return carry_init_bytes(q, n, m, itemsize) + float(
        itemsize * 4 * n * n * it.double().sum())
