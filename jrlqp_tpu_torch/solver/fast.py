"""Throughput GI engine: the fused f32 kernel plus f64 iterative refinement.

Counterpart of :mod:`jrlqp_tpu.solver.fast` on its main path,
``solve_refined_pallas(..., fused_init=True)``: the f32 active-set loop runs
in the fused kernel (:mod:`jrlqp_tpu_torch.ops.cuda.gi_kernel`), producing
the explicit operators H = G^-1 (I - N N*) and N*; a few steps of
mixed-precision refinement on the final active set then take the KKT
residual to <= 1e-8:

    r1 = N lam - G x - a,  r2 = b - N^T x           (f64)
    dx = H r1 + N*^T r2,   dlam = N* (G N*^T r2 - r1)  (f32 operators)

The refinement is the native-f64 branch of ``_refine_batch``
(fast.py:397-548): the GPU has f64, so the double-single emulation and the
one-hot gathers of the TPU branch become plain f64 products,
``torch.gather`` and ``scatter_add``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.cuda.gi_kernel import run_loop_fused
from ..problems import QPProblem
from ..types import (
    INCONSISTENT_INPUT,
    LOWER_BOUND,
    UPPER,
    UPPER_BOUND,
    SolverOptions,
)
from ..validation import inconsistent_mask
from .state import GIResult

__all__ = ["FastState", "solve_refined_kernel"]


@dataclasses.dataclass(frozen=True)
class FastState:
    """Batched final state of the f32 loop (``jrlqp_tpu.solver.fast.
    FastState`` with a leading batch dimension)."""

    x: torch.Tensor        # (B, n)
    f: torch.Tensor        # (B,)
    H: torch.Tensor        # (B, n, n) reduced inverse Hessian
    Ns: torch.Tensor       # (B, n, n) row k = N* row of active slot k
    status: torch.Tensor   # (B, m+n) int32
    aorder: torch.Tensor   # (B, n) int32, -1 marks a free slot
    u: torch.Tensor        # (B, n+1) multipliers by slot
    q: torch.Tensor        # (B,) int32
    it: torch.Tensor       # (B,) int32
    term: torch.Tensor     # (B,) int32
    skip1: torch.Tensor    # (B,) bool
    sc_idx: torch.Tensor   # (B,) int32
    sc_status: torch.Tensor  # (B,) int32
    hscale: torch.Tensor   # (B,) trace(G^-1) at init


def _state_from_kernel_out(out: dict, B: int) -> FastState:
    """Batched FastState from the fused kernel's output dict (fast.py:752)."""
    u = out["u"]
    return FastState(
        x=out["x"],
        f=torch.zeros((B,), dtype=torch.float32, device=u.device),
        H=out["H"],
        Ns=out["Ns"],
        status=out["status"],
        aorder=out["aorder"],
        u=torch.cat([u, torch.zeros_like(u[:, :1])], dim=1),
        q=out["q"],
        it=out["it"],
        term=out["term"],
        skip1=out["skip1"].bool(),
        sc_idx=out["sc_idx"],
        sc_status=out["sc_status"],
        hscale=out["hscale"],
    )


def _bmv(A, v):
    return torch.einsum("bij,bj->bi", A, v)


def _bmtv(A, v):
    """A^T v per lane."""
    return torch.einsum("bji,bj->bi", A, v)


def _refine_batch(pbs: QPProblem, st: FastState, ir_steps: int) -> GIResult:
    """Batched mixed-precision iterative refinement in native f64.

    Slot validity is ``aorder >= 0``: the fused kernel frees a slot by
    zeroing it, so active slots may have holes."""
    B, n = pbs.a.shape
    m = pbs.C.shape[1]
    f64, f32 = torch.float64, torch.float32
    valid = st.aorder >= 0                                   # (B, n)
    idxs = torch.where(valid, st.aorder, 0).long()           # (B, n)
    stat = torch.where(valid, st.status.long().gather(1, idxs), 0)
    upperish = (stat == UPPER) | (stat == UPPER_BOUND)
    sgn64 = torch.where(upperish, -1.0, 1.0).to(f64) * valid
    is_b = stat >= LOWER_BOUND

    # per-slot signed bounds: general rows use l/u, bound rows xl/xu
    def clamp(v):
        return torch.nan_to_num(v, posinf=1e30, neginf=-1e30).clamp(-1e30,
                                                                     1e30)

    lo_all = clamp(torch.cat([pbs.l, pbs.xl], dim=1).to(f64))
    up_all = clamp(torch.cat([pbs.u, pbs.xu], dim=1).to(f64))
    b_sel = torch.where(upperish, up_all.gather(1, idxs),
                        lo_all.gather(1, idxs))
    b = sgn64 * b_sel * valid                                # (B, n) signed

    # signed active normals in f32, slot-major: N^T[k] = sgn_k (e | C[idx])
    G32, C32 = pbs.G.to(f32), pbs.C.to(f32)
    sgn32 = sgn64.to(f32)
    cidx = idxs.clamp(0, max(m - 1, 0))
    bidx = (idxs - m).clamp(0, n - 1)
    if m > 0:
        Crows = C32.gather(1, cidx[:, :, None].expand(-1, -1, n))
    else:
        Crows = torch.zeros((B, n, n), dtype=f32, device=G32.device)
    e_b = torch.nn.functional.one_hot(bidx, n).to(f32)
    Nt32 = sgn32[:, :, None] * torch.where(is_b[:, :, None], e_b, Crows)

    a64 = pbs.a.to(f64)
    H32, Ns32 = st.H, st.Ns
    x32 = st.x
    lam32 = torch.where(valid, st.u[:, :n], 0.0).to(f32)
    x = x32.to(f64)
    lam = lam32.to(f64)

    # one-time f64 products y = G x, cx = C x, w = N lam = C^T mu_c + mu_b
    signed = sgn32 * lam32
    mu_c = torch.zeros((B, m + 1), dtype=f32, device=x.device).scatter_add(
        1, torch.where(is_b, m, cidx), signed)[:, :m]
    mu_b = torch.zeros((B, n + 1), dtype=f32, device=x.device).scatter_add(
        1, torch.where(is_b, bidx, n), signed)[:, :n]
    G64, C64 = pbs.G.to(f64), pbs.C.to(f64)
    y = _bmv(G64, x)
    cx = _bmv(C64, x)
    w = _bmtv(C64, mu_c.to(f64)) + mu_b.to(f64)
    ntx = sgn64 * torch.cat([cx, x], dim=1).gather(1, idxs)

    for _ in range(ir_steps):
        r1 = w - y - a64                                     # stationarity
        r2 = torch.where(valid, b - ntx, 0.0)                # active feas.
        r1_32, r2_32 = r1.to(f32), r2.to(f32)
        nstr2 = _bmtv(Ns32, r2_32)                           # N*^T r2
        dx = _bmv(H32, r1_32) + nstr2
        gv = _bmv(G32, nstr2)
        dlam = _bmv(Ns32, gv - r1_32)
        x = x + dx.to(f64)
        lam = torch.where(valid, lam + dlam.to(f64), 0.0)
        # track the f64 quantities with f32 increments (error << target)
        y = y + _bmv(G32, dx).to(f64)
        ntx = ntx + _bmv(Nt32, dx).to(f64)
        w = w + _bmtv(Nt32, dlam).to(f64)

    # multipliers in the external sign convention (UPPER-active positive)
    sign_out = torch.where(upperish, 1.0, -1.0).to(f64)
    vals = torch.where(valid, sign_out * lam, 0.0)
    multipliers = torch.zeros((B, m + n), dtype=f64,
                              device=x.device).scatter_add(1, idxs, vals)
    f = 0.5 * (x * y).sum(dim=1) + (a64 * x).sum(dim=1)
    return GIResult(x=x, multipliers=multipliers, f=f, iterations=st.it,
                    status=st.term, active_set=st.status)


def solve_refined_kernel(pbs: QPProblem, opt: SolverOptions = SolverOptions(),
                         ir_steps: int = 1) -> GIResult:
    """Batched f32 GI in the fused kernel, then ``ir_steps`` steps of f64
    refinement (counterpart of ``solve_refined_pallas(pbs, opt, ir_steps,
    fused_init=True)``).

    Runs on the problem's device: a CUDA batch goes through the CUDA
    kernel, a CPU batch through its plain PyTorch version. With
    ``opt.validate`` lanes with inconsistent data end INCONSISTENT_INPUT.
    """
    return _solve_refined(pbs, opt, ir_steps, run_loop_fused)


def _solve_refined(pbs: QPProblem, opt: SolverOptions, ir_steps: int,
                   run_loop) -> GIResult:
    """:func:`solve_refined_kernel` with the f32 loop ``run_loop(pb32,
    max_iter)`` given: the kernel's wrapper, or its plain version for a
    comparison on the card."""
    B = pbs.batch
    pb32 = pbs.with_dtype(torch.float32)
    out = run_loop(pb32, opt.max_iter)
    st = _state_from_kernel_out(out, B)
    if opt.validate:
        bad = inconsistent_mask(pb32)
        st = dataclasses.replace(st, term=torch.where(
            bad, INCONSISTENT_INPUT, st.term).to(torch.int32))
    return _refine_batch(pbs, st, ir_steps)
