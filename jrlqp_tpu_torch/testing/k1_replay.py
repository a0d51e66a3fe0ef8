"""K1's whole solve of one lane on the CPU, in K1's own order.

:func:`k1_order_solve` chains the order-exact pieces of K1
(``gi_fused_kernel`` in ``csrc/gi_kernel.cu``) from cold start to the
end of the f64 refinement:

- the host preparation of ``ops.cuda.gi_kernel.prepare``: f32, infinite
  bounds as +/-1e31, G identity-padded to np = round_up(n + 1, 8);
- the prologue: L and L^-1 of the padded G by
  ``order_exact.k2_order_exact`` (K2's own order), H0 = L^-T L^-1 with each
  entry summed k ascending from max(i, j), each product and sum rounded
  apart, x0 = -H0 a as one FMA chain per row, tr0 = trace(H0) over all np
  diagonal entries in order (the padding adds its ones), clamped at 1e-30,
  and the non-SPD rule (H0 = I and x0 = 0 where ``posdef_plain`` of L is
  false; the loop does not run);
- the equality and fixed replay: each constraint with l = u, then each
  bound with xl = xu, in ascending index order, added as the kernel adds
  it (its directions as one FMA chain per output, r masked to the slots
  below q, the four sums as the block's butterfly), with the dependence
  test, and OVERCONSTRAINED when more than n are equal;
- the loop: ``op_split.gi_iteration`` in ``K1Order`` on a state of np
  slots, until the kernel's stopping rule (a successful or infeasible
  selection, a term other than RUNNING, or ``max_iter``);
- the index remap of ``gi_kernel.postprocess`` (x, u, aorder and N* cut to
  n, the slots to n) and the port's f64 refinement ``fast._refine_batch``.

Nothing in the f32 part lets a library choose an order: every reduction is
a fixed loop, an FMA chain (``op_split._chain``, ``order_exact.fma32``) or
the butterfly of ``op_split._block_sum``; products and sums are numpy or
torch elementwise f32 operations, each rounded once. So the f32 state it
returns is the card's, bit for bit, on any host. The refinement is f64
torch on the CPU; its outcome (status, active set, and pass or fail at
the 1e-8 gate) is the card's wherever the residual is not within f64
rounding of the gate.

Imports torch and numpy only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda.block_llt import posdef_plain
from ..problems import problem_from_numpy
from ..solver import fast
from ..types import (
    EQUALITY,
    FIXED,
    INFEASIBLE,
    LINEAR_DEPENDENCY_DETECTED,
    MAX_ITER_REACHED,
    NON_POS_HESSIAN,
    OVERCONSTRAINED_PROBLEM,
    RUNNING,
    SUCCESS,
    SolverOptions,
)
from .kkt import kkt_residual
from .miss_census import ARRAYS, GATE
from .op_split import K1Order, _block_sum, _sub_mul, f32_data, gi_iteration
from .order_exact import k2_order_exact

__all__ = ["k1_order_solve", "STATE_KEYS"]

# the f32 state of gi_kernel.postprocess, as miss_census.trajectory keeps it
STATE_KEYS = ("x", "u", "H", "Ns", "status", "aorder", "q", "it", "term",
              "skip1", "sc_idx", "sc_status", "hscale")
_f32 = np.float32


def _round_up(v: int, k: int) -> int:
    return (v + k - 1) // k * k


def _prologue(d: dict, np_: int):
    """(H0 n x n, x0, tr0, posdef) as K1's prologue forms them on the
    identity-padded G."""
    n = d["G"].shape[0]
    G = np.eye(np_, dtype=_f32)
    G[:n, :n] = d["G"]
    L, X = k2_order_exact(torch.from_numpy(G)[None])
    posdef = bool(posdef_plain(L)[0])
    if not posdef:
        return (np.eye(n, dtype=_f32), np.zeros(n, _f32), _f32(np_),
                False)
    X = X[0].numpy()
    idx = np.arange(np_)
    first = np.maximum(idx[:, None], idx[None, :])
    H = np.zeros((np_, np_), _f32)
    for k in range(np_):
        H = np.where(first <= k, H + X[k, :, None] * X[k, None, :], H)
    a = np.zeros(np_, _f32)
    a[:n] = d["a"]
    x0 = -K1Order.dot(a, np.ascontiguousarray(H.T), "G^T")
    tr = _f32(0)
    for k in range(np_):
        tr = _f32(tr + H[k, k])
    return H[:n, :n].copy(), x0[:n].copy(), _f32(max(tr, _f32(1e-30))), True


def _replay_equalities(st: dict, d: dict, tr0) -> None:
    """The kernel's equality / fixed replay on the state ``st``, in place:
    ascending index, constraints then bounds, while the term is RUNNING."""
    m, n = d["C"].shape
    eq = np.concatenate([d["l"] == d["u"], d["xl"] == d["xu"]])
    order = np.flatnonzero(eq)
    dep_thr = _f32(_f32(2e-7) * tr0)
    ns = len(st["u"])
    for idx in order:
        if st["term"] != RUNNING:
            break
        is_bnd = idx >= m
        npl = (np.eye(n, dtype=_f32)[idx - m] if is_bnd
               else d["C"][idx].astype(_f32))
        K = np.concatenate([st["H"], st["Ns"].T], axis=1)
        zr = K1Order.dot(npl, K, "K")
        q = st["q"]
        z = zr[:n].copy()
        r = np.where(np.arange(ns) < q, zr[n:], _f32(0)).astype(_f32)
        zr = np.concatenate([z, r])
        zz, nz, nx, nn = (_block_sum(z * z), _block_sum(npl * z),
                          _block_sum(npl * st["x"]), _block_sum(npl * npl))
        bsel = d["xl"][idx - m] if is_bnd else d["l"][idx]
        nz_safe = nz if nz != 0 else _f32(1)
        t = _f32(_f32(bsel - nx) / nz_safe) if zz > 0 else _f32(0)
        dependent = bool(nz <= _f32(dep_thr * nn))
        dsafe = _f32(1) if dependent else nz
        u = _sub_mul(st["u"], t, r, False)
        if q < ns:
            u[q] = _f32(u[q] + t)
        st["u"] = u
        st["x"] = _sub_mul(st["x"], -t, z, False)
        vq = (zr / dsafe).astype(_f32)
        K = _sub_mul(K, z[:, None], vq[None, :], False)
        if q < ns:
            K[:, n + q] = vq[:n]
        st["H"] = np.ascontiguousarray(K[:, :n])
        st["Ns"] = np.ascontiguousarray(K[:, n:].T)
        st["status"][idx] = FIXED if is_bnd else EQUALITY
        if q < ns:
            st["aorder"][q] = idx
        if dependent:
            st["term"] = LINEAR_DEPENDENCY_DETECTED
        st["q"] = q + 1
    if len(order) > n and st["term"] == RUNNING:
        st["term"] = OVERCONSTRAINED_PROBLEM


def _library_state(st: dict, n: int) -> dict:
    """The remap of ``gi_kernel.postprocess``: slots cut to n, RUNNING
    reported as MAX_ITER_REACHED."""
    term = MAX_ITER_REACHED if st["term"] == RUNNING else st["term"]
    return {"x": np.asarray(st["x"], _f32).copy(),
            "u": np.asarray(st["u"][:n], _f32).copy(),
            "H": np.asarray(st["H"], _f32).copy(),
            "Ns": np.asarray(st["Ns"][:n], _f32).copy(),
            "status": np.asarray(st["status"], np.int8).copy(),
            "aorder": np.asarray(st["aorder"][:n], np.int32).copy(),
            "q": st["q"], "it": st["it"], "term": term,
            "skip1": st["skip1"], "sc_idx": st["sc_idx"],
            "sc_status": st["sc_status"], "hscale": _f32(st["hscale"])}


def _refined(arrays: dict, f32: dict, ir_steps: int) -> dict:
    """The port's f64 refinement of the f32 state on the CPU, and its
    outcome: status, iterations, KKT residual, pass or fail, active set, x
    (``miss_census.outcomes``' keys)."""
    pb = problem_from_numpy(**{k: np.asarray(arrays[k], np.float64)[None]
                               for k in ARRAYS}, device="cpu")
    t = {k: torch.from_numpy(np.asarray(f32[k])[None].copy())
         for k in ("x", "u", "H", "Ns", "status", "aorder")}
    ints = {k: torch.tensor([int(f32[k])], dtype=torch.int32)
            for k in ("q", "it", "term", "skip1", "sc_idx", "sc_status")}
    st = fast._state_from_kernel_out(
        dict(t, status=t["status"].to(torch.int32), **ints,
             hscale=torch.tensor([float(f32["hscale"])])), 1)
    res = fast._refine_batch(pb, fast._validated(
        pb.with_dtype(torch.float32), st, SolverOptions()), ir_steps)
    kkt = float(kkt_residual(res.x, res.multipliers, pb)[0])
    status = int(res.status[0])
    return {"status": status, "iterations": int(res.iterations[0]),
            "kkt": kkt, "passed": bool(status == SUCCESS and kkt <= GATE),
            "active_set": res.active_set[0].numpy().astype(np.int8),
            "x": res.x[0].numpy()}


def k1_order_solve(arrays: dict, max_iter: int, ir_steps: int,
                   caps=()) -> dict:
    """K1's solve of one lane (``arrays``: f64 G, a, C, l, u, xl, xu of
    one problem) on the CPU in K1's own order, then the f64 refinement.

    Returns ``raw``, the f32 state that ``gi_kernel.run_loop_fused(pb32,
    max_iter)`` gives for the lane after ``postprocess`` (the keys of
    :data:`STATE_KEYS`), ``outcome``, the refined result's status,
    iterations, KKT residual, pass or fail, active set and x, and
    ``states``, the f32 state at each iteration cap of ``caps`` (the state
    K1 returns when launched with that ``max_iter``; no cap may exceed
    ``max_iter``)."""
    caps = sorted(set(int(c) for c in caps))
    if caps and caps[-1] > max_iter:
        raise ValueError(f"cap {caps[-1]} is beyond max_iter {max_iter}")
    d = f32_data(arrays)
    m, n = d["C"].shape
    np_ = _round_up(n + 1, 8)
    H0, x0, tr0, posdef = _prologue(d, np_)
    st = {"x": x0, "u": np.zeros(np_, _f32), "H": H0,
          "Ns": np.zeros((np_, n), _f32),
          "status": np.zeros(m + n, np.int64),
          "aorder": np.full(np_, -1, np.int64), "q": 0, "it": 0,
          "term": RUNNING if posdef else NON_POS_HESSIAN, "skip1": 0,
          "sc_idx": -1, "sc_status": 0, "hscale": tr0}
    _replay_equalities(st, d, tr0)
    st["sc_slot"] = st["q"]
    states = {}
    while True:
        for c in caps:
            if c not in states and (st["it"] >= c or st["term"] != RUNNING):
                states[c] = _library_state(st, n)
        if st["term"] != RUNNING or st["it"] >= max_iter:
            break
        it = gi_iteration(st, d, K1Order)
        st["sc_idx"], st["sc_status"] = it["sc_idx"], it["sc_status"]
        if it["stop"]:
            st["sc_slot"] = it["sc_slot"]
            st["term"] = SUCCESS if it["success"] else INFEASIBLE
            continue
        nxt = it["next"]
        nxt["it"] = st["it"] + 1
        st = nxt
    raw = _library_state(st, n)
    return {"raw": raw, "states": states,
            "outcome": _refined(arrays, raw, ir_steps)}
