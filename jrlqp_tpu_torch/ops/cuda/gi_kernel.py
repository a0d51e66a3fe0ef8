"""Fused GI whole-solve: host preparation, the CUDA kernel K1, its plain
PyTorch version, and the index remap.

Counterpart of the fused branch of ``jrlqp_tpu.ops.pallas.gi_kernel``:
``run_loop_pallas(..., fused_init=True)`` (gi_kernel.py:1031-1101),
``_run_fused`` (:1281), ``_kernel_packed_fused`` (:674) with its loop
``_packed_iterate`` (:364), and ``_postprocess`` (:1244).

Both versions take the same padded f32 inputs -- G identity-padded to
np = round_up(n+1, 8), C^T zero-padded to (np, mp) with mp = round_up(m,
8), infinite bounds as +/-1e31 -- and return the same raw state in the
Pallas kernel's index layout, so they compare elementwise. The TPU's pack
machinery is not carried over: the kernel runs one problem per thread
block, so there is no pack to pad or to balance, and the difficulty
presort (gi_kernel.py:1038-1052), which reorders problems across packs
without changing any lane's result, is left out.
"""
from __future__ import annotations

import torch

from ...types import (
    EQUALITY,
    FIXED,
    INFEASIBLE,
    LINEAR_DEPENDENCY_DETECTED,
    LOWER,
    LOWER_BOUND,
    MAX_ITER_REACHED,
    NON_POS_HESSIAN,
    OVERCONSTRAINED_PROBLEM,
    RUNNING,
    SUCCESS,
    UPPER,
    UPPER_BOUND,
)
from . import _build
from .block_llt import chol_b_plain, posdef_plain, tri_inv_b_plain

__all__ = ["run_loop_fused", "gi_fused_plain", "prepare", "postprocess"]

BIG = 1e30           # f32 infinity proxy inside the loop
INF_BOUND = 1e31     # infinite bounds in the padded f32 inputs
_SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper

# launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def prepare(pb32):
    """Padded f32 kernel inputs (G, Ct, l, u, xl, xu, a) and (n, m)."""
    B, n = pb32.a.shape
    m = pb32.C.shape[1]
    np_ = _round_up(n + 1, 8)
    mp_ = _round_up(max(m, 1), 8)
    f32, dev = torch.float32, pb32.G.device
    G = torch.zeros((B, np_, np_), dtype=f32, device=dev)
    G[:, :n, :n] = pb32.G
    k = torch.arange(n, np_, device=dev)
    G[:, k, k] = 1.0   # identity padding keeps the factor exact
    Ct = torch.zeros((B, np_, mp_), dtype=f32, device=dev)
    Ct[:, :n, :m] = pb32.C.transpose(1, 2)

    def padrow(v, c, fill):
        out = torch.full((B, c), fill, dtype=f32, device=dev)
        out[:, :v.shape[1]] = torch.nan_to_num(
            v.to(f32), posinf=INF_BOUND, neginf=-INF_BOUND)
        return out

    return ((G, Ct, padrow(pb32.l, mp_, -INF_BOUND),
             padrow(pb32.u, mp_, INF_BOUND), padrow(pb32.xl, np_, -INF_BOUND),
             padrow(pb32.xu, np_, INF_BOUND), padrow(pb32.a, np_, 0.0)),
            (n, m))


def postprocess(raw, n: int, m: int) -> dict:
    """Remap the kernel's padded index layout to (m+n) space
    (``_postprocess``)."""
    x, u, status, aorder, scal, K, hscale = raw
    np_ = x.shape[1]
    mp_ = status.shape[1] - np_
    status_full = torch.cat([status[:, :m], status[:, mp_:mp_ + n]], dim=1)
    ao = aorder[:, :n]
    ao_back = torch.where(ao >= mp_, ao - mp_ + m, ao)
    ao_back = torch.where(ao < 0, -1, ao_back)
    sc_raw = scal[:, 4]
    return dict(
        x=x[:, :n],
        u=u[:, :n],
        status=status_full,
        aorder=ao_back,
        q=scal[:, 0],
        it=scal[:, 1],
        term=scal[:, 2],
        skip1=scal[:, 3],
        sc_idx=torch.where(sc_raw >= mp_, sc_raw - mp_ + m, sc_raw),
        sc_status=scal[:, 5],
        H=K[:, :n, :n],
        Ns=K[:, :, np_:].transpose(1, 2)[:, :n, :n],
        hscale=hscale,
    )


def _rowmin(vals, iot):
    """Per-row (min, argmin) with ties to the lowest index."""
    mn = vals.amin(dim=1, keepdim=True)
    big = torch.iinfo(iot.dtype).max
    idx = torch.where(vals == mn, iot, big).amin(dim=1, keepdim=True)
    return mn, torch.where(idx == big, 0, idx)


def _col(A, idx):
    """A[b, :, idx[b]] for (B, r, c) A and (B, 1) idx -> (B, r)."""
    return A.gather(2, idx[:, :, None].expand(-1, A.shape[1], 1))[:, :, 0]


def _vecmat(v, A):
    return (v[:, None, :] @ A)[:, 0]


def _gi_fused_plain_raw(G, Ct, lo, up, xlo, xup, a, n, m, max_iter):
    """The fused kernel's computation as batched masked tensor code, line
    for line after ``_kernel_packed_fused`` and ``_packed_iterate`` with
    the whole batch as one pack: stopped lanes freeze through selects."""
    B, np_, _ = G.shape
    mp_ = Ct.shape[2]
    mtp_ = mp_ + np_
    # indices and codes are int64 here (torch.gather's index type) and
    # int32 in the outputs, as the kernel writes them
    dev, f32, i32 = G.device, torch.float32, torch.int64

    def ints(v):
        return torch.full((B, 1), v, dtype=i32, device=dev)

    # ---- prologue: H0 = G^-1 through the block helpers (K2) ----
    L = chol_b_plain(G)
    Li = tri_inv_b_plain(L)
    H0 = Li.transpose(1, 2) @ Li
    eye = torch.eye(np_, dtype=f32, device=dev)
    posdef = posdef_plain(L)[:, None]                              # (B, 1)
    H0 = torch.where(posdef[:, :, None], H0, eye)
    tr0 = torch.clamp_min(torch.diagonal(H0, dim1=1, dim2=2)
                          .sum(dim=1, keepdim=True), 1e-30)        # (B, 1)
    x0 = -(H0 @ a[:, :, None])[:, :, 0]
    x0 = torch.where(posdef, x0, 0.0)
    K = torch.cat([H0, torch.zeros_like(H0)], dim=2)

    iot_n = torch.arange(np_, device=dev, dtype=i32)[None, :]
    iot_m = torch.arange(mp_, device=dev, dtype=i32)[None, :]
    iot_mt = torch.arange(mtp_, device=dev, dtype=i32)[None, :]
    lane2 = torch.arange(2 * np_, device=dev, dtype=i32)[None, None, :]
    real_n = iot_n < n
    real_m = iot_m < m
    dep_thr = 2e-7 * tr0

    # ---- equality / fixed auto-activation, ascending index order ----
    rem = torch.cat([(lo == up) & real_m, (xlo == xup) & real_n], dim=1)
    over = rem.sum(dim=1, keepdim=True) > n
    term = torch.where(posdef, ints(RUNNING), ints(NON_POS_HESSIAN))
    x = x0
    u = torch.zeros((B, np_), dtype=f32, device=dev)
    status = torch.zeros((B, mtp_), dtype=i32, device=dev)
    aorder = torch.full((B, np_), -1, dtype=i32, device=dev)
    statk = torch.zeros((B, np_), dtype=i32, device=dev)
    q = ints(0)
    while True:
        act = (term == RUNNING) & rem.any(dim=1, keepdim=True)
        if not bool(act.any()):
            break
        _, idx = _rowmin(torch.where(rem, iot_mt, mtp_), iot_mt)
        is_bnd = idx >= mp_
        st = torch.where(is_bnd, FIXED, EQUALITY).to(i32)
        cidx = idx.clamp(0, mp_ - 1)
        crow = _col(Ct, cidx)
        e = (iot_n == idx - mp_).to(f32)
        nplus = torch.where(is_bnd, e, crow)
        zr = _vecmat(nplus, K)
        z, r = zr[:, :np_], zr[:, np_:]
        b_gen = lo.gather(1, cidx)
        b_bnd = xlo.gather(1, (idx - mp_).clamp(0, np_ - 1))
        b = torch.where(is_bnd, b_bnd, b_gen)
        nz = (nplus * z).sum(dim=1, keepdim=True)
        nn = (nplus * nplus).sum(dim=1, keepdim=True)
        nz_safe = torch.where(nz != 0, nz, 1.0)
        nx = (nplus * x).sum(dim=1, keepdim=True)
        zz = (z * z).sum(dim=1, keepdim=True)
        t = torch.where(zz > 0, (b - nx) / nz_safe, 0.0)
        t = torch.where(act, t, 0.0)
        r_head = torch.where(iot_n < q, r, 0.0)
        u2 = u - t * r_head
        u2 = torch.where(iot_n == q, u2 + t, u2)
        x2 = x + t * z
        dependent = nz <= dep_thr * nn
        dsafe = torch.where(dependent, 1.0, nz)
        zn = z / dsafe
        u_upd = torch.where(act, z, 0.0)
        K2 = K - u_upd[:, :, None] * (torch.cat([z, r_head], dim=1)
                                      / dsafe)[:, None, :]
        K = torch.where(act[:, :, None] & (lane2 == (np_ + q)[:, :, None]),
                        zn[:, :, None], K2)
        status = torch.where(act & (iot_mt == idx), st, status)
        aorder = torch.where(act & (iot_n == q), idx, aorder)
        statk = torch.where(act & (iot_n == q), st, statk)
        term = torch.where(act & dependent, LINEAR_DEPENDENCY_DETECTED, term)
        q = torch.where(act, q + 1, q)
        rem = rem & ~(act & (iot_mt == idx))
        x, u = x2, u2
    term = torch.where(over & (term == RUNNING), OVERCONSTRAINED_PROBLEM,
                       term)

    # ---- the GI loop (_packed_iterate) ----
    nplus = torch.zeros((B, np_), dtype=f32, device=dev)
    it, skip1, sc_idx, sc_st, sc_slot = ints(0), ints(0), ints(-1), ints(0), q
    zs = 1e-6 * tr0 * (1.0 / n)
    while True:
        active = (term == RUNNING) & (it < max_iter)
        if not bool(active.any()):
            break
        valid = statk != 0

        cx = _vecmat(x, Ct)
        sl, su = cx - lo, up - cx
        cand_c = torch.where((status[:, :mp_] != 0) | ~real_m, BIG,
                             torch.minimum(sl, su))
        st_c = torch.where(sl <= su, LOWER, UPPER)
        slb, sub = x - xlo, xup - x
        cand_b = torch.where((status[:, mp_:] != 0) | ~real_n, BIG,
                             torch.minimum(slb, sub))
        st_b = torch.where(slb <= sub, LOWER_BOUND, UPPER_BOUND)
        cand = torch.cat([cand_c, cand_b], dim=1)
        sts = torch.cat([st_c, st_b], dim=1).to(i32)
        viol, p = _rowmin(cand, iot_mt)
        sel_st = sts.gather(1, p)
        do_select = skip1 == 0
        success = do_select & (viol >= 0)
        sc_idx_n = torch.where(do_select, p, sc_idx)
        sc_st_n = torch.where(do_select, sel_st, sc_st)
        _, free_f = _rowmin(torch.where(valid, np_, iot_n), iot_n)
        sc_slot_n = torch.where(do_select, free_f, sc_slot)
        upper = (sc_st_n == UPPER) | (sc_st_n == UPPER_BOUND)
        sign = torch.where(upper, -1.0, 1.0)
        is_bnd = sc_st_n >= LOWER_BOUND
        crow = _col(Ct, sc_idx_n.clamp(0, mp_ - 1))
        e = (iot_n == sc_idx_n - mp_).to(f32)
        nplus_n = torch.where(do_select, sign * torch.where(is_bnd, e, crow),
                              nplus)

        zr = _vecmat(nplus_n, K)
        z, r = zr[:, :np_], zr[:, np_:]

        eligible = (valid & (statk != EQUALITY) & (statk != FIXED)
                    & (r > 0))
        r_safe = torch.where(eligible, r, 1.0)
        tks = torch.where(eligible, u / r_safe, BIG)
        t1_raw, lpos = _rowmin(tks, iot_n)
        t1 = torch.clamp_max(t1_raw, BIG)

        znorm2 = (z * z).sum(dim=1, keepdim=True)
        nz = (nplus_n * z).sum(dim=1, keepdim=True)
        nx = (nplus_n * x).sum(dim=1, keepdim=True)
        cidx = sc_idx_n.clamp(0, mp_ - 1)
        bidx = (sc_idx_n - mp_).clamp(0, np_ - 1)
        b_gen = torch.where(sc_st_n == UPPER, up, lo).gather(1, cidx)
        b_bnd = torch.where(sc_st_n == UPPER_BOUND, xup, xlo).gather(1, bidx)
        b = torch.where(is_bnd, b_bnd, b_gen)
        nz_safe = torch.where(nz != 0, nz, 1.0)
        nn = (nplus_n * nplus_n).sum(dim=1, keepdim=True)
        t2 = torch.where(znorm2 > zs * zs * nn, (sign * b - nx) / nz_safe,
                         BIG)
        t = torch.minimum(t1, t2)

        infeasible = (t >= BIG) & ~success
        dual_step = (t2 >= BIG) & ~infeasible
        full_step = ~infeasible & ~dual_step & (t2 <= t1)
        t_safe = torch.where(infeasible | success, 0.0, t)

        r_head = torch.where(valid, r, 0.0)
        u_stepped = u - t_safe * r_head
        u_stepped = torch.where(iot_n == sc_slot_n, u_stepped + t_safe,
                                u_stepped)
        x_new = torch.where(~dual_step, x + t_safe * z, x)

        stop = success | infeasible
        adv = active & ~stop
        add_sel = adv & full_step
        rem_sel = adv & ~full_step

        dependent = nz <= dep_thr * nn
        dsafe = torch.where(dependent, 1.0, nz)
        zn = z / dsafe
        term_add = torch.where(dependent, LINEAR_DEPENDENCY_DETECTED, term)

        nl = _col(K, np_ + lpos)
        v = (G @ nl[:, :, None])[:, :, 0]
        w = _vecmat(v, K)[:, np_:]
        wl = w.gather(1, lpos)
        wl_safe = torch.where(wl.abs() > 0, wl, 1.0)
        wmask = torch.where(valid & (iot_n != lpos), w, 0.0)

        # one rank-one update K -= u_upd v_upd^T for both add and remove
        u_upd = torch.where(add_sel, z, nl)
        v_upd = torch.where(add_sel, torch.cat([z, r_head], dim=1) / dsafe,
                            torch.cat([-nl, wmask], dim=1) / wl_safe)
        u_upd = torch.where(adv, u_upd, 0.0)
        K_n = K - u_upd[:, :, None] * v_upd[:, None, :]
        K_n = torch.where(
            add_sel[:, :, None] & (lane2 == (np_ + sc_slot_n)[:, :, None]),
            zn[:, :, None], K_n)
        K_n = torch.where(
            rem_sel[:, :, None] & (lane2 == (np_ + lpos)[:, :, None]),
            0.0, K_n)

        status_add = torch.where(iot_mt == sc_idx_n, sc_st_n, status)
        aorder_add = torch.where(iot_n == sc_slot_n, sc_idx_n, aorder)
        statk_add = torch.where(iot_n == sc_slot_n, sc_st_n, statk)
        rem_idx = aorder.gather(1, lpos).clamp(0, mtp_ - 1)
        status_rem = torch.where(iot_mt == rem_idx, 0, status)
        aorder_rem = torch.where(iot_n == lpos, -1, aorder)
        statk_rem = torch.where(iot_n == lpos, 0, statk)
        # the pending candidate's multiplier moves into the freed slot
        # (needed when it sat in a padded slot at a full-rank vertex)
        cand_val = u_stepped.gather(1, sc_slot_n)
        u_rem = torch.where(iot_n == lpos, cand_val,
                            torch.where(iot_n == sc_slot_n, 0.0, u_stepped))

        def sel2(a_, b_, c_):
            return torch.where(add_sel, a_, torch.where(rem_sel, b_, c_))

        x = torch.where(adv, x_new, x)
        u = sel2(u_stepped, u_rem, u)
        status = sel2(status_add, status_rem, status)
        aorder = sel2(aorder_add, aorder_rem, aorder)
        statk = sel2(statk_add, statk_rem, statk)
        K = K_n
        nplus = torch.where(active, nplus_n, nplus)
        q = torch.where(add_sel, q + 1, torch.where(rem_sel, q - 1, q))
        it = torch.where(adv, it + 1, it)
        term = torch.where(
            active & stop, torch.where(success, SUCCESS, INFEASIBLE),
            torch.where(add_sel, term_add, term)).to(i32)
        skip1 = torch.where(adv, torch.where(full_step, 0, 1), skip1)
        sc_idx = torch.where(active, sc_idx_n, sc_idx)
        sc_st = torch.where(active, sc_st_n, sc_st)
        sc_slot = torch.where(active, torch.where(rem_sel, lpos, sc_slot_n),
                              sc_slot)
    term = torch.where(term == RUNNING, MAX_ITER_REACHED, term)
    scal = torch.cat([q, it, term, skip1, sc_idx, sc_st, sc_slot, ints(0)],
                     dim=1)
    return (x, u, status.to(torch.int32), aorder.to(torch.int32),
            scal.to(torch.int32), K, tr0[:, 0])


def _gi_fused_cuda_raw(G, Ct, lo, up, xlo, xup, a, n, m, max_iter):
    global launches
    B, np_, _ = G.shape
    mp_ = Ct.shape[2]
    lib = _build.library()
    smem = lib.jrlqp_gi_fused_smem_bytes(np_, mp_)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"gi_fused: n={n}, m={m} needs {smem} B of shared "
                         f"memory, more than a block's {_SMEM_LIMIT}")
    dev, f32, i32 = G.device, torch.float32, torch.int32
    x = torch.empty((B, np_), dtype=f32, device=dev)
    u = torch.empty((B, np_), dtype=f32, device=dev)
    status = torch.empty((B, mp_ + np_), dtype=i32, device=dev)
    aorder = torch.empty((B, np_), dtype=i32, device=dev)
    scal = torch.empty((B, 8), dtype=i32, device=dev)
    K = torch.empty((B, np_, 2 * np_), dtype=f32, device=dev)
    hscale = torch.empty((B,), dtype=f32, device=dev)
    ins = [t.contiguous() for t in (G, Ct, lo, up, xlo, xup, a)]
    outs = (x, u, status, aorder, scal, K, hscale)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.jrlqp_gi_fused(*[t.data_ptr() for t in ins],
                              *[t.data_ptr() for t in outs],
                              B, n, m, np_, mp_, int(max_iter), stream)
    _build.check(code, "gi_fused")
    launches += 1
    return outs


def _check_input(pb32):
    if pb32.G.dtype != torch.float32:
        raise TypeError(f"fused GI wants a float32 problem, got {pb32.G.dtype}")


def gi_fused_plain(pb32, max_iter: int) -> dict:
    """The plain PyTorch version of K1 on any device, remapped to (m+n)."""
    _check_input(pb32)
    inputs, (n, m) = prepare(pb32)
    return postprocess(_gi_fused_plain_raw(*inputs, n, m, max_iter), n, m)


def run_loop_fused(pb32, max_iter: int) -> dict:
    """Fused-init GI solve of a batch of f32 problems.

    Returns the dict of ``_postprocess``: x, u, status, aorder in (m+n)
    space, and q, it, term, skip1, sc_idx, sc_status, H, Ns, hscale. A
    CUDA problem runs the kernel K1; a CPU problem runs the plain version.
    Any other device raises."""
    _check_input(pb32)
    dev = pb32.G.device
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"run_loop_fused: no kernel for device {dev}")
    inputs, (n, m) = prepare(pb32)
    run = _gi_fused_cuda_raw if dev.type == "cuda" else _gi_fused_plain_raw
    return postprocess(run(*inputs, n, m, max_iter), n, m)
