"""The GI kernels K1, K3, K4 and K9: host preparation, the CUDA kernels,
their plain PyTorch versions, and the index remap.

Counterpart of ``jrlqp_tpu.ops.pallas.gi_kernel``, whose three packed
kernels share the loop ``_packed_iterate`` (:364):

- K1, the fused whole solve: ``run_loop_pallas(..., fused_init=True)``
  (gi_kernel.py:1031-1101), ``_run_fused`` (:1281),
  ``_kernel_packed_fused`` (:674);
- K3, the loop from a given state: the packed branch of
  ``run_loop_pallas`` (:1102-1209), ``_kernel_packed`` (:628);
- K4, the loop from a carried operator: ``run_warm_loop_pallas`` (:1339),
  ``_kernel_packed_warm`` (:836);
- K9, K3's loop with compact slots: the pack-1 branch of
  ``run_loop_pallas`` (:1210-1238), ``_kernel`` (:104);

and ``_postprocess`` (:1244).

Kernel and plain version take the same padded f32 inputs -- np =
round_up(n+1, 8) slots, C^T zero-padded to (np, mp) with mp = round_up(m,
8), infinite bounds as +/-1e31, G identity-padded for K1 and zero-padded
for K3 and K4 as on the TPU -- and return the same raw state in the Pallas
kernels' index layout, so they compare elementwise. The TPU's pack
machinery is not carried over: the kernels run one problem per thread
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
from ...utils import spans
from . import _build
from .block_llt import chol_b_plain, posdef_plain, tri_inv_b_plain

__all__ = ["run_loop_fused", "run_loop_fused_carry", "gi_fused_plain",
           "run_loop", "gi_loop_plain", "run_warm_loop", "warm_step",
           "gi_warm_plain", "run_loop_compact", "gi_compact_plain", "prepare",
           "prepare_state", "prepare_warm", "prepare_warm_carry",
           "postprocess", "residency"]

BIG = 1e30           # f32 infinity proxy inside the loop
INF_BOUND = 1e31     # infinite bounds in the padded f32 inputs
_SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper

_F, _I = torch.float32, torch.int32
# input dtypes of the C entry points, in argument order
_FUSED_IN = (_F,) * 7
_LOOP_IN = (_F,) * 9 + (_I,) * 4 + (_F,)
_WARM_IN = (_F,) * 8 + (_I,) * 4 + (_F,) + (_I,) * 3


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _padrow(v, c, fill):
    out = torch.full((v.shape[0], c), fill, dtype=_F, device=v.device)
    out[:, :v.shape[1]] = torch.nan_to_num(
        v.to(_F), posinf=INF_BOUND, neginf=-INF_BOUND)
    return out


def _pad2(A, r):
    out = torch.zeros((A.shape[0], r, r), dtype=_F, device=A.device)
    out[:, :A.shape[1], :A.shape[2]] = A
    return out


def _padded(pb32):
    """Zero-padded f32 (G, Ct, l, u, xl, xu, a) and (n, m)."""
    B, n = pb32.a.shape
    m = pb32.C.shape[1]
    np_ = _round_up(n + 1, 8)
    mp_ = _round_up(max(m, 1), 8)
    Ct = torch.zeros((B, np_, mp_), dtype=_F, device=pb32.G.device)
    Ct[:, :n, :m] = pb32.C.transpose(1, 2)
    return ((_pad2(pb32.G, np_), Ct, _padrow(pb32.l, mp_, -INF_BOUND),
             _padrow(pb32.u, mp_, INF_BOUND),
             _padrow(pb32.xl, np_, -INF_BOUND),
             _padrow(pb32.xu, np_, INF_BOUND), _padrow(pb32.a, np_, 0.0)),
            (n, m))


def _pad_status(status, n, m, mp_, np_):
    out = torch.zeros((status.shape[0], mp_ + np_), dtype=_I,
                      device=status.device)
    out[:, :m] = status[:, :m]
    out[:, mp_:mp_ + n] = status[:, m:]
    return out


def _pad_aorder(aorder, n, m, mp_, np_):
    ao = torch.where(aorder >= m, aorder - m + mp_, aorder)
    out = torch.full((aorder.shape[0], np_), -1, dtype=_I,
                     device=aorder.device)
    out[:, :n] = torch.where(aorder < 0, -1, ao)
    return out


def _operator(H, Ns, np_):
    """K = [H | N*^T], (B, np, 2np), zero-padded."""
    return torch.cat([_pad2(H, np_), _pad2(Ns, np_).transpose(1, 2)], dim=2)


def prepare(pb32):
    """K1's padded f32 inputs (G, Ct, l, u, xl, xu, a) and (n, m). G is
    identity-padded, which keeps the in-kernel factor exact."""
    inputs, (n, m) = _padded(pb32)
    G = inputs[0]
    k = torch.arange(n, G.shape[1], device=G.device)
    # indexing by a tensor on the card waits on it
    with spans.sync("pad"):
        G[:, k, k] = 1.0
    return inputs, (n, m)


def prepare_state(pb32, state0):
    """K3's inputs from a batched ``FastState`` (the packed branch of
    ``run_loop_pallas``, gi_kernel.py:1102-1147): the padded problem
    without a, then K0 = [H | N*^T], x0, u0, status and aorder in the
    padded index layout, the per-slot statuses statk, the scalars (q, it,
    term, skip1, sc_idx, sc_status, sc_slot, 0) and hscale. The state may
    hold slot holes (aorder == -1)."""
    (G, Ct, lo, up, xlo, xup, _), (n, m) = _padded(pb32)
    np_, mp_ = G.shape[1], Ct.shape[2]
    ao = state0.aorder.long()
    valid = ao >= 0
    statk0 = torch.zeros((G.shape[0], np_), dtype=_I, device=G.device)
    statk0[:, :n] = torch.where(
        valid, state0.status.long().gather(1, torch.where(valid, ao, 0)), 0)
    sc = state0.sc_idx.long()
    # the pending candidate's slot: the free slot that holds a nonzero
    # multiplier (a resumed state with skip1 = 1), else the first free one
    k = torch.arange(n, device=G.device)
    free = ~valid
    key = torch.where(free & (state0.u[:, :n] != 0), k,
                      torch.where(free, n + k, 2 * n + k))
    sc_slot0 = key.argmin(dim=1)
    scal0 = torch.stack(
        [state0.q.long(), state0.it.long(), state0.term.long(),
         state0.skip1.long(), torch.where(sc >= m, sc - m + mp_, sc),
         state0.sc_status.long(), sc_slot0, torch.zeros_like(sc_slot0)],
        dim=1).to(_I)
    return ((G, Ct, lo, up, xlo, xup, _operator(state0.H, state0.Ns, np_),
             _padrow(state0.x, np_, 0.0),
             _padrow(state0.u[:, :n + 1], np_, 0.0),
             _pad_status(state0.status, n, m, mp_, np_),
             _pad_aorder(ao, n, m, mp_, np_), statk0, scal0,
             state0.hscale.to(_F)),
            (n, m))


def prepare_warm(pb32, H, Ns, status, aorder, q):
    """K4's inputs from a carry of plain tensors in the library's index
    layout (``run_warm_loop_pallas``, gi_kernel.py:1366-1434): the padded
    problem with a, K0 = [H | N*^T], status and aorder in the padded index
    layout, and q. The per-slot statuses statk and the per-slot signed
    active bounds b_act, which the Pallas wrapper gathers on the host, are
    formed inside the kernel (and its plain version) from status, aorder
    and the NEW bounds: LOWER / EQUALITY -> l, UPPER -> -u, LOWER_BOUND /
    FIXED -> xl, UPPER_BOUND -> -xu, each clamped to +/-1e30, 0 on a free
    slot. No problem is flagged for reset (see :func:`prepare_warm_carry`)."""
    (G, Ct, lo, up, xlo, xup, a), (n, m) = _padded(pb32)
    np_, mp_ = G.shape[1], Ct.shape[2]
    state = (_operator(H, Ns, np_), _pad_status(status, n, m, mp_, np_),
             _pad_aorder(aorder.long(), n, m, mp_, np_), q.to(_I))
    return ((G, Ct, lo, up, xlo, xup, a, *state, torch.zeros_like(state[3]),
             *state), (n, m))


def prepare_warm_carry(pb, raw, q, reset, cold):
    """K4's inputs from a carry in the kernels' own layout: ``raw`` is
    (G, Ct, K, status, aorder) as :func:`warm_step` or
    :func:`run_loop_fused_carry` returned them -- the padded f32 G and C^T
    of the trajectory's first step, and the previous kernel's K = [H |
    N*^T], status and aorder outputs, untouched -- so only a and the four
    bound rows of the new problem ``pb`` (any float dtype) are padded
    here. The problems flagged in ``reset`` (B,) int32 start from ``cold``
    (K, status, aorder and q in the same layout) instead."""
    G, Ct, K, status, aorder = raw
    n, m = pb.a.shape[1], pb.C.shape[1]
    np_, mp_ = G.shape[1], Ct.shape[2]
    if (np_, mp_) != (_round_up(n + 1, 8), _round_up(max(m, 1), 8)):
        raise ValueError(f"carry of padded sizes {(np_, mp_)} does not fit "
                         f"a problem with n={n}, m={m}")
    return ((G, Ct, _padrow(pb.l, mp_, -INF_BOUND),
             _padrow(pb.u, mp_, INF_BOUND), _padrow(pb.xl, np_, -INF_BOUND),
             _padrow(pb.xu, np_, INF_BOUND), _padrow(pb.a, np_, 0.0), K,
             status, aorder, q.to(_I), reset, cold[0], cold[1], cold[2],
             cold[3].to(_I)),
            (n, m))


def postprocess(raw, n: int, m: int) -> dict:
    """Remap the kernels' padded index layout to (m+n) space
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


def _matvec(A, v):
    return (A @ v[:, :, None])[:, :, 0]


def _packed_iterate_plain(G, Ct, lo, up, xlo, xup, tr0, init, n, m,
                          max_iter, compact=False):
    """The GI loop (``_packed_iterate``) as batched masked tensor code, line
    for line, with the whole batch as one pack: stopped lanes freeze
    through selects. ``init`` is (x, K, u, status, aorder, statk, q, it,
    term, skip1, sc_idx, sc_status, sc_slot), the scalars (B, 1) int64;
    the same tuple comes back. A lane that enters with skip1 = 1 starts
    from its pending candidate's normal, rebuilt from (sc_idx, sc_status)
    as ``fast.fast_iteration`` does (fast.py:175-183), not from zero as
    ``_kernel_packed`` and ``_kernel`` do (gi_kernel.py:648-653, :336-339).

    With ``compact`` the slots are K9's (``_kernel``, gi_kernel.py:
    146-360): slots 0..q-1 are active and the candidate sits at slot q; a
    removal deletes slot l and shifts slots l+1..q-1 down by one (N*
    columns, aorder, statk, and u up to the candidate's slot q), where the
    hole layout frees slot l in place and moves the candidate's multiplier
    into it. ``sc_slot`` is then unused."""
    x, K, u, status, aorder, statk, q, it, term, skip1, sc_idx, sc_st, \
        sc_slot = init
    B, np_, _ = G.shape
    mp_ = Ct.shape[2]
    mtp_ = mp_ + np_
    # indices and codes are int64 here (torch.gather's index type)
    dev, f32, i64 = G.device, torch.float32, torch.int64
    iot_n = torch.arange(np_, device=dev, dtype=i64)[None, :]
    iot_m = torch.arange(mp_, device=dev, dtype=i64)[None, :]
    iot_mt = torch.arange(mtp_, device=dev, dtype=i64)[None, :]
    lane2 = torch.arange(2 * np_, device=dev, dtype=i64)[None, None, :]
    real_n = iot_n < n
    real_m = iot_m < m
    dep_thr = 2e-7 * tr0
    zs = 1e-6 * tr0 * (1.0 / n)

    def normal(idx, st):
        """sign * (e | C[idx]) of candidate (idx, st), and its parts."""
        sign = torch.where((st == UPPER) | (st == UPPER_BOUND), -1.0, 1.0)
        is_bnd = st >= LOWER_BOUND
        crow = _col(Ct, idx.clamp(0, mp_ - 1))
        e = (iot_n == idx - mp_).to(f32)
        return sign * torch.where(is_bnd, e, crow), sign, is_bnd

    nplus = torch.where(skip1 != 0, normal(sc_idx, sc_st)[0], 0.0)
    while True:
        active = (term == RUNNING) & (it < max_iter)
        if not bool(active.any()):
            break
        valid = (iot_n < q) if compact else (statk != 0)

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
        sts = torch.cat([st_c, st_b], dim=1).to(i64)
        viol, p = _rowmin(cand, iot_mt)
        sel_st = sts.gather(1, p)
        do_select = skip1 == 0
        success = do_select & (viol >= 0)
        sc_idx_n = torch.where(do_select, p, sc_idx)
        sc_st_n = torch.where(do_select, sel_st, sc_st)
        _, free_f = _rowmin(torch.where(valid, np_, iot_n), iot_n)
        sc_slot_n = q if compact else torch.where(do_select, free_f, sc_slot)
        nplus_sel, sign, is_bnd = normal(sc_idx_n, sc_st_n)
        nplus_n = torch.where(do_select, nplus_sel, nplus)

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
        v = _matvec(G, nl)
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
        status_add = torch.where(iot_mt == sc_idx_n, sc_st_n, status)
        aorder_add = torch.where(iot_n == sc_slot_n, sc_idx_n, aorder)
        statk_add = torch.where(iot_n == sc_slot_n, sc_st_n, statk)
        rem_idx = aorder.gather(1, lpos).clamp(0, mtp_ - 1)
        status_rem = torch.where(iot_mt == rem_idx, 0, status)
        if compact:
            # delete slot lpos: N* columns, aorder and statk from lpos+1
            # up to q-1 move down one, everything from q-1 on is cleared;
            # u (the candidate at slot q) moves down up to q
            col = lane2 - np_
            ql = (q - 1)[:, :, None]
            src = torch.where((col >= lpos[:, :, None]) & (col < ql),
                              lane2 + 1, lane2).clamp(max=2 * np_ - 1)
            K_rem = K_n.gather(2, src.expand(B, np_, 2 * np_))
            K_rem = torch.where(col >= ql, 0.0, K_rem)
            K_n = torch.where(rem_sel[:, :, None], K_rem, K_n)
            below = (iot_n >= lpos) & (iot_n < q - 1)
            src_v = torch.where(below, iot_n + 1, iot_n)
            aorder_rem = torch.where(iot_n >= q - 1, -1,
                                     aorder.gather(1, src_v))
            statk_rem = torch.where(iot_n >= q - 1, 0, statk.gather(1, src_v))
            src_u = torch.where((iot_n >= lpos) & (iot_n < q), iot_n + 1,
                                iot_n).clamp(max=np_ - 1)
            u_rem = torch.where(iot_n >= q, 0.0, u_stepped.gather(1, src_u))
        else:
            K_n = torch.where(
                rem_sel[:, :, None] & (lane2 == (np_ + lpos)[:, :, None]),
                0.0, K_n)
            aorder_rem = torch.where(iot_n == lpos, -1, aorder)
            statk_rem = torch.where(iot_n == lpos, 0, statk)
            # the pending candidate's multiplier moves into the freed slot
            # (needed when it sat in a padded slot at a full-rank vertex)
            cand_val = u_stepped.gather(1, sc_slot_n)
            u_rem = torch.where(iot_n == lpos, cand_val,
                                torch.where(iot_n == sc_slot_n, 0.0,
                                            u_stepped))

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
            torch.where(add_sel, term_add, term))
        skip1 = torch.where(adv, torch.where(full_step, 0, 1), skip1)
        sc_idx = torch.where(active, sc_idx_n, sc_idx)
        sc_st = torch.where(active, sc_st_n, sc_st)
        sc_slot = torch.where(active, torch.where(rem_sel, lpos, sc_slot_n),
                              sc_slot)
    return (x, K, u, status, aorder, statk, q, it, term, skip1, sc_idx,
            sc_st, sc_slot)


def _raw_out(state, hscale):
    """The kernels' seven outputs from the loop's final state."""
    x, K, u, status, aorder, _, q, it, term, skip1, sc_idx, sc_st, \
        sc_slot = state
    term = torch.where(term == RUNNING, MAX_ITER_REACHED, term)
    scal = torch.cat([q, it, term, skip1, sc_idx, sc_st, sc_slot,
                      torch.zeros_like(q)], dim=1)
    return (x, u, status.to(_I), aorder.to(_I), scal.to(_I), K, hscale)


def _gi_fused_plain_raw(G, Ct, lo, up, xlo, xup, a, n, m, max_iter):
    """K1's computation as batched masked tensor code, line for line after
    ``_kernel_packed_fused`` and ``_packed_iterate``."""
    B, np_, _ = G.shape
    mp_ = Ct.shape[2]
    mtp_ = mp_ + np_
    dev, f32, i64 = G.device, torch.float32, torch.int64

    def ints(v):
        return torch.full((B, 1), v, dtype=i64, device=dev)

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

    iot_n = torch.arange(np_, device=dev, dtype=i64)[None, :]
    iot_m = torch.arange(mp_, device=dev, dtype=i64)[None, :]
    iot_mt = torch.arange(mtp_, device=dev, dtype=i64)[None, :]
    lane2 = torch.arange(2 * np_, device=dev, dtype=i64)[None, None, :]
    real_n = iot_n < n
    real_m = iot_m < m
    dep_thr = 2e-7 * tr0

    # ---- equality / fixed auto-activation, ascending index order ----
    rem = torch.cat([(lo == up) & real_m, (xlo == xup) & real_n], dim=1)
    over = rem.sum(dim=1, keepdim=True) > n
    term = torch.where(posdef, ints(RUNNING), ints(NON_POS_HESSIAN))
    x = x0
    u = torch.zeros((B, np_), dtype=f32, device=dev)
    status = torch.zeros((B, mtp_), dtype=i64, device=dev)
    aorder = torch.full((B, np_), -1, dtype=i64, device=dev)
    statk = torch.zeros((B, np_), dtype=i64, device=dev)
    q = ints(0)
    while True:
        act = (term == RUNNING) & rem.any(dim=1, keepdim=True)
        if not bool(act.any()):
            break
        _, idx = _rowmin(torch.where(rem, iot_mt, mtp_), iot_mt)
        is_bnd = idx >= mp_
        st = torch.where(is_bnd, FIXED, EQUALITY).to(i64)
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

    init = (x, K, u, status, aorder, statk, q, ints(0), term, ints(0),
            ints(-1), ints(0), q)
    return _raw_out(_packed_iterate_plain(G, Ct, lo, up, xlo, xup, tr0,
                                          init, n, m, max_iter), tr0[:, 0])


def _gi_loop_plain_raw(G, Ct, lo, up, xlo, xup, K0, x0, u0, status0,
                       aorder0, statk0, scal0, hscale0, n, m, max_iter,
                       compact=False):
    """K3's computation: ``_kernel_packed`` on the state passed in; with
    ``compact``, K9's: ``_kernel``, whose scalar slot 6 comes back 0."""
    s = scal0.long()
    scalars = [s[:, j:j + 1] for j in range(7)]   # q, it, ..., sc_slot
    tr0 = torch.clamp_min(hscale0[:, None], 1e-30)
    init = (x0, K0, u0, status0.long(), aorder0.long(), statk0.long(),
            *scalars)
    final = _packed_iterate_plain(G, Ct, lo, up, xlo, xup, tr0, init, n, m,
                                  max_iter, compact)
    if compact:
        final = (*final[:-1], torch.zeros_like(final[-1]))
    return _raw_out(final, hscale0)


def _gi_compact_plain_raw(*args):
    """K9's computation: ``_kernel`` on the state passed in."""
    return _gi_loop_plain_raw(*args, compact=True)


def _warm_slots(lo, up, xlo, xup, status, aorder):
    """K4's per-slot statuses statk and signed active bounds b_act, as the
    kernel forms them from the padded bound rows and the carried status and
    aorder (int64, padded index layout): slot k holds constraint or bound
    aorder[k] at status[aorder[k]]; LOWER / EQUALITY -> l, UPPER -> -u,
    LOWER_BOUND / FIXED -> xl, UPPER_BOUND -> -xu, clamped to +/-1e30; a
    free slot (aorder -1) has status 0 and bound 0."""
    held = aorder >= 0
    slot_idx = torch.where(held, aorder, 0)
    statk = torch.where(held, status.gather(1, slot_idx), 0)
    lo_all = torch.cat([lo, xlo], dim=1).clamp(-1e30, 1e30)
    up_all = torch.cat([up, xup], dim=1).clamp(-1e30, 1e30)
    upperish = (statk == UPPER) | (statk == UPPER_BOUND)
    b = torch.where(held, torch.where(upperish, -up_all.gather(1, slot_idx),
                                      lo_all.gather(1, slot_idx)), 0.0)
    return statk, b


def _gi_warm_plain_raw(G, Ct, lo, up, xlo, xup, a, K0, status0, aorder0,
                       q0, reset, Kr, statusr, aorderr, qr, n, m, max_iter):
    """K4's computation: the per-slot statuses and signed active bounds
    from status, aorder and the new bounds (see :func:`prepare_warm`), then
    ``_kernel_packed_warm``'s prologue (tr0 from the carried H, the closed
    form, the deactivations) and the loop. K0 may carry K1's identity on
    the padded diagonal of H: the trace runs over the n real entries, and
    nothing else reads the padding. The carry holds n slots, as the
    library's does: a padded slot that the last kernel left occupied (a
    lane that ended LINEAR_DEPENDENCY_DETECTED at q > n) comes in free, its
    N* column zero, its constraint inactive and no longer counted in q.
    Every slot whose multiplier is negative is deactivated: the Pallas
    kernel's u < -1e-5 keeps those in [-1e-5, 0), which the f64 refinement
    then gives the wrong sign (see ``gi_warm_kernel``). A problem flagged
    in ``reset`` starts from (Kr, statusr, aorderr, qr)."""
    put = reset != 0
    K0 = torch.where(put[:, None, None], Kr, K0)
    status0 = torch.where(put[:, None], statusr, status0)
    aorder0 = torch.where(put[:, None], aorderr, aorder0)
    q0 = torch.where(put, qr, q0)
    B, np_, _ = G.shape
    mtp_ = Ct.shape[2] + np_
    dev, i64 = G.device, torch.int64
    iot_n = torch.arange(np_, device=dev, dtype=i64)[None, :]
    iot_mt = torch.arange(mtp_, device=dev, dtype=i64)[None, :]
    lane2 = torch.arange(2 * np_, device=dev, dtype=i64)[None, None, :]
    K = torch.where(lane2 >= np_ + n, 0.0, K0)
    padded = (iot_n >= n) & (aorder0.long() >= 0)
    dropped = torch.zeros((B, mtp_), dtype=i64, device=dev).scatter_add_(
        1, torch.where(padded, aorder0.long(), 0), padded.long())
    status = torch.where(dropped > 0, 0, status0.long())
    aorder = torch.where(iot_n < n, aorder0.long(), -1)
    statk, b = _warm_slots(lo, up, xlo, xup, status, aorder)
    q = q0.long()[:, None] - padded.sum(dim=1, keepdim=True)
    diag = torch.diagonal(K[:, :, :np_], dim1=1, dim2=2)
    tr0 = torch.clamp_min(torch.where(iot_n < n, diag, 0.0)
                          .sum(dim=1, keepdim=True), 1e-30)

    def closed_form(K, b, statk):
        # x = N*^T b_act - H a = K [-a; b_act],  u = (K^T (a + G x))[np:]
        x = _matvec(K, torch.cat([-a, b], dim=1))
        u = _vecmat(a + _matvec(G, x), K)[:, np_:]
        return x, torch.where(statk != 0, u, 0.0)

    x, u = closed_form(K, b, statk)
    it = torch.zeros((B, 1), dtype=i64, device=dev)
    while True:
        elig = (statk != 0) & (statk != EQUALITY) & (statk != FIXED)
        mn, lpos = _rowmin(torch.where(elig, u, 0.0), iot_n)
        act = mn < 0.0
        if not bool(act.any()):
            break
        nl = _col(K, np_ + lpos)
        w = _vecmat(_matvec(G, nl), K)[:, np_:]
        wl = w.gather(1, lpos)
        wl_safe = torch.where(wl.abs() > 0, wl, 1.0)
        wmask = torch.where((statk != 0) & (iot_n != lpos), w, 0.0)
        K = K - (torch.where(act, nl, 0.0)[:, :, None]
                 * (torch.cat([-nl, wmask], dim=1) / wl_safe)[:, None, :])
        K = torch.where(act[:, :, None] & (lane2 == (np_ + lpos)[:, :, None]),
                        0.0, K)
        at_l = act & (iot_n == lpos)
        rem_idx = aorder.gather(1, lpos).clamp(0, mtp_ - 1)
        status = torch.where(act & (iot_mt == rem_idx), 0, status)
        aorder = torch.where(at_l, -1, aorder)
        statk = torch.where(at_l, 0, statk)
        b = torch.where(at_l, 0.0, b)
        q = torch.where(act, q - 1, q)
        x2, u2 = closed_form(K, b, statk)
        x = torch.where(act, x2, x)
        u = torch.where(act, u2, u)
        it = torch.where(act, it + 1, it)

    init = (x, K, u, status, aorder, statk, q, it,
            torch.full_like(q, RUNNING), torch.zeros_like(q),
            torch.full_like(q, -1), torch.zeros_like(q), q)
    return _raw_out(_packed_iterate_plain(G, Ct, lo, up, xlo, xup, tr0,
                                          init, n, m, max_iter), tr0[:, 0])


# the GI kernels' numbers in jrlqp_gi_blocks_per_sm
_KERNEL_IDS = {"jrlqp_gi_fused": 0, "jrlqp_gi_loop": 1, "jrlqp_gi_warm": 2,
               "jrlqp_gi_compact": 3}


def residency(entry: str, n: int, m: int) -> tuple[int, int]:
    """(threads per block, resident blocks per SM) of the GI kernel behind
    the C entry point ``entry`` at (n, m), on the current card."""
    lib = _build.library()
    blocks = lib.jrlqp_gi_blocks_per_sm(_KERNEL_IDS[entry],
                                        _round_up(n + 1, 8),
                                        _round_up(max(m, 1), 8))
    if blocks < 0:
        _build.check(-blocks, entry)
    return lib.jrlqp_gi_threads(), blocks


def _launch(entry, dtypes, ins, n, m, max_iter):
    """Run the C entry point ``entry`` on the padded inputs ``ins`` (G and
    C^T first) and return the seven raw outputs. Every kernel copies its
    inputs with 16-byte cp.async and float4 loads, so each must start
    16-byte aligned, as every fresh tensor of the caching allocator does;
    one that does not raises."""
    G, Ct = ins[0], ins[1]
    B, np_, _ = G.shape
    mp_ = Ct.shape[2]
    dev = G.device
    for i, (t, dt) in enumerate(zip(ins, dtypes, strict=True)):
        if t.device != dev or t.dtype != dt or t.shape[0] != B:
            raise ValueError(f"{entry}: input {i} is {t.dtype} {tuple(t.shape)}"
                             f" on {t.device}, expected {dt} with batch {B} "
                             f"on {dev}")
    lib = _build.library()
    smem = lib.jrlqp_gi_smem_bytes(np_, mp_)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{entry}: n={n}, m={m} needs {smem} B of shared "
                         f"memory, more than a block's {_SMEM_LIMIT}")
    outs = (torch.empty((B, np_), dtype=_F, device=dev),
            torch.empty((B, np_), dtype=_F, device=dev),
            torch.empty((B, mp_ + np_), dtype=_I, device=dev),
            torch.empty((B, np_), dtype=_I, device=dev),
            torch.empty((B, 8), dtype=_I, device=dev),
            torch.empty((B, np_, 2 * np_), dtype=_F, device=dev),
            torch.empty((B,), dtype=_F, device=dev))
    ins = [t.contiguous() for t in ins]
    for i, t in enumerate(ins):
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{entry}: input {i} does not start 16-byte "
                             f"aligned")
    # the runtime launches on the current device and sets the kernel's
    # shared-memory limit there: make it the tensors' card
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(*[t.data_ptr() for t in ins],
                                   *[t.data_ptr() for t in outs],
                                   B, n, m, np_, mp_, int(max_iter), stream)
    _build.check(code, entry)
    return outs


def _gi_fused_cuda_raw(*args):
    *ins, n, m, max_iter = args
    outs = _launch("jrlqp_gi_fused", _FUSED_IN, ins, n, m, max_iter)
    spans.count("launch.K1")
    return outs


def _gi_loop_cuda_raw(*args):
    *ins, n, m, max_iter = args
    outs = _launch("jrlqp_gi_loop", _LOOP_IN, ins, n, m, max_iter)
    spans.count("launch.K3")
    return outs


def _gi_compact_cuda_raw(*args):
    *ins, n, m, max_iter = args
    outs = _launch("jrlqp_gi_compact", _LOOP_IN, ins, n, m, max_iter)
    spans.count("launch.K9")
    return outs


def _gi_warm_cuda_raw(*args):
    *ins, n, m, max_iter = args
    outs = _launch("jrlqp_gi_warm", _WARM_IN, ins, n, m, max_iter)
    spans.count("launch.K4")
    return outs


def _on_cuda(pb32, name: str) -> bool:
    """True for a CUDA problem, False for a CPU one; raises otherwise."""
    if pb32.G.dtype != torch.float32:
        raise TypeError(f"{name} wants a float32 problem, got {pb32.G.dtype}")
    dev = pb32.G.device
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    return dev.type == "cuda"


def gi_fused_plain(pb32, max_iter: int) -> dict:
    """The plain PyTorch version of K1 on any device, remapped to (m+n)."""
    _on_cuda(pb32, "gi_fused_plain")
    inputs, (n, m) = prepare(pb32)
    return postprocess(_gi_fused_plain_raw(*inputs, n, m, max_iter), n, m)


def _carry_raw(inputs, outs):
    """The kernel-layout carry (G, Ct, K, status, aorder) that K4 reads:
    the padded G and C^T a step ran on and its K, status and aorder
    outputs."""
    return (inputs[0], inputs[1], outs[5], outs[2], outs[3])


def _run_remapped(run, inputs, n: int, m: int, max_iter: int
                  ) -> tuple[dict, tuple]:
    """``run`` (a kernel's launch or its plain version) on the padded
    ``inputs`` in a span ``jrlqp.loop``, then the remap in ``jrlqp.remap``:
    the dict of :func:`postprocess` and the kernel-layout carry."""
    with spans.span("jrlqp.loop", inputs[0]):
        outs = run(*inputs, n, m, max_iter)
    with spans.span("jrlqp.remap", inputs[0]):
        return postprocess(outs, n, m), _carry_raw(inputs, outs)


def run_loop_fused_carry(pb32, max_iter: int) -> tuple[dict, tuple]:
    """:func:`run_loop_fused`, and the kernel-layout carry for
    :func:`prepare_warm_carry`."""
    run = (_gi_fused_cuda_raw if _on_cuda(pb32, "run_loop_fused")
           else _gi_fused_plain_raw)
    with spans.span("jrlqp.prepare", pb32.G):
        inputs, (n, m) = prepare(pb32)
    return _run_remapped(run, inputs, n, m, max_iter)


def run_loop_fused(pb32, max_iter: int) -> dict:
    """Fused-init GI solve of a batch of f32 problems.

    Returns the dict of ``_postprocess``: x, u, status, aorder in (m+n)
    space, and q, it, term, skip1, sc_idx, sc_status, H, Ns, hscale. A
    CUDA problem runs the kernel K1; a CPU problem runs the plain version.
    Any other device raises."""
    return run_loop_fused_carry(pb32, max_iter)[0]


def gi_loop_plain(pb32, state0, max_iter: int) -> dict:
    """The plain PyTorch version of K3 on any device, remapped to (m+n)."""
    _on_cuda(pb32, "gi_loop_plain")
    inputs, (n, m) = prepare_state(pb32, state0)
    return postprocess(_gi_loop_plain_raw(*inputs, n, m, max_iter), n, m)


def run_loop(pb32, state0, max_iter: int) -> dict:
    """The GI loop from a batched ``FastState`` ``state0`` (counterpart of
    ``run_loop_pallas(pb32, state0, max_iter)``): the dict of
    :func:`run_loop_fused`. A CUDA problem runs the kernel K3; a CPU
    problem runs the plain version. Any other device raises."""
    run = (_gi_loop_cuda_raw if _on_cuda(pb32, "run_loop")
           else _gi_loop_plain_raw)
    with spans.span("jrlqp.prepare", pb32.G):
        inputs, (n, m) = prepare_state(pb32, state0)
    return _run_remapped(run, inputs, n, m, max_iter)[0]


def gi_warm_plain(pb32, H, Ns, status, aorder, q, max_iter: int) -> dict:
    """The plain PyTorch version of K4 on any device, remapped to (m+n)."""
    _on_cuda(pb32, "gi_warm_plain")
    inputs, (n, m) = prepare_warm(pb32, H, Ns, status, aorder, q)
    return postprocess(_gi_warm_plain_raw(*inputs, n, m, max_iter), n, m)


def warm_step(inputs, n: int, m: int, max_iter: int) -> tuple[dict, tuple]:
    """K4 on the inputs of :func:`prepare_warm` or
    :func:`prepare_warm_carry`: the dict of :func:`run_loop_fused`, and the
    kernel-layout carry for the next step's :func:`prepare_warm_carry`.
    CUDA inputs run the kernel K4; CPU inputs run the plain version. Any
    other device raises."""
    dev = inputs[0].device
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"warm_step: no kernel for device {dev}")
    run = _gi_warm_cuda_raw if dev.type == "cuda" else _gi_warm_plain_raw
    return _run_remapped(run, inputs, n, m, max_iter)


def run_warm_loop(pb32, H, Ns, status, aorder, q, max_iter: int) -> dict:
    """The warm-carry solve (counterpart of ``run_warm_loop_pallas``): the
    previous solve's H, N*, status, aorder and q (library index layout,
    holes allowed) with the new problem ``pb32``, which must share its G
    and C. Returns the dict of :func:`run_loop_fused`. A CUDA problem runs
    the kernel K4; a CPU problem runs the plain version. Any other device
    raises."""
    _on_cuda(pb32, "run_warm_loop")
    inputs, (n, m) = prepare_warm(pb32, H, Ns, status, aorder, q)
    return warm_step(inputs, n, m, max_iter)[0]


def gi_compact_plain(pb32, state0, max_iter: int) -> dict:
    """The plain PyTorch version of K9 on any device, remapped to (m+n)."""
    _on_cuda(pb32, "gi_compact_plain")
    inputs, (n, m) = prepare_state(pb32, state0)
    return postprocess(_gi_compact_plain_raw(*inputs, n, m, max_iter), n, m)


def run_loop_compact(pb32, state0, max_iter: int) -> dict:
    """The GI loop with compact slots from a batched ``FastState``
    ``state0`` with compact slots, such as ``_init_fast``'s (counterpart of
    ``run_loop_pallas(pb32, state0, max_iter, pack=1)``): the dict of
    :func:`run_loop_fused`. A CUDA problem runs the kernel K9; a CPU
    problem runs the plain version. Any other device raises."""
    run = (_gi_compact_cuda_raw if _on_cuda(pb32, "run_loop_compact")
           else _gi_compact_plain_raw)
    with spans.span("jrlqp.prepare", pb32.G):
        inputs, (n, m) = prepare_state(pb32, state0)
    return _run_remapped(run, inputs, n, m, max_iter)[0]
