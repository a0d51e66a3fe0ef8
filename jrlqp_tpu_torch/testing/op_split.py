"""Where the deciding quantity of an f32 GI parting gets its error.

One iteration of the f32 GI loop is five operations: the selection's slack
``c_p . x``, the directions ``[z | r] = n+ K``, the step lengths ``t1`` and
``t2``, the update ``x += t z`` and the rank-one update of ``K = [H |
N*^T]``. This module takes one side's own f32 state at an iteration cap
(x, H, N*, u, the active set and the scalars, in the library's index
space) and

- :func:`k1_iteration` replays the iteration in the order of the CUDA loop
  ``gi_loop`` (``csrc/gi_kernel.cu``): every dot product one FMA chain in k
  order, the block sums as the warp butterfly and the warps in order, each
  product of ``sub_mul`` and of the x update rounded apart; it returns each
  operation's f32 result and the next state, which a card's state at the
  next cap holds bit for bit;
- :func:`op_roundings` recomputes each operation in f64 on exactly that
  side's f32 inputs and gives each operation's own rounding in f32 ulps;
- :func:`slack_split` splits the error of the deciding slack at a parting
  (the side's f32 slack against the slack of the f64 minimizer of the same
  active set on the f32-rounded data) into the dot's own rounding, the x
  error inherited from the previous vertex, and what the steps since then
  added: the x updates' own rounding, the directions' own rounding, the
  step lengths' own rounding, and the state's error carried through them.
  The parts sum to the total.

The states come from the card (``miss_census --states``), from the port's
plain version on the CPU, or from the JAX package's kernel; the functions
here take numpy arrays and import torch only for :func:`fma32`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..types import (
    EQUALITY,
    FIXED,
    LINEAR_DEPENDENCY_DETECTED,
    LOWER,
    LOWER_BOUND,
    UPPER,
    UPPER_BOUND,
)
from .order_exact import fma32

__all__ = ["f32_data", "iterate64", "violations", "candidate_normal",
           "K1Order", "PlainOrder", "gi_iteration", "k1_iteration",
           "same_next", "op_roundings", "slack_gradient", "slack_split",
           "segment", "range_split", "states_at", "vertex_window",
           "split_at_parting"]

BIG = np.float32(1e30)
INF_BOUND = 1e31
THREADS = 128          # gi_loop's block: one thread per slot, 4 warps
_f32 = np.float32


def f32_data(arrays: dict) -> dict:
    """The lane's f64 arrays as the kernels take them: f32, infinite
    bounds as +/-1e31."""
    out = {}
    for k in ("G", "a", "C", "l", "u", "xl", "xu"):
        v = np.asarray(arrays[k], dtype=np.float64)
        if k in ("l", "u", "xl", "xu"):
            v = np.nan_to_num(v, posinf=INF_BOUND, neginf=-INF_BOUND)
        out[k] = v.astype(_f32)
    return out


def violations(d: dict, x) -> tuple[np.ndarray, np.ndarray]:
    """min(C x - l, u - C x) and min(x - xl, xu - x) per constraint in f64
    at ``x`` on the f32 data ``d``, and the scale |C x| or |x| beside."""
    x = np.asarray(x, dtype=np.float64)
    C = d["C"].astype(np.float64)
    cx = C @ x
    v = np.concatenate([np.minimum(cx - d["l"], d["u"] - cx),
                        np.minimum(x - d["xl"], d["xu"] - x)])
    return v, np.concatenate([np.abs(cx), np.abs(x)])


def candidate_normal(d: dict, i: int, s: int) -> tuple[np.ndarray, float]:
    """(signed normal, signed bound) of constraint ``i`` at status ``s`` in
    f64; an upper side is negated."""
    m, n = d["C"].shape
    upper = s in (UPPER, UPPER_BOUND)
    row = d["C"][i].astype(np.float64) if i < m else np.eye(n)[i - m]
    if i < m:
        b = d["u"][i] if upper else d["l"][i]
    else:
        b = d["xu"][i - m] if upper else d["xl"][i - m]
    sign = -1.0 if upper else 1.0
    return sign * row, sign * float(b)


def iterate64(d: dict, status) -> dict:
    """The f64 iterate of the active set ``status`` alone on the f32 data:
    H, N* (rows in ascending constraint order), x and u of its
    equality-constrained minimizer."""
    n = d["G"].shape[0]
    act = np.nonzero(np.asarray(status) != 0)[0]
    rows = [candidate_normal(d, i, int(status[i])) for i in act]
    N = np.array([r for r, _ in rows]).reshape(-1, n).T
    b = np.array([v for _, v in rows])
    G = d["G"].astype(np.float64)
    Gi = np.linalg.inv(G)
    if len(act):
        Ns = np.linalg.solve(N.T @ Gi @ N, N.T @ Gi)
        H = Gi - Gi @ N @ Ns
    else:
        Ns, H = np.zeros((0, n)), Gi
    x = -H @ d["a"].astype(np.float64) + Ns.T @ b
    return {"H": H, "Ns": Ns, "x": x, "active": act,
            "u": Ns @ (G @ x + d["a"])}


# ---- K1's order ----

# f64 bits below f32's last place: 1 then 28 zeros is halfway between two
# f32 (in f32's normal range)
_LOW29, _HALF29 = np.int64((1 << 29) - 1), np.int64(1 << 28)
_TINY = 2.0 ** -125


def _chain(vec: np.ndarray, A: np.ndarray) -> np.ndarray:
    """sum_k vec[k] A[k, :], one FMA chain per output in k ascending. Each
    step adds the exact f64 product to the f32 sum in f64 and rounds to
    f32, which is the FMA's own rounding unless the f64 sum lies exactly
    halfway between two f32 or below f32's normal range; those entries
    take :func:`fma32`."""
    vec = np.asarray(vec, _f32)
    A = np.asarray(A, _f32)
    A64 = A.astype(np.float64)
    acc = np.zeros(A.shape[1], _f32)
    for k in range(A.shape[0]):
        s = np.float64(vec[k]) * A64[k] + acc
        r = s.astype(_f32)
        odd = (((s.view(np.int64) & _LOW29) == _HALF29)
               | (np.abs(s) < _TINY))
        if odd.any():
            r[odd] = fma32(torch.full((int(odd.sum()),), float(vec[k])),
                           torch.from_numpy(A[k][odd]),
                           torch.from_numpy(acc[odd])).numpy()
        acc = r
    return acc


def _block_sum(vals: np.ndarray) -> np.float32:
    """block_reduce's sum of one value per thread (slot k on thread k):
    each warp's xor butterfly, then the warps in order."""
    v = np.zeros(THREADS, _f32)
    v[:len(vals)] = vals
    v = v.reshape(THREADS // 32, 32)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lane ^ o]
    out = v[0, 0]
    for w in range(1, v.shape[0]):
        out = _f32(out + v[w, 0])
    return out


class K1Order:
    """The CUDA loop's reductions and updates: ``dot(vec, A, which)`` is
    sum_k vec[k] A[k, :] (``which`` names A: "Ct", "K", "G^T" or "N*^T"),
    ``sum(a, b)`` sum_k a[k] b[k] as a block sum of one product per slot;
    ``fused`` says whether a - b c (the u, x and K updates) is one FMA
    (False: ``sub_mul`` and the x update round the product first)."""

    fused = False

    @staticmethod
    def dot(vec, A, which):
        return _chain(np.asarray(vec, _f32), np.asarray(A, _f32))

    @staticmethod
    def sum(a, b):
        return _block_sum(np.asarray(a, _f32) * np.asarray(b, _f32))


def _round_up(v: int, k: int) -> int:
    return (v + k - 1) // k * k


class PlainOrder:
    """The plain version's reductions (``ops.cuda.gi_kernel.
    _packed_iterate_plain`` on the CPU, batch 1): torch products on the
    padded operands, np = round_up(n + 1, 8) slots, mp = round_up(m, 8)
    rows, K = [H | N*^T] at (np, 2np); a sum over np entries; each product
    of an update rounded apart."""

    fused = False

    def __init__(self, n: int, m: int):
        self.n, self.m = n, m
        self.np, self.mp = _round_up(n + 1, 8), _round_up(max(m, 1), 8)

    def _pad(self, A, rows, cols):
        out = torch.zeros((1, rows, cols), dtype=torch.float32)
        out[0, :A.shape[0], :A.shape[1]] = torch.from_numpy(
            np.ascontiguousarray(A, _f32))
        return out

    def dot(self, vec, A, which):
        n, np_ = self.n, self.np
        v = torch.zeros((1, np_), dtype=torch.float32)
        v[0, :n] = torch.from_numpy(np.asarray(vec, _f32))
        if which == "G^T":         # v = _matvec(G, nl)
            G = self._pad(np.asarray(A).T, np_, np_)
            return (G @ v[:, :, None])[0, :n, 0].numpy()
        if which == "Ct":          # cx = _vecmat(x, Ct)
            M = self._pad(A, np_, self.mp)
            return (v[:, None, :] @ M)[0, 0, :self.m].numpy()
        # K = [H | N*^T] at (np, 2np): "K" takes both halves, "N*^T" the
        # right half of the same product (w = _vecmat(v, K)[:, np:])
        H, NsT = (A[:, :n], A[:, n:]) if which == "K" else (None, A)
        K = torch.zeros((1, np_, 2 * np_), dtype=torch.float32)
        if H is not None:
            K[0, :n, :n] = torch.from_numpy(np.ascontiguousarray(H, _f32))
        K[0, :n, np_:np_ + n] = torch.from_numpy(
            np.ascontiguousarray(NsT, _f32))
        zr = (v[:, None, :] @ K)[0, 0]
        right = zr[np_:np_ + n].numpy()
        return (np.concatenate([zr[:n].numpy(), right]) if which == "K"
                else right)

    def sum(self, a, b):
        v = torch.zeros((1, self.np), dtype=torch.float32)
        v[0, :len(a)] = torch.from_numpy(np.asarray(a, _f32)
                                         * np.asarray(b, _f32))
        return _f32(v.sum(dim=1, keepdim=True)[0, 0].item())


def _sub_mul(a, b, c, fused: bool):
    """a - b c in f32: one FMA, or the product rounded first."""
    a, b, c = (np.asarray(v, _f32) for v in (a, b, c))
    if not fused:
        return (a - b * c).astype(_f32)
    shape = np.broadcast_shapes(a.shape, b.shape, c.shape)
    t = [torch.from_numpy(np.array(np.broadcast_to(v, shape)))
         for v in (-b, c, a)]
    return fma32(*t).numpy()


def _argmin(vals: np.ndarray) -> int:
    """Ties to the lowest index."""
    return int(np.flatnonzero(vals == vals.min())[0])


def _statk(st: dict) -> np.ndarray:
    ao = np.asarray(st["aorder"])
    return np.where(ao >= 0, np.asarray(st["status"])[np.maximum(ao, 0)], 0)


def pending_slot(st: dict) -> int:
    """The pending candidate's slot of a hole-based state (skip1 = 1): the
    free slot holding a nonzero multiplier, else the first free one
    (``ops.cuda.gi_kernel.prepare_state``)."""
    free = np.asarray(st["aorder"]) < 0
    held = np.flatnonzero(free & (np.asarray(st["u"]) != 0))
    return int(held[0] if len(held) else np.flatnonzero(free)[0])


def gi_iteration(st: dict, d: dict, order=K1Order) -> dict:
    """One iteration of the hole-based GI loop (K1, K3, K4; the JAX
    package's ``_packed_iterate``) from the state ``st``, with the
    reductions of ``order`` (default: the CUDA loop's own) and every
    elementwise product, sum and quotient rounded apart, as all three
    implementations take them. Returns each operation's f32 result:
    ``sel`` (every constraint's selection value, on a fresh selection),
    ``p``, ``npl`` (n+), ``zr`` (z and the masked r), the four sums, ``t1``,
    ``t2``, ``t``, ``lpos``, the step kind, ``stop`` and ``success``, and
    ``next``, the state after the iteration (``it`` not counted).

    The state's slots (u, aorder and the rows of N*) may be more than n:
    the kernels keep np = round_up(n + 1, 8), and a candidate takes slot n
    when the n real ones are full. A pending candidate's slot is the
    state's ``sc_slot`` where it has one (the loop's own register), else
    :func:`pending_slot`."""
    m, n = d["C"].shape
    C, G = d["C"], d["G"]
    x = np.asarray(st["x"], _f32)
    u = np.asarray(st["u"], _f32)
    slots = np.arange(len(u))
    H = np.asarray(st["H"], _f32)
    NsT = np.ascontiguousarray(np.asarray(st["Ns"], _f32).T)
    K = np.concatenate([H, NsT], axis=1)
    status = np.asarray(st["status"]).copy()
    aorder = np.asarray(st["aorder"]).copy()
    statk = _statk(st)
    tr0 = _f32(st["hscale"])
    dep_thr = _f32(_f32(2e-7) * tr0)
    zs = _f32(_f32(_f32(1e-6) * tr0) * _f32(1.0 / n))
    out: dict = {"fresh": int(st["skip1"]) == 0}
    success = False
    if out["fresh"]:
        cx = order.dot(x, np.ascontiguousarray(C.T), "Ct")
        sl, su = cx - d["l"], d["u"] - cx
        vc = np.where(status[:m] != 0, BIG, np.minimum(sl, su))
        sb, ub = x - d["xl"], d["xu"] - x
        vb = np.where(status[m:] != 0, BIG, np.minimum(sb, ub))
        sel = np.concatenate([vc, vb]).astype(_f32)
        sts = np.concatenate([np.where(sl <= su, LOWER, UPPER),
                              np.where(sb <= ub, LOWER_BOUND, UPPER_BOUND)])
        p = _argmin(sel)
        out.update(sel=sel, p=p)
        success = bool(sel[p] >= 0)
        sc_idx, sc_st = p, int(sts[p])
        sc_slot = int(np.flatnonzero(statk == 0)[0])
    else:
        sc_idx, sc_st = int(st["sc_idx"]), int(st["sc_status"])
        sc_slot = (int(st["sc_slot"]) if "sc_slot" in st
                   else pending_slot(st))
    neg = sc_st in (UPPER, UPPER_BOUND)
    is_bnd = sc_st >= LOWER_BOUND
    vec = (np.eye(n, dtype=_f32)[sc_idx - m] if is_bnd
           else C[sc_idx].astype(_f32))
    npl = -vec if neg else vec
    zr = order.dot(npl, K, "K")
    act = statk != 0
    z = zr[:n].copy()
    r = np.where(act, zr[n:], _f32(0)).astype(_f32)
    zr = np.concatenate([z, r])
    znorm2, nz, nx, nn = (order.sum(z, z), order.sum(npl, z),
                          order.sum(npl, x), order.sum(npl, npl))
    fused = order.fused
    elig = act & (statk != EQUALITY) & (statk != FIXED) & (r > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        tks = np.where(elig, u / np.where(elig, r, _f32(1)), BIG).astype(_f32)
    lpos = _argmin(tks)
    t1 = _f32(min(tks[lpos], BIG))
    if is_bnd:
        bsel = d["xu"][sc_idx - m] if sc_st == UPPER_BOUND \
            else d["xl"][sc_idx - m]
    else:
        bsel = d["u"][sc_idx] if sc_st == UPPER else d["l"][sc_idx]
    sign = _f32(-1) if neg else _f32(1)
    nz_safe = nz if nz != 0 else _f32(1)
    t2 = (_f32(_f32(_f32(sign * bsel) - nx) / nz_safe)
          if znorm2 > _f32(_f32(zs * zs) * nn) else BIG)
    t = _f32(min(t1, t2))
    infeasible = bool(t >= BIG) and not success
    dual = bool(t2 >= BIG) and not infeasible
    full = not infeasible and not dual and bool(t2 <= t1)
    out.update(zr=zr, z=z, r=r, npl=npl, znorm2=znorm2, nz=nz, nx=nx, nn=nn,
               t1=t1, t2=_f32(t2), t=t, lpos=lpos, full=full, dual=dual,
               stop=success or infeasible, success=success,
               sc_idx=sc_idx, sc_status=sc_st,
               sc_slot=sc_slot, bsel=_f32(bsel))
    if out["stop"]:
        return out
    q, term = int(st["q"]), int(st["term"])
    if full:
        dependent = bool(nz <= _f32(dep_thr * nn))
        dsafe = _f32(1) if dependent else nz
        u_n = _sub_mul(u, t, r, fused)
        u_n[sc_slot] = _f32(u_n[sc_slot] + t)
        x_n = _sub_mul(x, -t, z, fused)
        vq = zr / dsafe
        K_n = _sub_mul(K, z[:, None], vq[None, :], fused)
        K_n[:, n + sc_slot] = vq[:n]
        status[sc_idx] = sc_st
        aorder[sc_slot] = sc_idx
        q += 1
        if dependent:
            term = LINEAR_DEPENDENCY_DETECTED
        skip1 = 0
    else:
        uk = _sub_mul(u, t, r, fused)
        cand_val = _f32(uk[sc_slot] + t)
        nl = K[:, n + lpos].copy()
        v = order.dot(nl, np.ascontiguousarray(G.T), "G^T")
        w = order.dot(v, np.ascontiguousarray(K[:, n:]), "N*^T")
        wl = w[lpos] if abs(w[lpos]) > 0 else _f32(1)
        keep = act & (slots != lpos)
        vq = np.concatenate([-nl, np.where(keep, w, _f32(0))]) / wl
        K_n = _sub_mul(K, nl[:, None], vq[None, :], fused)
        K_n[:, n + lpos] = 0
        status[min(max(int(aorder[lpos]), 0), m + n - 1)] = 0
        aorder[lpos] = -1
        uk[sc_slot] = _f32(uk[sc_slot] + t)
        u_n = np.where(slots == lpos, cand_val,
                       np.where(slots == sc_slot, _f32(0), uk))
        x_n = x if dual else _sub_mul(x, -t, z, fused)
        out.update(nl=nl, w=w, wl=_f32(wl))
        q -= 1
        skip1 = 1
        sc_slot = lpos
    out["vq"] = np.asarray(vq, _f32)
    out["next"] = {"x": np.asarray(x_n, _f32), "u": np.asarray(u_n, _f32),
                   "H": np.ascontiguousarray(K_n[:, :n], _f32),
                   "Ns": np.ascontiguousarray(K_n[:, n:].T, _f32),
                   "status": status, "aorder": aorder, "q": q, "term": term,
                   "skip1": skip1, "sc_idx": sc_idx, "sc_status": sc_st,
                   "sc_slot": sc_slot, "hscale": st["hscale"]}
    return out


def k1_iteration(st: dict, d: dict) -> dict:
    """:func:`gi_iteration` in the CUDA loop's order."""
    return gi_iteration(st, d, K1Order)


def same_next(it: dict, st_next: dict) -> bool:
    """Whether an iteration's ``next`` state holds the bits of a side's
    state at the next cap (x, u, H, N*, the active set and the slots)."""
    nxt = it.get("next")
    if nxt is None:
        return False
    return all(np.array_equal(np.asarray(nxt[k]), np.asarray(st_next[k]))
               for k in ("x", "u", "H", "Ns", "status", "aorder"))


# ---- each operation's own rounding, in f64 on the side's f32 inputs ----

def _ulp(v) -> float:
    return float(np.spacing(np.float32(abs(v))))


def _max_ulps(err, ref) -> float:
    return float(np.max(np.abs(err)) / _ulp(np.max(np.abs(ref))))


def op_roundings(st: dict, it: dict, d: dict, p: int) -> dict:
    """Each operation's own rounding in the iteration ``it`` (the f32
    results of one side, as :func:`k1_iteration` returns them) from the
    side's f32 state ``st``, against the same operation in f64 on the same
    f32 inputs: the slack of constraint ``p`` (ulps of its |C x|; fresh
    selections only), [z | r] (ulps of max |z|), t1 and t2 (ulps of each),
    x += t z (ulps of max |x|) and the rank-one update of K (ulps of max
    |K|); for z and x also their part along the slack's gradient g (ulps
    of |C_p x|)."""
    m, n = d["C"].shape
    x = np.asarray(st["x"], np.float64)
    u = np.asarray(st["u"], np.float64)
    K = np.concatenate([np.asarray(st["H"], np.float64),
                        np.asarray(st["Ns"], np.float64).T], axis=1)
    g, scale = slack_gradient(d, x, p)
    us = _ulp(scale)
    out = {}
    if it["fresh"]:
        v64 = violations(d, x)[0][p]
        out["slack"] = float((np.float64(it["sel"][p]) - v64) / us)
    npl = np.asarray(it["npl"], np.float64)
    zr64 = npl @ K
    z64 = zr64[:n]
    r64 = np.where(np.asarray(it["r"]) != 0, zr64[n:], 0.0)
    ez = np.asarray(it["z"], np.float64) - z64
    out["z"] = _max_ulps(ez, z64)
    out["r"] = _max_ulps(np.asarray(it["r"], np.float64) - r64,
                         r64) if np.any(r64) else 0.0
    out["z_along_g"] = float(np.float64(it["t"]) * (g @ ez) / us)
    zh = np.asarray(it["z"], np.float64)
    rh = np.asarray(it["r"], np.float64)
    l = int(it["lpos"])
    if rh[l] > 0:
        t1_64 = u[l] / rh[l]
        out["t1"] = float((np.float64(it["t1"]) - t1_64) / _ulp(t1_64))
    if it["t2"] < BIG:
        sign = -1.0 if it["sc_status"] in (UPPER, UPPER_BOUND) else 1.0
        t2_64 = (sign * np.float64(it["bsel"]) - npl @ x) / (npl @ zh)
        out["t2"] = float((np.float64(it["t2"]) - t2_64) / _ulp(t2_64))
    if "next" not in it:
        return out
    nxt = it["next"]
    moved = not it["dual"]
    x64 = x + np.float64(it["t"]) * zh if moved else x
    ex = np.asarray(nxt["x"], np.float64) - x64
    out["x_update"] = _max_ulps(ex, x64)
    out["x_update_along_g"] = float(g @ ex / us)
    if it["full"]:
        zrh = np.asarray(it["zr"], np.float64)
        nz = np.float64(it["nz"])
        dependent = nxt["term"] == LINEAR_DEPENDENCY_DETECTED
        K64 = K - np.outer(zh, zrh / (1.0 if dependent else nz))
        K64[:, n + int(it["sc_slot"])] = zh / (1.0 if dependent else nz)
    else:
        nl = K[:, n + l]
        w = (d["G"].astype(np.float64) @ nl) @ K[:, n:]
        keep = (_statk(st) != 0) & (np.arange(n) != l)
        wl = w[l] if abs(w[l]) > 0 else 1.0
        K64 = K - np.outer(nl, np.concatenate([-nl, np.where(keep, w, 0.0)])
                           / wl)
        K64[:, n + l] = 0.0
    Kh = np.concatenate([np.asarray(nxt["H"], np.float64),
                         np.asarray(nxt["Ns"], np.float64).T], axis=1)
    out["rank_one"] = _max_ulps(Kh - K64, K64)
    return out


# ---- the split of the deciding slack's error ----

def slack_gradient(d: dict, x64, p: int) -> tuple[np.ndarray, float]:
    """(g, scale): the gradient of constraint p's slack min(C_p x - l, u -
    C_p x) (or of a bound's) on the side that binds at ``x64``, and the
    scale |C_p x64| (|x64_j| for a bound) that sets its f32 ulp."""
    m, n = d["C"].shape
    x64 = np.asarray(x64, np.float64)
    if p < m:
        row = d["C"][p].astype(np.float64)
        cx = row @ x64
        g = row if cx - d["l"][p] <= d["u"][p] - cx else -row
        return g, abs(cx)
    j = p - m
    g = np.zeros(n)
    g[j] = 1.0 if x64[j] - d["xl"][j] <= d["xu"][j] - x64[j] else -1.0
    return g, abs(x64[j])


def step_exact(st: dict, it: dict, d: dict) -> tuple[float, np.ndarray]:
    """(t~, t~ z~): the iteration's step length and step in f64 on the
    side's f32 state (z~ = n+ K, t~ = t1 or t2 from x, u, z~, r~), taken as
    the side took it (full, partial or dual)."""
    n = d["C"].shape[1]
    x = np.asarray(st["x"], np.float64)
    u = np.asarray(st["u"], np.float64)
    K = np.concatenate([np.asarray(st["H"], np.float64),
                        np.asarray(st["Ns"], np.float64).T], axis=1)
    npl = np.asarray(it["npl"], np.float64)
    zr = npl @ K
    z = zr[:n]
    if it["dual"]:
        return 0.0, np.zeros(n)
    if it["full"]:
        sign = -1.0 if it["sc_status"] in (UPPER, UPPER_BOUND) else 1.0
        t = (sign * np.float64(it["bsel"]) - npl @ x) / (npl @ z)
    else:
        lp = int(it["lpos"])
        t = u[lp] / zr[n + lp]
    return float(t), t * z


def slack_split(d: dict, p: int, s_hat: float, states: list, its: list,
                x64_pv, x64_lo) -> dict:
    """The deciding slack's error at a parting, split; in f32 ulps of the
    row's |C_p x64| at the parting.

    ``states`` are one side's f32 states from the previous vertex (cap pv)
    to the parting's state (cap lo, a vertex); ``its`` the side's
    iterations from each state but the last (``its[i]`` takes
    ``states[i]`` to ``states[i + 1]``); ``s_hat`` the side's f32 slack of
    constraint ``p`` at ``states[-1]``; ``x64_pv`` and ``x64_lo`` the f64
    minimizers of the two vertices' active sets. Parts:

    - ``dot``: s_hat - slack(x_lo) in f64, the slack's own rounding;
    - ``inherited``: g (x_pv - x64_pv), x's error at the previous vertex;
    - ``x_update``: g (x_{i+1} - x_i - t_i z_i) summed, the updates' own
      rounding;
    - ``directions``: g t_i (z_i - z~_i), z's own rounding;
    - ``step_length``: g (t_i - t~_i) z~_i, t's own rounding (with the
      rounding of z that t inherits);
    - ``state``: g (sum t~_i z~_i - (x64_lo - x64_pv)), the step as f64
      takes it from the side's f32 H, N*, u and x, against the exact step
      between the two vertices; of it, ``state_x`` is the full steps'
      response to the inherited x error e = x_pv - x64_pv (t2 = (b - n+ x)
      / n+ z moves x back along n+: -sum (g z~_i)(n+_i e) / (n+_i z~_i))
      and ``state_operator`` the rest, the error of the f32 operator H,
      N* and of u.

    ``total`` is s_hat - slack(x64_lo); the parts sum to it; ``added`` is
    the sum of the four step parts."""
    x_lo = np.asarray(states[-1]["x"], np.float64)
    x64_lo = np.asarray(x64_lo, np.float64)
    g, scale = slack_gradient(d, x64_lo, p)
    us = _ulp(scale)
    seg = segment(d, states, its, x64_pv, x64_lo)
    parts = {"dot": float(s_hat) - violations(d, x_lo)[0][p],
             "inherited": g @ seg["e"],
             **{k: g @ seg[k] for k in ("x_update", "directions",
                                        "step_length", "state")}}
    out = {k: float(v) / us for k, v in parts.items()}
    out["added"] = sum(out[k] for k in ("x_update", "directions",
                                        "step_length", "state"))
    out["total"] = (float(s_hat) - violations(d, x64_lo)[0][p]) / us
    out["x_error"] = float(g @ (x_lo - x64_lo)) / us
    out["state_x"] = float(g @ seg["respond"](seg["e"])) / us
    out["state_operator"] = out["state"] - out["state_x"]
    return out


def segment(d: dict, states: list, its: list, x64_pv, x64_lo) -> dict:
    """The vectors of :func:`slack_split` for the iterations between two
    vertices: ``e`` = x_pv - x64_pv, ``x_update``, ``directions``,
    ``step_length`` and ``state`` (each summed over the iterations), and
    ``respond(v)``: the full steps' response to an error v of x at the
    first vertex, -sum z~_i (n+_i v) / (n+_i z~_i), and ``respond_t(h)``, its
    transpose applied to h. So x_lo - x64_lo = e + respond(e) + x_update +
    directions + step_length + (state - respond(e))."""
    x_pv = np.asarray(states[0]["x"], np.float64)
    n = len(x_pv)
    out = {"e": x_pv - np.asarray(x64_pv, np.float64),
           **{k: np.zeros(n) for k in ("x_update", "directions",
                                       "step_length")}}
    steps = np.zeros(n)
    full = []
    for st, it, nxt in zip(states[:-1], its, states[1:]):
        if it["dual"]:
            continue
        t = np.float64(it["t"])
        z = np.asarray(it["z"], np.float64)
        K = np.concatenate([np.asarray(st["H"], np.float64),
                            np.asarray(st["Ns"], np.float64).T], axis=1)
        npl = np.asarray(it["npl"], np.float64)
        z_tilde = (npl @ K)[:n]
        t_tilde, step = step_exact(st, it, d)
        out["x_update"] += (np.asarray(nxt["x"], np.float64)
                            - np.asarray(st["x"], np.float64) - t * z)
        out["directions"] += t * (z - z_tilde)
        out["step_length"] += (t - t_tilde) * z_tilde
        if it["full"]:
            full.append((z_tilde, npl / (npl @ z_tilde)))
        steps += step
    out["state"] = steps - (np.asarray(x64_lo, np.float64)
                            - np.asarray(x64_pv, np.float64))
    out["respond"] = lambda v: -sum((w @ v) * z for z, w in full) \
        if full else np.zeros(n)
    out["respond_t"] = lambda h: -sum((z @ h) * w for z, w in full) \
        if full else np.zeros(n)
    return out


def range_split(d: dict, p: int, s_hat: float, states: list, its: list,
                x64: dict) -> dict:
    """The deciding slack's error at a parting, split over a range of
    iterations: ``states`` at consecutive caps from a vertex to the
    parting's state, ``its`` the iterations between them, ``x64`` the f64
    minimizer at each vertex (by index into ``states``). Each segment
    between two vertices adds its own-rounding parts and the operator's
    (:func:`segment`); an error of x at a vertex reaches the parting's
    slack through every later segment's full steps, which move x back
    along their n+ (the adjoint of ``e -> e + respond(e)``). Parts, in f32
    ulps of |C_p x64| at the parting: ``dot``, ``before`` (x's error at the
    range's first vertex, carried to the parting), and per operation the
    sum over the segments of what each added, carried to the parting:
    ``x_update``, ``directions``, ``step_length``, ``operator``. They sum
    to ``total``."""
    vert = sorted(x64)
    g, scale = slack_gradient(d, x64[vert[-1]], p)
    us = _ulp(scale)
    x_lo = np.asarray(states[-1]["x"], np.float64)
    out = {"dot": float(s_hat) - violations(d, x_lo)[0][p],
           "x_update": 0.0, "directions": 0.0, "step_length": 0.0,
           "operator": 0.0}
    h = g
    for a, b in reversed(list(zip(vert[:-1], vert[1:]))):
        seg = segment(d, states[a:b + 1], its[a:b], x64[a], x64[b])
        for k in ("x_update", "directions", "step_length"):
            out[k] += h @ seg[k]
        out["operator"] += h @ (seg["state"] - seg["respond"](seg["e"]))
        h = h + seg["respond_t"](h)
    out["before"] = h @ (np.asarray(states[vert[0]]["x"], np.float64)
                         - np.asarray(x64[vert[0]], np.float64))
    res = {k: float(v) / us for k, v in out.items()}
    res["total"] = (float(s_hat) - violations(d, x64[vert[-1]])[0][p]) / us
    res["segments"] = len(vert) - 1
    return res


def states_at(traj: dict, caps, want) -> list[dict]:
    """The states of a trajectory (``miss_census.trajectory(..., full=True)``
    at ``caps``) at the caps ``want``, one dict each."""
    caps = [int(c) for c in caps]
    return [{k: v[caps.index(int(c))] for k, v in traj.items()}
            for c in want]


def vertex_window(traj: dict, caps, lo: int) -> list[int]:
    """The caps from the last vertex (skip1 = 0) before ``lo`` up to
    ``lo``, each of them among ``caps``."""
    caps = [int(c) for c in caps]
    c = lo - 1
    while c in caps and int(traj["skip1"][caps.index(c)]) != 0:
        c -= 1
    window = list(range(c, lo + 1))
    if any(k not in caps for k in window):
        raise ValueError(f"caps {caps} do not hold the window {window}")
    return window


def split_at_parting(d: dict, states: list, p: int, order=K1Order) -> dict:
    """The split of one side's deciding slack of constraint ``p`` at a
    parting, from its states at the caps of :func:`vertex_window` (the
    previous vertex to the parting's shared state): the iterations
    replayed in ``order``, how many of them reproduce the side's next state
    bit for bit, :func:`slack_split` and each iteration's
    :func:`op_roundings`."""
    its = [gi_iteration(s, d, order) for s in states]
    ok = sum(same_next(it, nxt) for it, nxt in zip(its, states[1:]))
    x64 = [iterate64(d, states[i]["status"])["x"] for i in (0, -1)]
    s_hat = float(its[-1]["sel"][p]) if its[-1]["fresh"] else float("nan")
    return {"replayed": [int(ok), len(states) - 1],
            "split": slack_split(d, p, s_hat, states, its[:-1], *x64),
            "ops": [op_roundings(s, it, d, p) for s, it in zip(states, its)]}
