"""The dense refinement, pinned: the results of the dense entry points on a
fixed small batch against a copy of the refinement as it was one function
on the dense G and C (:func:`refine_one_function`), run on this host from
the same final states, bit for bit; and against arrays saved from that
version of the port (``tests/data/refine_dense_parent.npz``): status,
iterations and active set exactly, x, multipliers and f within 1e-12
relative, since batched matmul rounding on the CPU depends on the host's
BLAS kernels. Every dense caller keeps that arithmetic: the f64 products
once, then f32 increments through f32 copies of G and of the active
normals, or the f64 products at every step (``solve_refined``).

The file holds its inputs too, so the draws cannot move. To write it anew
from another version of the port (the CPU, one thread):

    python tests/test_torch_refine_dense.py tests/data/refine_dense_parent.npz
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from jrlqp_tpu_torch import SolverOptions, problem_from_numpy  # noqa: E402
from jrlqp_tpu_torch.solver import fast  # noqa: E402
from jrlqp_tpu_torch.solver.state import GIResult  # noqa: E402
from jrlqp_tpu_torch.types import (  # noqa: E402
    LOWER_BOUND,
    UPPER,
    UPPER_BOUND,
)

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data" / "refine_dense_parent.npz"
FIELDS = ("G", "a", "C", "l", "u", "xl", "xu")
OUTPUTS = ("x", "multipliers", "f", "status", "iterations", "active_set")
EXACT_OUTPUTS = ("status", "iterations", "active_set")

# name: (entry point, its arguments after the problem, whether its
# refinement recomputes the f64 products at every step)
CASES = {
    "kernel_ir1": (fast.solve_refined_kernel,
                   dict(opt=SolverOptions(max_iter=150), ir_steps=1), False),
    "kernel_ir3": (fast.solve_refined_kernel,
                   dict(opt=SolverOptions(max_iter=150), ir_steps=3), False),
    "kernel_from_init": (fast.solve_refined_kernel,
                         dict(opt=SolverOptions(max_iter=150), ir_steps=3,
                              fused_init=False), False),
    "exact": (fast.solve_refined, dict(opt=SolverOptions(max_iter=150),
                                       ir_steps=3), True),
}


def refine_one_function(pbs, st, ir_steps, exact):
    """The dense refinement as one function on the dense G and C: f64
    products once, then f32 increments through f32 copies of G and of the
    active normals, or with ``exact`` the f64 products at every step."""
    _bmv, _bmtv = fast._bmv, fast._bmtv
    B, n = pbs.a.shape
    m = pbs.C.shape[1]
    f64, f32 = torch.float64, torch.float32
    valid = st.aorder >= 0
    idxs = torch.where(valid, st.aorder, 0).long()
    stat = torch.where(valid, st.status.long().gather(1, idxs), 0)
    upperish = (stat == UPPER) | (stat == UPPER_BOUND)
    sgn64 = torch.where(upperish, -1.0, 1.0).to(f64) * valid
    is_b = stat >= LOWER_BOUND

    def clamp(v):
        return torch.nan_to_num(v, posinf=1e30, neginf=-1e30).clamp(-1e30,
                                                                     1e30)

    lo_all = clamp(torch.cat([pbs.l, pbs.xl], dim=1).to(f64))
    up_all = clamp(torch.cat([pbs.u, pbs.xu], dim=1).to(f64))
    b_sel = torch.where(upperish, up_all.gather(1, idxs),
                        lo_all.gather(1, idxs))
    b = sgn64 * b_sel * valid

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
    lam32 = torch.where(valid, st.u[:, :n], 0.0).to(f32)
    x = st.x.to(f64)
    lam = lam32.to(f64)

    G64, C64 = pbs.G.to(f64), pbs.C.to(f64)
    c_at = torch.where(is_b, m, cidx)
    b_at = torch.where(is_b, bidx, n)

    def products(x, lam):
        signed = sgn64 * lam
        mu_c = torch.zeros((B, m + 1), dtype=f64, device=x.device
                           ).scatter_add(1, c_at, signed)[:, :m]
        mu_b = torch.zeros((B, n + 1), dtype=f64, device=x.device
                           ).scatter_add(1, b_at, signed)[:, :n]
        cx = _bmv(C64, x)
        return (_bmv(G64, x),
                sgn64 * torch.cat([cx, x], dim=1).gather(1, idxs),
                _bmtv(C64, mu_c) + mu_b)

    y, ntx, w = products(x, lam)
    for step in range(ir_steps):
        if exact and step:
            y, ntx, w = products(x, lam)
        r1 = w - y - a64
        r2 = torch.where(valid, b - ntx, 0.0)
        r1_32, r2_32 = r1.to(f32), r2.to(f32)
        nstr2 = _bmtv(Ns32, r2_32)
        dx = _bmv(H32, r1_32) + nstr2
        gv = _bmv(G32, nstr2)
        dlam = _bmv(Ns32, gv - r1_32)
        x = x + dx.to(f64)
        lam = torch.where(valid, lam + dlam.to(f64), 0.0)
        if not exact:
            y = y + _bmv(G32, dx).to(f64)
            ntx = ntx + _bmv(Nt32, dx).to(f64)
            w = w + _bmtv(Nt32, dlam).to(f64)
    if exact:
        y = _bmv(G64, x)

    sign_out = torch.where(upperish, 1.0, -1.0).to(f64)
    vals = torch.where(valid, sign_out * lam, 0.0)
    multipliers = torch.zeros((B, m + n), dtype=f64,
                              device=x.device).scatter_add(1, idxs, vals)
    f = 0.5 * (x * y).sum(dim=1) + (a64 * x).sum(dim=1)
    return GIResult(x=x, multipliers=multipliers, f=f, iterations=st.it,
                    status=st.term, active_set=st.status)


def draw(seed=2026, batch=24, n=16, m=16):
    """A batch of dense QPs with general rows and variable bounds, a
    quarter of the rows tight below and a quarter above at an interior
    point: the refinement meets general and bound slots, lower and
    upper."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, n, n))
    G = A @ A.transpose(0, 2, 1) / n + np.eye(n)
    G = 0.5 * (G + G.transpose(0, 2, 1))
    C = rng.standard_normal((batch, m, n))
    x0 = rng.uniform(-1.0, 1.0, (batch, n))
    cx = np.einsum("bij,bj->bi", C, x0)
    tight = np.arange(m) < m // 4
    l_ = cx - np.where(tight, 0.0, 3.0 * rng.uniform(0.01, 1.0, (batch, m)))
    u_ = cx + np.where(tight[::-1], 0.0,
                       3.0 * rng.uniform(0.01, 1.0, (batch, m)))
    a = 3.0 * rng.standard_normal((batch, n))
    return dict(G=G, a=a, C=C, l=l_, u=u_, xl=x0 - 0.3, xu=x0 + 0.3)


def outputs(res):
    return {k: getattr(res, k).numpy() for k in OUTPUTS}


def solve(name, d):
    entry, kw, _ = CASES[name]
    return outputs(entry(problem_from_numpy(**d, device="cpu"), **kw))


def write(path):
    d = draw()
    out = {f"in_{k}": v for k, v in d.items()}
    for name in CASES:
        out.update({f"{name}_{k}": v for k, v in solve(name, d).items()})
    np.savez_compressed(path, **out)


@pytest.mark.parametrize("name", list(CASES))
def test_dense_refinement_is_unchanged_bit_for_bit(name, monkeypatch):
    saved = np.load(DATA)
    d = {k: saved[f"in_{k}"] for k in FIELDS}
    seen = []
    refine = fast._refine

    def recorded(pbs, st, ir_steps, products):
        seen.append((pbs, st, ir_steps))
        return refine(pbs, st, ir_steps, products)

    monkeypatch.setattr(fast, "_refine", recorded)
    got = solve(name, d)
    assert len(seen) == 1
    # bit for bit against the one-function refinement, on this host, from
    # the same final states
    want = outputs(refine_one_function(*seen[0], exact=CASES[name][2]))
    for k in OUTPUTS:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{name}: {k}")
    # the batch reaches both kinds of slot, and every lane an answer
    assert (saved[f"{name}_status"] == 0).all()
    active = saved[f"{name}_active_set"]
    m = saved["in_C"].shape[1]
    assert (active[:, :m] > 0).any() and (active[:, m:] > 0).any()
    # against the saved arrays: the loop's outcome exactly, the refined
    # values to the host's rounding
    for k in OUTPUTS:
        ref = saved[f"{name}_{k}"]
        if k in EXACT_OUTPUTS:
            np.testing.assert_array_equal(got[k], ref,
                                          err_msg=f"{name}: {k}")
        else:
            np.testing.assert_allclose(
                got[k], ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max(),
                err_msg=f"{name}: {k}")


if __name__ == "__main__":
    write(sys.argv[1])
