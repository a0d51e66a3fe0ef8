"""K13 and K14: the structured refinement's f64 products on G's blocks and
C's rows, their wrappers and their plain versions.

The refinement of a structured batch (``structured.solver._BlockProducts``
behind ``fast._refine``) tracks x, lam, G x, N^T x and N lam in f64 through
the increments of each step. The JAX package runs it as XLA ops on the
dense G and C (``jrlqp_tpu/solver/fast.py:397``, no Pallas kernel). Here a
step is the three f32 gemvs with the loop's H and N* and two launches
(``csrc/struct_refine.cu``):

- :func:`struct_gmul` (K13): t = f32(G u) - r and g = G v in f64 for f32
  (B, n) u and v, G given by its blocks: the correction's G N*^T r2 and the
  increment G dx in one pass over the blocks;
- :func:`struct_update` (K14): x, lam, y = G x, ntx = N^T x and w = N lam
  updated in place by dx, dlam and dy = G dx, and the next residuals
  r1 = f32(w - y - a) and r2 = f32(b - ntx) at the active slots. C is
  (B, m, width) with ``mc`` rows per block of ``width`` columns: the blocks
  of a StructuredC (width s) or a dense C (width n, mc m).

A CUDA batch runs the kernels, a CPU batch the plain versions, which are
the same arithmetic in PyTorch up to the order of the sums. The kernels
take any block size whose operands fit in a thread block's shared memory
(K13: an s x s block and four (B, n) columns in f64; K14: three (B, n)
vectors and m multipliers); beyond that the launch raises.
"""
from __future__ import annotations

import torch

from ...structured.blocks import block_arrow_matvec, tri_block_matvec
from ...utils import spans
from . import _build

__all__ = ["struct_gmul", "struct_gmul_plain", "struct_update",
           "struct_update_plain"]

_TRI, _UP = 0, 1              # GType values


def struct_gmul_plain(diag, off, gtype: int, u, v, r):
    """(f32(G u) - r or None without u, G v in f64) by the blocks."""
    f64 = torch.float64
    cols = v[..., None] if u is None else torch.stack([u, v], dim=2)
    B, nb, s, _ = diag.shape
    xb = cols.to(f64).reshape(B, nb, s, -1)
    if gtype == _TRI:
        g = tri_block_matvec(diag, off, xb)
    else:
        g = block_arrow_matvec(diag, off, xb, up=gtype == _UP)
    g = g.reshape(B, nb * s, -1)
    if u is None:
        return None, g[:, :, 0]
    return g[:, :, 0].to(torch.float32) - r, g[:, :, 1]


def struct_gmul(diag, off, gtype: int, u, v, r):
    """t = f32(G u) - r and g = G v (f64) for f32 (B, n) u, v and r, G
    given by its f64 blocks diag (B, nb, s, s) and off (B, nb - 1, s, s) of
    the layout ``gtype`` (a GType value); with u None, (None, G v). K13 on
    a card, the plain version on the CPU."""
    if v.device.type != "cuda":
        return struct_gmul_plain(diag, off, gtype, u, v, r)
    B, nb, s, _ = diag.shape
    g = torch.empty((B, nb * s), dtype=torch.float64, device=v.device)
    t = None if u is None else torch.empty_like(u)
    ptr = (lambda z: 0 if z is None else z.data_ptr())  # noqa: E731
    lib = _build.library()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        code = lib.jrlqp_struct_gmul(
            diag.contiguous().data_ptr(), off.contiguous().data_ptr(),
            ptr(u), v.data_ptr(), ptr(r), ptr(t), g.data_ptr(), B, nb, s,
            int(gtype), stream)
    _build.check(code, "struct_gmul")
    spans.count("launch.K13")
    return t, g


def struct_update_plain(C, mc: int, idx, sgn, a, b, dx, dlam, dy, state):
    """The plain version of :func:`struct_update`."""
    f64 = torch.float64
    x, lam, y, ntx, w = state
    B, n = x.shape
    m, width = C.shape[1], C.shape[2]
    rows = C.reshape(B, n // width, mc, width)
    dx, dlam = dx.to(f64), dlam.to(f64)
    valid = sgn != 0
    x += dx
    lam.copy_(torch.where(valid, lam + dlam, 0.0))
    y += dy
    # N^T dx: the active rows of C dx and the bound rows' dx
    cdx = (rows @ dx.reshape(B, n // width, width, 1)).reshape(B, m)
    ntx += sgn * torch.cat([cdx, dx], dim=1).gather(1, idx.long())
    # N dlam = C^T mu_c + mu_b: each multiplier alone in its row
    mu = torch.zeros((B, m + n + 1), dtype=f64, device=x.device).scatter_(
        1, torch.where(valid, idx.long(), m + n), sgn * dlam)
    ct = rows.mT @ mu[:, :m].reshape(B, n // width, mc, 1)
    w += ct.reshape(B, n) + mu[:, m:m + n]
    return ((w - y - a).to(torch.float32),
            torch.where(valid, b - ntx, 0.0).to(torch.float32))


def struct_update(C, mc: int, idx, sgn, a, b, dx, dlam, dy, state):
    """One step's update of the tracked f64 quantities ``state`` = (x, lam,
    y, ntx, w), each (B, n), in place: x += dx, lam += dlam at the active
    slots (0 elsewhere), y += dy, ntx += N^T dx, w += N dlam; returns the
    next residuals (r1, r2) in f32. C is (B, m, width) f64 with ``mc`` rows
    per block of ``width`` columns; slot k holds the constraint idx[k]
    (int32) with the sign sgn[k] (0 at a free slot), the signed bound b[k];
    a is the linear term; dx, dlam f32 and dy f64. K14 on a card, the plain
    version on the CPU."""
    if dx.device.type != "cuda":
        return struct_update_plain(C, mc, idx, sgn, a, b, dx, dlam, dy,
                                   state)
    x, lam, y, ntx, w = state
    B, n = x.shape
    m, width = C.shape[1], C.shape[2]
    r1 = torch.empty_like(dx)
    r2 = torch.empty_like(dx)
    lib = _build.library()
    with torch.cuda.device(dx.device):
        stream = torch.cuda.current_stream(dx.device).cuda_stream
        code = lib.jrlqp_struct_update(
            C.data_ptr(), idx.data_ptr(), sgn.data_ptr(), a.data_ptr(),
            b.data_ptr(), dx.data_ptr(), dlam.data_ptr(), dy.data_ptr(),
            x.data_ptr(), lam.data_ptr(), y.data_ptr(), ntx.data_ptr(),
            w.data_ptr(), r1.data_ptr(), r2.data_ptr(), B, n, m, mc, width,
            stream)
    _build.check(code, "struct_update")
    spans.count("launch.K14")
    return r1, r2
