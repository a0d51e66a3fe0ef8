"""Block Cholesky kernels: K2 on (B, s, s) blocks, and the structured
block-LLT kernels K5-K8 on (B, nb, s, s) block chains, all f32.

K2 is the counterpart of the Pallas device helpers ``_chol_b``
(block_llt.py:89) and ``_tri_inv_b`` (:121). The CUDA versions are device
functions in ``csrc/block_llt.cuh``, shared with the fused GI kernel (K1)
and K5/K7; :func:`chol_inv_b` runs them alone through the thin kernel
``csrc/block_llt.cu``, one thread block per matrix.

K5-K8 (``csrc/struct_llt.cu``) are the counterparts of the Pallas wrappers
``tri_block_llt_pallas`` (:246), ``tri_block_solve_pallas`` (:314),
``block_arrow_llt_pallas`` (:372) and ``block_arrow_solve_pallas`` (:429):
the factorizations return ``(L_diag, L_off, Linv_diag)`` with
``Linv_diag[i] = L_i^-1``, the solves ``y = G^-1 r`` for r of shape
(B, nb, s, k), at the unpadded shapes. Up arrows are factored in the rolled
block order (block 0 last), as the Pallas wrappers do; the solve takes the
rhs and returns y in the original order. The solves treat each
``Linv_diag[i]`` as lower triangular, as the factorizations return it: K6
and K8 read nothing above its diagonal.

K6 reads its operands in a padded layout, so that every block and every
rhs row starts on a 16-byte boundary for its bulk copies: the factor's
blocks with rows of ``round4(s)`` floats and the rhs with rows of
``round4(k)``. An operand already laid out so goes in as it is; any other is
copied once per call (:func:`pad_cols` for ``L_off`` and ``Linv``,
:func:`padded_rhs` for the rhs). :func:`identity_rhs` is one such buffer,
shared by the batch. Its result is a view of a padded buffer,
``y[..., :k]``.

The plain versions below are the same algorithms in PyTorch. They are not
``torch.linalg.cholesky``, which raises on a non-SPD block where these clamp
the pivot at 1e-30 and let :func:`posdef_plain` flag the block.
"""
from __future__ import annotations


import torch

from ...utils import spans
from . import _build

__all__ = ["chol_inv_b", "chol_b_plain", "tri_inv_b_plain", "posdef_plain",
           "tri_block_llt", "tri_block_llt_plain", "tri_block_solve",
           "tri_block_solve_plain", "block_arrow_llt",
           "block_arrow_llt_plain", "block_arrow_solve",
           "block_arrow_solve_plain", "solve_config", "factor_config",
           "pad_cols",
           "padded_rhs", "identity_rhs"]

# K6 stages six s x round4(s) f32 blocks (two per stage) in a thread
# block's shared memory, K5 and K7 keep three: s <= 96 fits
_STRUCT_MAX_S = 96


def chol_b_plain(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of (B, s, s) blocks by a right-looking column
    loop with pivots clamped at 1e-30 (``_chol_b``)."""
    s = A.shape[-1]
    rows = torch.arange(s, device=A.device).view(1, s, 1)
    cols = torch.arange(s, device=A.device).view(1, 1, s)
    Aw = A.clone()
    L = torch.zeros_like(A)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    for j in range(s):
        col = Aw[:, :, j:j + 1]                               # (B, s, 1)
        row = Aw[:, j:j + 1, :]                               # (B, 1, s)
        piv = Aw[:, j:j + 1, j:j + 1]                         # (B, 1, 1)
        isq = torch.rsqrt(torch.maximum(piv, zero + 1e-30))
        colL = torch.where(rows >= j, col * isq, zero)
        rowL = torch.where(cols >= j, row * isq, zero)
        L[:, :, j:j + 1] = colL
        Aw = Aw - colL * rowL
    return L


def tri_inv_b_plain(L: torch.Tensor) -> torch.Tensor:
    """L^-1 for (B, s, s) lower-triangular L by row-wise forward
    substitution (``_tri_inv_b``)."""
    s = L.shape[-1]
    cols = torch.arange(s, device=L.device).view(1, 1, s)
    X = torch.zeros_like(L)
    zero = torch.zeros((), dtype=L.dtype, device=L.device)
    for i in range(s):
        Lrow = L[:, i:i + 1, :]                               # (B, 1, s)
        below = torch.where(cols < i, Lrow, zero)
        eye_i = (cols == i).to(L.dtype)
        X[:, i:i + 1, :] = (eye_i - below @ X) / L[:, i:i + 1, i:i + 1]
    return X


def posdef_plain(L: torch.Tensor) -> torch.Tensor:
    """(B,) bool: min diag(L) > 1e-6 max diag(L); a NaN pivot is not SPD."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return d.amin(dim=1) > 1e-6 * d.amax(dim=1)


def _chol_inv_b_cuda(A: torch.Tensor):
    B, s, _ = A.shape
    L = torch.empty_like(A)
    Li = torch.empty_like(A)
    pd = torch.empty((B,), dtype=torch.int32, device=A.device)
    lib = _build.library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        code = lib.jrlqp_chol_inv_b(A.data_ptr(), L.data_ptr(),
                                    Li.data_ptr(), pd.data_ptr(), B, s,
                                    stream)
    _build.check(code, "chol_inv_b")
    spans.count("launch.chol_inv_b")
    return L, Li, pd.bool()


def chol_inv_b(A: torch.Tensor):
    """(L, L^-1, posdef) of (B, s, s) f32 blocks.

    A CUDA tensor runs the kernel (K2); a CPU tensor runs the plain
    versions. Any other device raises."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"chol_inv_b wants (B, s, s), got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"chol_inv_b wants float32, got {A.dtype}")
    if A.is_cuda:
        if A.shape[1] > 168:  # two s x s f32 blocks in 227 KB shared memory
            raise ValueError(f"chol_inv_b: block size {A.shape[1]} > 168")
        return _chol_inv_b_cuda(A.contiguous())
    if A.device.type != "cpu":
        raise RuntimeError(f"chol_inv_b: no kernel for device {A.device}")
    L = chol_b_plain(A)
    return L, tri_inv_b_plain(L), posdef_plain(L)


# ---------------------------------------------------------------------------
# K5-K8: the structured block-LLT chains
# ---------------------------------------------------------------------------


def tri_block_llt_plain(diag: torch.Tensor, off: torch.Tensor):
    """K5's plain version: L_i = chol(D_i - S'_{i-1} S'_{i-1}^T),
    S'_i = S_i L_i^-T and L_i^-1 for (B, nb, s, s) diagonal and
    (B, nb-1, s, s) sub-diagonal blocks (``_tri_llt_kernel``)."""
    B, nb, s, _ = diag.shape
    M = torch.zeros_like(diag[:, 0])
    Ls, Lis, Sps = [], [], []
    for i in range(nb):
        L = chol_b_plain(diag[:, i] - M)
        Li = tri_inv_b_plain(L)
        Ls.append(L)
        Lis.append(Li)
        if i < nb - 1:
            Sp = off[:, i] @ Li.mT
            Sps.append(Sp)
            M = Sp @ Sp.mT
    Lo = torch.stack(Sps, 1) if Sps else diag.new_zeros((B, 0, s, s))
    return torch.stack(Ls, 1), Lo, torch.stack(Lis, 1)


def tri_block_solve_plain(L_off: torch.Tensor, Linv: torch.Tensor,
                          r: torch.Tensor, lower_only: bool = False):
    """K6's plain version: y = G^-1 r by the forward then the backward block
    chain of products with the L_i^-1 (``_tri_solve_kernel``); with
    ``lower_only`` y = L^-1 r. r is (B, nb, s, k)."""
    nb = r.shape[1]
    ys = []
    for i in range(nb):
        rhs = r[:, i] if i == 0 else r[:, i] - L_off[:, i - 1] @ ys[-1]
        ys.append(Linv[:, i] @ rhs)
    if lower_only:
        return torch.stack(ys, 1)
    out = [None] * nb
    for i in range(nb - 1, -1, -1):
        rhs = ys[i] if i == nb - 1 else ys[i] - L_off[:, i].mT @ out[i + 1]
        out[i] = Linv[:, i].mT @ rhs
    return torch.stack(out, 1)


def block_arrow_llt_plain(diag: torch.Tensor, side: torch.Tensor,
                          up: bool = False):
    """K7's plain version: chol of each head block, B_i = S_i L_i^-T, the
    Schur complement D_last - sum B_i B_i^T factored last, and each L_i^-1
    (``_arrow_llt_kernel``). An up arrow is factored in the rolled order."""
    if up:
        diag = torch.roll(diag, -1, dims=1)
    B, nb, s, _ = diag.shape
    L_h = chol_b_plain(diag[:, :-1].reshape(-1, s, s))
    Li_h = tri_inv_b_plain(L_h).view(B, nb - 1, s, s)
    L_h = L_h.view(B, nb - 1, s, s)
    Bs = side @ Li_h.mT
    L_last = chol_b_plain(diag[:, -1] - (Bs @ Bs.mT).sum(1))
    Li_last = tri_inv_b_plain(L_last)
    return (torch.cat([L_h, L_last[:, None]], 1), Bs,
            torch.cat([Li_h, Li_last[:, None]], 1))


def block_arrow_solve_plain(L_side: torch.Tensor, Linv: torch.Tensor,
                            r: torch.Tensor, up: bool = False):
    """K8's plain version: y = G^-1 r for an arrow factor, independent heads
    with the coupling gathered into the last block, then scattered back
    (``_arrow_solve_kernel``). r and y are in the original block order."""
    if up:
        r = torch.roll(r, -1, dims=1)
    heads = Linv[:, :-1] @ r[:, :-1]
    y_last = Linv[:, -1] @ (r[:, -1] - (L_side @ heads).sum(1))
    w_last = Linv[:, -1].mT @ y_last
    y_head = Linv[:, :-1].mT @ (heads - L_side.mT @ w_last[:, None])
    y = torch.cat([y_head, w_last[:, None]], 1)
    return torch.roll(y, 1, dims=1) if up else y


def _chain_on_cuda(name: str, s: int, *ts) -> bool:
    """True for CUDA f32 tensors, False for CPU ones; raises otherwise."""
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} wants float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type == "cuda":
        if s > _STRUCT_MAX_S:
            raise ValueError(f"{name}: block size {s} > {_STRUCT_MAX_S}")
        return True
    if dev.type != "cpu":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    return False


def _check_factor_shapes(name: str, diag, off):
    if diag.dim() != 4 or diag.shape[2] != diag.shape[3]:
        raise ValueError(f"{name} wants diag (B, nb, s, s), got "
                         f"{tuple(diag.shape)}")
    B, nb, s, _ = diag.shape
    if tuple(off.shape) != (B, nb - 1, s, s):
        raise ValueError(f"{name} wants off {(B, nb - 1, s, s)}, got "
                         f"{tuple(off.shape)}")


def _check_solve_shapes(name: str, L_off, Linv, r):
    _check_factor_shapes(name, Linv, L_off)
    if r.dim() != 4 or tuple(r.shape[:3]) != tuple(Linv.shape[:3]):
        raise ValueError(f"{name} wants r (B, nb, s, k) with (B, nb, s) = "
                         f"{tuple(Linv.shape[:3])}, got {tuple(r.shape)}")


def _tri_llt_cuda(diag, off):
    """K5; its outputs are views [..., :s] of buffers with rows of
    round4(s) floats."""
    B, nb, s, _ = diag.shape
    sp = _round4(s)
    Ld, Li = (diag.new_empty((B, nb, s, sp)) for _ in range(2))
    Lo = diag.new_empty((B, nb - 1, s, sp))
    with torch.cuda.device(diag.device):
        stream = torch.cuda.current_stream(diag.device).cuda_stream
        code = _build.library().jrlqp_tri_block_llt(
            diag.data_ptr(), off.data_ptr(), Ld.data_ptr(), Lo.data_ptr(),
            Li.data_ptr(), B, nb, s, stream)
    _build.check(code, "jrlqp_tri_block_llt")
    return Ld[..., :s], Lo[..., :s], Li[..., :s]


def _arrow_llt_cuda(diag, side, up: bool):
    """K7."""
    B, nb, s, _ = diag.shape
    Ld, Li, Lo = torch.empty_like(diag), torch.empty_like(diag), \
        torch.empty_like(side)
    with torch.cuda.device(diag.device):
        stream = torch.cuda.current_stream(diag.device).cuda_stream
        code = _build.library().jrlqp_block_arrow_llt(
            diag.data_ptr(), side.data_ptr(), Ld.data_ptr(), Lo.data_ptr(),
            Li.data_ptr(), B, nb, s, int(up), stream)
    _build.check(code, "jrlqp_block_arrow_llt")
    return Ld, Lo, Li


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def _lies_padded(t: torch.Tensor, width: int, any_batch: bool) -> bool:
    """Does (B, nb, rows, w) ``t`` lie as the [..., :w] view of a contiguous
    buffer of last dimension ``width``, 16-byte aligned? With ``any_batch``
    the problems may lie at any multiple of 4 floats apart (0 included)."""
    B, nb, rows, _ = t.shape
    st = t.stride()
    batch = (B == 1 or (st[0] % 4 == 0 if any_batch
                        else st[0] == nb * rows * width))
    return (st[3] == 1 and st[2] == width and st[1] == rows * width
            and batch and t.data_ptr() % 16 == 0)


def pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    """(B, nb, rows, w) ``t`` in a contiguous buffer of last dimension
    ``width``, as the buffer's [..., :w]: ``t`` itself when it already lies
    so (whatever the buffer holds beyond column w), else a zero-padded
    copy."""
    if _lies_padded(t, width, any_batch=False):
        return t
    out = t.new_zeros((*t.shape[:-1], width))
    out[..., :t.shape[-1]] = t
    return out[..., :t.shape[-1]]


def padded_rhs(r: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(r_p, batch stride) of a (B, nb, s, k) rhs in K6's layout: block rows
    of s rows of ``round4(k)`` floats, contiguous within a problem, each
    problem a multiple of 4 floats from the last (0: one rhs for the whole
    batch), 16-byte aligned. ``r_p`` is ``r`` when ``r`` already lies so,
    else a zero-padded copy; either way ``r_p`` has r's shape and values."""
    B, nb, s, k = r.shape
    kp = _round4(k)
    if _lies_padded(r, kp, any_batch=True):
        return r, (r.stride()[0] if B > 1 else 0)
    return pad_cols(r, kp), nb * s * kp


def identity_rhs(B: int, nb: int, s: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """The identity of width n = nb s as a (B, nb, s, n) rhs: a view of one
    (nb, s, round4(n)) buffer shared by the batch, in K6's layout
    (:func:`padded_rhs` takes it as it is)."""
    n = nb * s
    eye = torch.zeros((n, _round4(n)), dtype=dtype, device=device)
    eye.diagonal().fill_(1.0)
    return eye.view(1, nb, s, -1).expand(B, -1, -1, -1)[..., :n]


def _tri_solve_cuda(L_off, Linv, r, lower_only: bool):
    """K6 on the padded layout; returns y[..., :k] of a padded buffer."""
    B, nb, s, k = r.shape
    sp = _round4(s)
    Lo_p, Li_p = pad_cols(L_off, sp), pad_cols(Linv, sp)
    r_p, rbs = padded_rhs(r)
    y = torch.empty((B, nb, s, _round4(k)), dtype=r.dtype, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        code = _build.library().jrlqp_tri_block_solve(
            Lo_p.data_ptr(), Li_p.data_ptr(), r_p.data_ptr(), rbs,
            y.data_ptr(), B, nb, s, k, int(lower_only), stream)
    _build.check(code, "jrlqp_tri_block_solve")
    return y[..., :k]


def _arrow_solve_cuda(L_side, Linv, r, up: bool):
    """K8."""
    B, nb, s, k = r.shape
    y = torch.empty_like(r)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        code = _build.library().jrlqp_block_arrow_solve(
            L_side.data_ptr(), Linv.data_ptr(), r.data_ptr(), y.data_ptr(),
            B, nb, s, k, int(up), stream)
    _build.check(code, "jrlqp_block_arrow_solve")
    return y


def solve_config(entry: str, s: int, k: int) -> dict:
    """The launch configuration of the solve kernel behind the C entry
    point ``entry`` (``jrlqp_tri_block_solve`` K6 or
    ``jrlqp_block_arrow_solve`` K8) at block size s and k rhs columns, on
    the current card: the rhs tile width, the threads and shared-memory
    bytes per block, and the resident blocks per SM."""
    import ctypes

    which = {"jrlqp_tri_block_solve": 0, "jrlqp_block_arrow_solve": 1}[entry]
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().jrlqp_struct_solve_config(which, s, k, out),
                 entry)
    return dict(zip(("tile", "threads", "smem_bytes", "blocks_per_sm"), out))


def factor_config(entry: str, s: int) -> dict:
    """The launch configuration of the factorization kernel behind the C
    entry point ``entry`` (``jrlqp_tri_block_llt`` K5 or
    ``jrlqp_block_arrow_llt`` K7) at block size s, on the current card: the
    threads and shared-memory bytes per block (one block per problem) and
    the resident blocks per SM."""
    import ctypes

    which = {"jrlqp_tri_block_llt": 0, "jrlqp_block_arrow_llt": 1}[entry]
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().jrlqp_struct_factor_config(which, s, out),
                 entry)
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm"), out))


def tri_block_llt(diag: torch.Tensor, off: torch.Tensor):
    """(L_diag, L_off, Linv_diag) of a batch of f32 block-tridiagonal
    chains, diag (B, nb, s, s) and off (B, nb-1, s, s) with off[i] at block
    (i+1, i): the counterpart of ``tri_block_llt_pallas``. A CUDA batch
    runs the kernel K5, whose outputs are views ``[..., :s]`` of buffers
    with rows of ``round4(s)`` floats, the layout K6 reads; a CPU batch runs
    its plain version; any other device raises."""
    _check_factor_shapes("tri_block_llt", diag, off)
    if not _chain_on_cuda("tri_block_llt", diag.shape[-1], diag, off):
        return tri_block_llt_plain(diag, off)
    out = _tri_llt_cuda(diag.contiguous(), off.contiguous())
    spans.count("launch.K5")
    return out


def tri_block_solve(L_off: torch.Tensor, Linv: torch.Tensor, r: torch.Tensor,
                    lower_only: bool = False):
    """y = G^-1 r (or L^-1 r with ``lower_only``) for r (B, nb, s, k) and
    the factor of :func:`tri_block_llt`: the counterpart of
    ``tri_block_solve_pallas``. A CUDA batch runs the kernel K6 (its
    result a view ``y[..., :k]`` of a padded buffer), a CPU batch its plain
    version; any other device raises."""
    _check_solve_shapes("tri_block_solve", L_off, Linv, r)
    if not _chain_on_cuda("tri_block_solve", r.shape[2], L_off, Linv, r):
        return tri_block_solve_plain(L_off, Linv, r, lower_only)
    y = _tri_solve_cuda(L_off, Linv, r, lower_only)
    spans.count("launch.K6")
    return y


def block_arrow_llt(diag: torch.Tensor, side: torch.Tensor, up: bool = False):
    """(L_diag, L_side, Linv_diag) of a batch of f32 block-arrow matrices,
    diag (B, nb, s, s) and side (B, nb-1, s, s) with side[i] at block
    (nb-1, i), or at (0, i+1) when ``up``: the counterpart of
    ``block_arrow_llt_pallas``. An up arrow's factor is in the rolled block
    order (block 0 last). A CUDA batch runs the kernel K7, a CPU batch its
    plain version; any other device raises."""
    _check_factor_shapes("block_arrow_llt", diag, side)
    if not _chain_on_cuda("block_arrow_llt", diag.shape[-1], diag, side):
        return block_arrow_llt_plain(diag, side, up)
    out = _arrow_llt_cuda(diag.contiguous(), side.contiguous(), up)
    spans.count("launch.K7")
    return out


def block_arrow_solve(L_side: torch.Tensor, Linv: torch.Tensor,
                      r: torch.Tensor, up: bool = False):
    """y = G^-1 r for r (B, nb, s, k) and the factor of
    :func:`block_arrow_llt` with the same ``up``: the counterpart of
    ``block_arrow_solve_pallas``. A CUDA batch runs the kernel K8, a CPU
    batch its plain version; any other device raises."""
    _check_solve_shapes("block_arrow_solve", L_side, Linv, r)
    if not _chain_on_cuda("block_arrow_solve", r.shape[2], L_side, Linv, r):
        return block_arrow_solve_plain(L_side, Linv, r, up)
    y = _arrow_solve_cuda(L_side.contiguous(), Linv.contiguous(),
                          r.contiguous(), up)
    spans.count("launch.K8")
    return y
