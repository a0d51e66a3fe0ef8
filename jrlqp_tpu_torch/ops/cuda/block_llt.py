"""Block Cholesky and triangular inverse of (B, s, s) f32 blocks (K2).

Counterpart of the Pallas device helpers ``_chol_b`` (block_llt.py:89) and
``_tri_inv_b`` (:121). The CUDA versions are device functions in
``csrc/block_llt.cuh``, shared with the fused GI kernel (K1);
:func:`chol_inv_b` runs them alone through the thin kernel
``csrc/block_llt.cu``, one thread block per matrix.

The plain versions below are the same masked loops in PyTorch. They are not
``torch.linalg.cholesky``, which raises on a non-SPD block where these clamp
the pivot at 1e-30 and let :func:`posdef_plain` flag the block.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["chol_inv_b", "chol_b_plain", "tri_inv_b_plain", "posdef_plain"]

# launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0


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
    global launches
    B, s, _ = A.shape
    L = torch.empty_like(A)
    Li = torch.empty_like(A)
    pd = torch.empty((B,), dtype=torch.int32, device=A.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    code = lib.jrlqp_chol_inv_b(A.data_ptr(), L.data_ptr(), Li.data_ptr(),
                                pd.data_ptr(), B, s, stream)
    _build.check(code, "chol_inv_b")
    launches += 1
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
