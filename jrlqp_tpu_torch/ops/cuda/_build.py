"""Build the CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles every ``jrlqp_tpu_torch/csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The library goes to ``build/jrlqp_tpu_torch/`` beside the
package, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as is. Each C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises on a nonzero
code. The counter ``library.load`` of :mod:`jrlqp_tpu_torch.utils.spans`
counts the builds and loads of the library in this process
(:func:`jrlqp_tpu_torch.utils.no_retrace` reads it).

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ...utils import spans

__all__ = ["library", "check", "own", "build_info"]

_PKG = Path(__file__).resolve().parents[2]          # jrlqp_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "jrlqp_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C signature of every entry point: pointers and the stream as void*,
# sizes as int, thresholds as double (ctypes would otherwise pass a pointer
# as a 32-bit int)
_SIGNATURES = {
    "jrlqp_chol_inv_b": [_P, _P, _P, _P, _I, _I, _P],
    # G, Ct, l, u, xl, xu, a; x, u, status, aorder, scal, K, hscale;
    # B, n, m, np_, mp_, max_iter; stream
    "jrlqp_gi_fused": [_P] * 14 + [_I] * 6 + [_P],
    # G, Ct, l, u, xl, xu, K0, x0, u0, status0, aorder0, statk0, scal0,
    # hscale0; the 7 outputs as above; B, n, m, np_, mp_, max_iter; stream
    "jrlqp_gi_loop": [_P] * 21 + [_I] * 6 + [_P],
    # K9: K3's arguments
    "jrlqp_gi_compact": [_P] * 21 + [_I] * 6 + [_P],
    # G, Ct, l, u, xl, xu, a, K0, status0, aorder0, q, reset, Kr, statusr,
    # aorderr, qr; the 7 outputs as above; B, n, m, np_, mp_, max_iter;
    # stream
    "jrlqp_gi_warm": [_P] * 23 + [_I] * 6 + [_P],
    # diag, off; Ld, Lo, Li; B, nb, s; stream
    "jrlqp_tri_block_llt": [_P] * 5 + [_I] * 3 + [_P],
    # diag, side; Ld, Lo, Li; B, nb, s, up; stream
    "jrlqp_block_arrow_llt": [_P] * 5 + [_I] * 4 + [_P],
    # Lo, Li, r (padded: block_llt.padded_rhs), r's batch stride; y; B, nb,
    # s, k, lower_only; stream
    "jrlqp_tri_block_solve": [_P] * 3 + [ctypes.c_longlong, _P] + [_I] * 5
    + [_P],
    # Lo, Li, r; y; B, nb, s, k, up; stream
    "jrlqp_block_arrow_solve": [_P] * 4 + [_I] * 5 + [_P],
    # K10: C^T, l, u, xl, xu; the state in place: x, f, J, R, status,
    # aorder, u, scal; B, n, m, max_iter; big_bnd, zero_z; stream
    "jrlqp_jr_loop_f64": [_P] * 13 + [_I] * 4 + [_D] * 2 + [_P],
    "jrlqp_jr_loop_f32": [_P] * 13 + [_I] * 4 + [_D] * 2 + [_P],
    # K11: G, C, l, u, xl, xu, hscale; the state in place: x, f, H, Ns,
    # status, aorder, u, scal; B, n, m, max_iter; big_bnd, zero_z, dep_eps;
    # stream
    "jrlqp_fast_loop_f32": [_P] * 15 + [_I] * 4 + [_D] * 3 + [_P],
    "jrlqp_fast_loop_f64": [_P] * 15 + [_I] * 4 + [_D] * 3 + [_P],
    # K11's on-chip instance: the same, with the cluster size after m
    "jrlqp_fast_loop_onchip_f32": [_P] * 15 + [_I] * 5 + [_D] * 3 + [_P],
    # K13: diag, off, u, v, r; t, g; B, nb, s, gtype; stream
    "jrlqp_struct_gmul": [_P] * 7 + [_I] * 4 + [_P],
    # K14: C, idx, sgn, a, b, dx, dlam, dy; x, lam, y, ntx, w in place; r1,
    # r2; B, n, m, mc, width; stream
    "jrlqp_struct_update": [_P] * 15 + [_I] * 5 + [_P],
    # K12: G, l, u, xl, xu, a, H, Ns, status, aorder, q; x, f, H, Ns,
    # status, aorder, u, scal, hscale; B, n, m; stream
    "jrlqp_carry_init": [_P] * 20 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    cu = sorted(CSRC.glob("*.cu"))
    key = _source_hash(sorted(CSRC.glob("*.cu*")))
    out = BUILD_DIR / f"libjrlqp_kernels_{key}.so"
    log = out.with_suffix(".log")
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True,
                          log=log.read_text() if log.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{key}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in cu]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cu, objs)]
    text = ""
    failed = []
    for src, proc in zip(cu, procs):
        log_i = proc.communicate()[0]
        text += log_i
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        text += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{text}")
    log.write_text(text)
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=seconds, cached=False, log=text)
    return out


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            spans.count("library.load")
            lib = ctypes.CDLL(str(_build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.jrlqp_error_string.argtypes = [_I]
            lib.jrlqp_error_string.restype = ctypes.c_char_p
            lib.jrlqp_gi_smem_bytes.argtypes = [_I, _I]
            lib.jrlqp_gi_smem_bytes.restype = ctypes.c_size_t
            lib.jrlqp_gi_threads.argtypes = []
            lib.jrlqp_gi_threads.restype = _I
            lib.jrlqp_gi_blocks_per_sm.argtypes = [_I, _I, _I]
            lib.jrlqp_gi_blocks_per_sm.restype = _I
            lib.jrlqp_struct_solve_config.argtypes = [
                _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
            lib.jrlqp_struct_solve_config.restype = _I
            lib.jrlqp_struct_factor_config.argtypes = [
                _I, _I, ctypes.POINTER(ctypes.c_int)]
            lib.jrlqp_struct_factor_config.restype = _I
            lib.jrlqp_fast_loop_config.argtypes = [
                _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
            lib.jrlqp_fast_loop_config.restype = _I
            lib.jrlqp_fast_loop_onchip_config.argtypes = [
                _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
            lib.jrlqp_fast_loop_onchip_config.restype = _I
            lib.jrlqp_carry_init_config.argtypes = [
                _I, _I, ctypes.POINTER(ctypes.c_int)]
            lib.jrlqp_carry_init_config.restype = _I
            _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().jrlqp_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def own(t: torch.Tensor, dtype) -> torch.Tensor:
    """A fresh contiguous copy of ``t`` in ``dtype``, for a kernel that
    writes its state in place."""
    return torch.clone(t.to(dtype), memory_format=torch.contiguous_format)
