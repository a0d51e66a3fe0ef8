"""ctypes binding of the host C++ QPS parser and IK-matrix reader.

Counterpart of :mod:`jrlqp_tpu.io.native`, on the port's own copies of the
sources (``jrlqp_tpu_torch/csrc/host/qps_parser.cpp`` and
``ikmat_reader.cpp``, the C interface of ``native/``). The library is built
at first use by ``g++ -O2 -std=c++17 -fPIC -shared`` into
``build/jrlqp_tpu_torch/native/`` beside the package, named by a hash of
the sources and the flags, so an edited source is rebuilt and an unchanged
one is loaded as is. The build holds a file lock and writes under a
temporary name that ``os.replace`` moves into place, so processes that
start at once build it once and none loads half a file.

:func:`available` says whether the library could be built and loaded;
:func:`jrlqp_tpu_torch.io.qps.read_qps` falls back to the Python parser
otherwise (``engine="auto"``). Both give the same arrays bit for bit.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "parse_qps_native", "parse_ikpb_native",
           "parse_mat_native"]

_PKG = Path(__file__).resolve().parents[1]          # jrlqp_tpu_torch/
HOST_SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG.parent / "build" / "jrlqp_tpu_torch" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None
# path of the loaded library, whether this process compiled it, and the
# seconds its compile took
build_info: dict = {}


class _IKPbResultC(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int32),
        ("me", ctypes.c_int32),
        ("mi", ctypes.c_int32),
        ("Q", ctypes.POINTER(ctypes.c_double)),
        ("c", ctypes.POINTER(ctypes.c_double)),
        ("A", ctypes.POINTER(ctypes.c_double)),
        ("b", ctypes.POINTER(ctypes.c_double)),
        ("C", ctypes.POINTER(ctypes.c_double)),
        ("d", ctypes.POINTER(ctypes.c_double)),
        ("xmin", ctypes.POINTER(ctypes.c_double)),
        ("xmax", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char_p),
    ]


class _MatResultC(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int32),
        ("cols", ctypes.c_int32),
        ("data", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char_p),
    ]


class _QPSResultC(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int32),
        ("m", ctypes.c_int32),
        ("n_eq", ctypes.c_int32),
        ("objcst", ctypes.c_double),
        ("G", ctypes.POINTER(ctypes.c_double)),
        ("a", ctypes.POINTER(ctypes.c_double)),
        ("C", ctypes.POINTER(ctypes.c_double)),
        ("l", ctypes.POINTER(ctypes.c_double)),
        ("u", ctypes.POINTER(ctypes.c_double)),
        ("xl", ctypes.POINTER(ctypes.c_double)),
        ("xu", ctypes.POINTER(ctypes.c_double)),
        ("name", ctypes.c_char_p),
        ("error", ctypes.c_char_p),
    ]


def _sources() -> list[Path]:
    return sorted(HOST_SRC.glob("*.cpp"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libjrlqp_native_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """The library's path, compiled first if no process has built it."""
    out = _library_path()
    if out.exists():
        build_info.update(path=str(out), built=False, seconds=0.0)
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():            # another process built it meanwhile
            build_info.update(path=str(out), built=False, seconds=0.0)
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                               *map(str, _sources())],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    build_info.update(path=str(out), built=True,
                      seconds=time.perf_counter() - t0)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for parse, free, res in (
            (lib.qps_parse, lib.qps_free, _QPSResultC),
            (lib.jrlqp_parse_ikpb, lib.jrlqp_free_ikpb, _IKPbResultC),
            (lib.jrlqp_parse_mat, lib.jrlqp_free_mat, _MatResultC)):
        parse.restype = ctypes.POINTER(res)
        parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        free.restype = None
        free.argtypes = [ctypes.POINTER(res)]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on the first call; None if it cannot be
    built or loaded (the reason stays in ``_load_error``)."""
    global _lib, _load_error
    with _lock:
        if _lib is None and _load_error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(_build())))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _load_error = str(e)
    return _lib


def available() -> bool:
    """True where the native library is built and loaded."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native readers not available: {_load_error}")
    return lib


def _as_array(ptr, *shape) -> np.ndarray:
    count = int(np.prod(shape)) if shape else 0
    if count == 0:
        return np.zeros(shape)
    return np.ctypeslib.as_array(ptr, shape=(count,)).reshape(shape).copy()


def parse_qps_native(text: str, name: str = ""):
    """Parse QPS text with the native parser; returns a
    :class:`jrlqp_tpu_torch.io.qps.QPSData`. Raises ValueError on malformed
    input, as the Python parser does."""
    from .qps import QPSData

    lib = _require()
    raw = text.encode()
    resp = lib.qps_parse(raw, len(raw))
    try:
        res = resp.contents
        if res.error:
            raise ValueError(res.error.decode())
        n, m = res.n, res.m
        xl, xu = _as_array(res.xl, n), _as_array(res.xu, n)
        return QPSData(
            name=(res.name.decode() if res.name else "") or name,
            G=_as_array(res.G, n, n), a=_as_array(res.a, n),
            C=_as_array(res.C, m, n), l=_as_array(res.l, m),
            u=_as_array(res.u, m), xl=xl, xu=xu,
            objcst=float(res.objcst),
            n_eq=int(res.n_eq),
            use_bounds=bool(np.any(xl > -np.inf) or np.any(xu < np.inf)),
            has_fixed_variables=bool(np.any(xl == xu)),
        )
    finally:
        lib.qps_free(resp)


def parse_ikpb_native(text: str):
    """Parse a composite MultiIK problem file with the native reader;
    returns a :class:`jrlqp_tpu_torch.io.ikmat.IKProblem`. Same contract as
    :func:`jrlqp_tpu_torch.io.ikmat.read_ik_pb`."""
    from .ikmat import IKProblem

    lib = _require()
    raw = text.encode()
    resp = lib.jrlqp_parse_ikpb(raw, len(raw))
    try:
        res = resp.contents
        if res.error:
            raise ValueError(res.error.decode())
        n, me, mi = res.n, res.me, res.mi
        return IKProblem(
            Q=_as_array(res.Q, n, n),
            c=_as_array(res.c, n),
            A=_as_array(res.A, me, n) if me else np.zeros((0, n)),
            b=_as_array(res.b, me) if me else np.zeros((0,)),
            C=_as_array(res.C, mi, n) if mi else np.zeros((0, n)),
            d=_as_array(res.d, mi) if mi else np.zeros((0,)),
            x_min=_as_array(res.xmin, n),
            x_max=_as_array(res.xmax, n),
        )
    finally:
        lib.jrlqp_free_ikpb(resp)


def parse_mat_native(text: str) -> np.ndarray:
    """Parse a plain whitespace matrix file with the native reader."""
    lib = _require()
    raw = text.encode()
    resp = lib.jrlqp_parse_mat(raw, len(raw))
    try:
        res = resp.contents
        if res.error:
            raise ValueError(res.error.decode())
        return _as_array(res.data, res.rows, res.cols)
    finally:
        lib.jrlqp_free_mat(resp)
