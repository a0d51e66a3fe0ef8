"""K5 and K7 (the structured factorizations) on one CUDA card: their
launch configuration, their time against the batch, and where a block's
cycles go.

    python3 -m jrlqp_tpu_torch.testing.profile_factor [--parent DIR] [--stamps]

From the repository root. Times K5 and K7 (down) by CUDA events, best of
5, on the IK generator's seed-0 batch (9 robots x 43 dof) at batch 132 (one
problem per SM), one full wave (resident blocks per SM x SMs) and 1024 (the
IK batch). With ``--parent DIR``, DIR holds another version of the
package (``DIR/jrlqp_tpu_torch``, e.g. ``git archive`` of a commit unpacked
under the git-ignored ``build/``), whose K5 and K7 are timed beside this
tree's in turns: parent, this, this, parent. With ``--stamps``,
``csrc/struct_llt.cu`` is built alone with ``-DJRLQP_STAMPS`` (clock64()
stamps by stage; K5 and K7 carry the stamp points) and the mean cycles per
block of each stage are printed at each batch; a parent whose source has no
stamp points (the version before K5 and K7 were redesigned) gets them at
the same stages by ``_OLD_STAMPS``. Builds go under ``build/profile_factor``.
Needs a card; prints the card's name and power limit beside every number.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from ..ops.cuda import _build, block_llt
from .ik_gen import ik_batch

NB, S, IK_BATCH = 9, 43, 1024
OUT = _build.BUILD_DIR.parent / "profile_factor"

# the stages of the stamp points, in order of their index
_STAGES = {
    "K5": ["entry", "K2", "L_i out, S_i in", "S_i L_i^-T",
           "Schur product, D_i+1 in", "step end", "exit"],
    "K7": ["entry", "K2", "L_i out, S_i in", "S_i L_i^-T",
           "B_i out, Schur sum, next D in", "D_last - sum", "exit"],
}
_OLD_STAGES = {
    "K5": ["form a", "K2", "store L_i, L_i^-1", "load S_i", "S_i L_i^-T",
           "store S'_i", "S'_i S'_i^T"],
    "K7": ["form a", "K2", "store L_i, L_i^-1", "load S_i", "S_i L_i^-T",
           "store B_i", "+= B_i B_i^T"],
}
# (line of the old source, stage): a stamp after each line
_OLD_STAMPS = [
    ("      a[e] = D[(long)i * ss + e] - m[e];", 0),
    ("    jrlqp::chol_inv_block(a, s, x, s, s);", 1),
    ("    store_block(LI + (long)i * so, ld, x, s);", 2),
    ("      load_block(S + (long)i * ss, m, ss);", 3),
    ("      mm_nt(m, x, sp, s, true, false);             // S_i L_i^-T", 4),
    ("      store_block(LO + (long)i * so, ld, sp, s);", 5),
    ("      mm_nt(sp, sp, m, s, false, false);           // S'_i S'_i^T", 6),
    ("      a[e] = last ? D[(long)p * ss + e] - acc[e] : D[(long)p * ss + e];",
     0),
    ("      LI[(long)i * ss + e] = x[e];\n    }", 2),
    ("      load_block(S + (long)i * ss, sb, ss);", 3),
    ("      mm_nt(sb, x, bb, s, true, false);            // S_i L_i^-T", 4),
    ("        LO[(long)i * ss + e] = bb[e];", 5),
    ("      mm_nt(bb, bb, acc, s, false, true);          // += B_i B_i^T", 6),
]
_OLD_INIT = ["  for (int e = threadIdx.x; e < ss; e += blockDim.x) m[e] = 0.0f;",
             "  for (int e = threadIdx.x; e < ss; e += blockDim.x) acc[e] = "
             "0.0f;"]
_STAMP_HEADER = """
__device__ unsigned long long factor_stamps[8];
#define FACTOR_STAMP_INIT long long stamp_t = clock64()
#define FACTOR_STAMP(k) do { __syncthreads(); if (threadIdx.x == 0) { \\
  const long long t_ = clock64(); \\
  atomicAdd(&factor_stamps[k], (unsigned long long)(t_ - stamp_t)); \\
  stamp_t = t_; } } while (0)
"""
_STAMP_ENTRY = """
extern "C" int jrlqp_factor_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, factor_stamps, 8 * 8);
  const unsigned long long zero[8] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(factor_stamps, zero, 8 * 8);
  return (int)err;
}
"""


def _old_stamped(src: str) -> str:
    """The old source with the stamp points of _OLD_STAMPS."""
    for line in _OLD_INIT:
        assert src.count(line + "\n") == 1, line
        src = src.replace(line + "\n", line + "\n  FACTOR_STAMP_INIT;\n")
    for line, k in _OLD_STAMPS:
        n = src.count(line + "\n")
        assert n in (1, 2), (line, n)
        src = src.replace(line + "\n", f"{line}\n    FACTOR_STAMP({k});\n")
    head = '#include "block_llt.cuh"\n'
    return src.replace(head, head + _STAMP_HEADER) + _STAMP_ENTRY


def _stamp_library(pkg: Path, name: str):
    """struct_llt.cu of the package at ``pkg`` built alone with stamps."""
    src = (pkg / "csrc" / "struct_llt.cu").read_text()
    new = "JRLQP_STAMPS" in src
    work = OUT / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    shutil.copy(pkg / "csrc" / "block_llt.cuh", work)
    (work / "struct_llt.cu").write_text(src if new else _old_stamped(src))
    lib_path = work / "libstamps.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DJRLQP_STAMPS",
                    "-shared", "-o", str(lib_path),
                    str(work / "struct_llt.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for entry in ("jrlqp_tri_block_llt", "jrlqp_block_arrow_llt"):
        getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
    lib.jrlqp_factor_stamps.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    return lib, (_STAGES if new else _OLD_STAGES)


def _package_library(root: Path, name: str):
    """The kernels' library of the package at ``root/jrlqp_tpu_torch``,
    built by that package's own `_build` module."""
    spec = importlib.util.spec_from_file_location(
        name, root / "jrlqp_tpu_torch" / "ops" / "cuda" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def _runners(lib, diag, off):
    """(K5, K7) of the C entries of ``lib`` on (diag, off), outputs in the
    layouts the wrappers allocate (K5 rows of round4(s) floats)."""
    B, nb, s, _ = diag.shape
    sp = (s + 3) // 4 * 4
    dev = diag.device
    k5_out = [torch.empty((B, n, s, sp), device=dev)
              for n in (nb, nb - 1, nb)]
    k7_out = [torch.empty_like(diag), torch.empty_like(off),
              torch.empty_like(diag)]

    def k5():
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.jrlqp_tri_block_llt(
            diag.data_ptr(), off.data_ptr(), *(t.data_ptr() for t in k5_out),
            B, nb, s, ctypes.c_void_p(stream)), "K5")

    def k7():
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.jrlqp_block_arrow_llt(
            diag.data_ptr(), off.data_ptr(), *(t.data_ptr() for t in k7_out),
            B, nb, s, 0, ctypes.c_void_p(stream)), "K7")
    return {"K5": k5, "K7": k7}


def _cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_factor: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = {k: block_llt.factor_config(e, S) for k, e in (
        ("K5", "jrlqp_tri_block_llt"), ("K7", "jrlqp_block_arrow_llt"))}
    print(f"launch configuration at s={S} ({card}): {cfg}")
    waves = sorted({132, IK_BATCH} | {c["blocks_per_sm"] * sms
                                     for c in cfg.values()})
    ik = ik_batch(max(waves), NB, S, 4, seed=0)
    dev = torch.device("cuda", 0)
    diag_all = torch.from_numpy(ik["diag"]).to(dev, torch.float32)
    off_all = torch.from_numpy(ik["off"]).to(dev, torch.float32)
    libs = {"this tree": _build.library()}
    if args.parent is not None:
        libs["parent"] = _package_library(args.parent.resolve(),
                                          "parent_build")
    order = (["parent", "this tree", "this tree", "parent"]
             if args.parent is not None else ["this tree", "this tree"])
    for B in waves:
        diag = diag_all[:B].contiguous()
        off = off_all[:B].contiguous()
        runs = {k: _runners(v, diag, off) for k, v in libs.items()}
        for kern in ("K5", "K7"):
            ms = [(who, _cuda_ms(runs[who][kern])) for who in order]
            print(f"{kern} at batch {B} ({card}): "
                  + ", ".join(f"{who} {t!r} ms" for who, t in ms))
    if args.stamps:
        stamped = {"this tree": Path(block_llt.__file__).parents[2]}
        if args.parent is not None:
            stamped["parent"] = args.parent.resolve() / "jrlqp_tpu_torch"
        for who, pkg in stamped.items():
            lib, stages = _stamp_library(pkg, who.replace(" ", "_"))
            for B in waves:
                diag = diag_all[:B].contiguous()
                off = off_all[:B].contiguous()
                run = _runners(lib, diag, off)
                out = (ctypes.c_ulonglong * 8)()
                _build.check(lib.jrlqp_factor_stamps(out), "stamps")
                for kern in ("K5", "K7"):
                    run[kern]()
                    torch.cuda.synchronize()
                    _build.check(lib.jrlqp_factor_stamps(out), "stamps")
                    per = {name: round(out[k] / B)
                           for k, name in enumerate(stages[kern])}
                    print(f"stamps, {who}, {kern} at batch {B}, mean cycles "
                          f"per block ({card}): {per}, total "
                          f"{sum(per.values())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
