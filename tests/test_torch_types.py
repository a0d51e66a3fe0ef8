"""The port's foundation: enums, options, the numpy carry-over, the device
dispatch rule, and its independence from JAX."""
import dataclasses
import io
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jrlqp_tpu.types as jt
import jrlqp_tpu_torch.types as tt
from jrlqp_tpu_torch import problem_from_numpy, result_to_numpy
from jrlqp_tpu_torch.ops.cuda import block_llt, gi_kernel

torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parents[1] / "jrlqp_tpu_torch"


@pytest.mark.parametrize("name", ["ActivationStatus", "TerminationStatus"])
def test_enum_values_match_jax(name):
    ours = {e.name: int(e) for e in getattr(tt, name)}
    ref = {e.name: int(e) for e in getattr(jt, name)}
    assert ours == ref


def test_solver_options_fields_match_jax():
    ours = {f.name for f in dataclasses.fields(tt.SolverOptions)}
    ref = {f.name for f in dataclasses.fields(jt.SolverOptions)}
    assert ours == ref
    assert tt.SolverOptions().dtype == torch.float64
    assert tt.SolverOptions().with_(max_iter=7).max_iter == 7


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_numpy_round_trip_is_bitwise(dtype):
    rng = np.random.default_rng(3)
    B, n, m = 3, 5, 4
    arrs = dict(
        G=rng.standard_normal((B, n, n)), a=rng.standard_normal((B, n)),
        C=rng.standard_normal((B, m, n)), l=rng.standard_normal((B, m)),
        u=rng.standard_normal((B, m)), xl=np.full((B, n), -np.inf),
        xu=np.full((B, n), np.inf), objcst=rng.standard_normal(B))
    arrs["u"][1, 2] = np.inf
    arrs["xl"][0, 1] = -0.5
    arrs = {k: v.astype(dtype) for k, v in arrs.items()}
    pb = problem_from_numpy(**arrs, device="cpu")
    assert pb.batch == B and pb.n == n and pb.m == m
    back = result_to_numpy(pb)
    for k, v in arrs.items():
        assert back[k].dtype == v.dtype
        assert back[k].tobytes() == v.tobytes(), k


def test_no_jax_import_in_port_sources():
    # neither jax nor the JAX package (whose __init__ imports jax)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jrlqp_tpu)(\.|\s|$)")
    offenders = [
        f"{p.relative_to(PKG)}: {line.strip()}" for p in PKG.rglob("*.py")
        for line in p.read_text().splitlines() if pattern.match(line)
    ]
    assert offenders == []


def test_importing_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import jrlqp_tpu_torch.solver.fast, jrlqp_tpu_torch.testing.kkt, "
            "jrlqp_tpu_torch.testing.batch_gen, jrlqp_tpu_torch.utils, "
            "jrlqp_tpu_torch.solver.dense, jrlqp_tpu_torch.solver.warm_start, "
            "jrlqp_tpu_torch.structured, jrlqp_tpu_torch.ops.linalg, "
            "jrlqp_tpu_torch.io, jrlqp_tpu_torch.parallel, "
            "jrlqp_tpu_torch.parallel.distributed, "
            "jrlqp_tpu_torch.solver.box_single, jrlqp_tpu_torch.solver.mixed, "
            "jrlqp_tpu_torch.bench, jrlqp_tpu_torch.io.ikmat, "
            "jrlqp_tpu_torch.io.native, jrlqp_tpu_torch.reference_impl; "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jrlqp_tpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(PKG.parent)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_wrappers_raise_on_a_device_without_kernel():
    A = torch.eye(8, device="meta").expand(2, 8, 8)
    with pytest.raises(RuntimeError, match="no kernel"):
        block_llt.chol_inv_b(A)
    pb = problem_from_numpy(
        G=np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
        a=np.zeros((2, 3), np.float32), C=np.zeros((2, 1, 3), np.float32),
        l=np.zeros((2, 1), np.float32), u=np.ones((2, 1), np.float32),
        xl=np.zeros((2, 3), np.float32), xu=np.ones((2, 3), np.float32),
        device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        gi_kernel.run_loop_fused(pb, 10)


def test_wrappers_check_dtype():
    with pytest.raises(TypeError):
        block_llt.chol_inv_b(torch.eye(4, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        block_llt.chol_inv_b(torch.zeros((2, 3, 4)))


def test_default_device_is_the_card():
    # without a device argument a problem goes to the card: here, with no
    # card, that raises instead of landing on the CPU (tests/
    # test_torch_card.py checks cuda:0 on a machine with one)
    from jrlqp_tpu_torch.structured import GType, structured_from_numpy

    arrs = dict(G=np.eye(2)[None], a=np.zeros((1, 2)), C=np.ones((1, 1, 2)),
                l=np.zeros((1, 1)), u=np.ones((1, 1)), xl=np.zeros((1, 2)),
                xu=np.ones((1, 2)))
    blocks = dict(diag=np.eye(2)[None, None], off=np.zeros((1, 0, 2, 2)),
                  gtype=GType.TRI_BLOCK_DIAGONAL, blocks=np.ones((1, 1, 1, 2)))
    from jrlqp_tpu_torch.bench import bench_box_single, bench_size_sweep
    from jrlqp_tpu_torch.io import run_corpus
    from jrlqp_tpu_torch.io.maros_meszaros import MAROS_MESZAROS
    from jrlqp_tpu_torch.parallel import make_mesh

    qps_dir = str(PKG.parent / "tests" / "data" / "qps")
    hs21 = [e for e in MAROS_MESZAROS if e.name == "hs21"]
    if torch.cuda.is_available():
        assert problem_from_numpy(**arrs).G.device.type == "cuda"
        assert structured_from_numpy(**blocks)[0].diag.device.type == "cuda"
        assert make_mesh().devices == tuple(
            torch.device("cuda", i) for i in range(torch.cuda.device_count()))
        assert run_corpus(qps_dir=qps_dir, entries=hs21)[0]["obj_ok"]
        assert bench_size_sweep(sizes=(4,), batch=2,
                                solver="pallas")[0].success_rate == 1.0
        return
    with pytest.raises((AssertionError, RuntimeError)):
        problem_from_numpy(**arrs)
    with pytest.raises((AssertionError, RuntimeError)):
        structured_from_numpy(**blocks)
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises((AssertionError, RuntimeError)):
        run_corpus(qps_dir=qps_dir, entries=hs21)
    with pytest.raises((AssertionError, RuntimeError)):
        bench_size_sweep(sizes=(4,), batch=2)
    with pytest.raises((AssertionError, RuntimeError)):
        bench_box_single(n=2, batch=2)
    assert problem_from_numpy(**arrs, device="cpu").G.device.type == "cpu"
    assert run_corpus(qps_dir=qps_dir, entries=hs21,
                      device="cpu")[0]["obj_ok"]


def test_host_readers_and_spec_return_numpy():
    # the IK and QPS readers, native or not, and the numpy spec make no
    # tensor: nothing they return lands on a device
    from jrlqp_tpu_torch.io import ikmat, native, read_qps
    from jrlqp_tpu_torch.reference_impl import solve_np

    qps = PKG.parent / "tests" / "data" / "qps" / "HS21.QPS"
    for engine in ("python", "native"):
        d = read_qps(str(qps), engine=engine)
        assert all(isinstance(getattr(d, k), np.ndarray)
                   for k in ("G", "a", "C", "l", "u", "xl", "xu"))
    assert isinstance(ikmat.read_mat(io.StringIO("1 2\n3 4\n")), np.ndarray)
    assert isinstance(native.parse_mat_native("1 2\n3 4\n"), np.ndarray)
    res = solve_np(np.eye(2), np.ones(2), np.ones((1, 2)), [-1.0], [1.0])
    assert isinstance(res.x, np.ndarray) and res.status == 0
