"""K10, the J/R engine's loop as one CUDA kernel (``ops/cuda/jr_kernel.py``,
``csrc/jr_kernel.cu``), on the CPU: its plain version
``dense.jr_loop_plain`` against the pass loop that ``run_loop`` ran before
K10 (bit for bit, the whole state), the port's ``solve_batch`` against the
JAX package's on the same lane kinds (status, iterations and active set
equal, x and the multipliers within 1e-10 in f64: the same algorithm in
another summation order), the dispatch of ``run_loop``, the C entry
points' signatures, and the bound's counts. Inputs are numpy draws from a
seed. Tests/test_torch_card.py holds K10 against the plain version on a
card."""
import ctypes
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import QPProblem as JQP
from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu import solve_batch as j_solve_batch
from jrlqp_tpu_torch import (
    SolverOptions,
    TerminationStatus,
    problem_from_numpy,
    solve_batch,
)
from jrlqp_tpu_torch.ops.cuda import _build, jr_kernel
from jrlqp_tpu_torch.solver import dense
from jrlqp_tpu_torch.types import MAX_ITER_REACHED, RUNNING
from jrlqp_tpu_torch.utils import spans

torch.set_num_threads(1)

j_solve_batch_jit = jax.jit(j_solve_batch, static_argnames=("opt",))
TS = TerminationStatus
CSRC = pathlib.Path(__file__).resolve().parents[1] / "jrlqp_tpu_torch" / "csrc"


def np_batch(seed, batch, n, m, act_frac):
    """G = A A^T / n + I, bounds around C x0 for an interior x0 with the
    first act_frac min(n, m) rows tight, no variable bounds."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, n, n))
    G = A @ A.transpose(0, 2, 1) / n + np.eye(n)
    C = rng.standard_normal((batch, m, n))
    x0 = rng.uniform(-1.0, 1.0, (batch, n))
    cx = np.einsum("bij,bj->bi", C, x0)
    tight = np.arange(m) < int(act_frac * min(n, m))
    return dict(G=0.5 * (G + G.transpose(0, 2, 1)),
                a=rng.standard_normal((batch, n)), C=C,
                l=cx - np.where(tight, 0.0, 3.0 * rng.uniform(0.01, 1.0,
                                                              (batch, m))),
                u=cx + 3.0 * rng.uniform(0.01, 1.0, (batch, m)),
                xl=np.full((batch, n), -np.inf),
                xu=np.full((batch, n), np.inf))


def axis_lane(n, m, kind):
    """One lane with G = I whose arithmetic is exact: "infeasible" (row 0
    x_0 >= 1 against row 1 x_0 <= -1, or the bound x_0 <= -1 when m = 1)
    or "dependent" (the bound x_0 >= 0 active, then row 0, 0.1 x_0 >= 0.05,
    whose normal is the bound's: a full step with zero_z_threshold < 0 ends
    LINEAR_DEPENDENCY_DETECTED)."""
    d = dict(G=np.eye(n)[None], a=np.zeros((1, n)), C=np.zeros((1, m, n)),
             l=np.full((1, m), -np.inf), u=np.full((1, m), np.inf),
             xl=np.full((1, n), -np.inf), xu=np.full((1, n), np.inf))
    if kind == "infeasible":
        d["C"][0, 0, 0] = 1.0
        d["l"][0, 0] = 1.0
        if m > 1:
            d["C"][0, 1, 0] = 1.0
            d["u"][0, 1] = -1.0
        else:
            d["xu"][0, 0] = -1.0
    else:
        d["a"][0, 0] = 1.0
        d["xl"][0, 0] = 0.0
        d["C"][0, 0, 0] = 0.1
        d["l"][0, 0] = 0.05
    return d


def cat(*batches):
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def _eq_fixed(d):
    d["l"][::2, 0] = d["u"][::2, 0]         # even lanes: an equality row
    d["xl"][1::3, 2] = d["xu"][1::3, 2] = 0.3   # a fixed variable


def _boxed(d):
    d["xl"][:] = -0.6
    d["xu"][:] = 0.6


# name: (batch maker, options); every case's lanes stop at different passes
CASES = {
    "adds": (lambda: np_batch(0, 8, 8, 12, 0.4), {}),
    "removals": (lambda: np_batch(1, 8, 6, 24, 0.9), {}),
    "equalities": (lambda: dict(np_batch(2, 6, 9, 6, 0.4)), {}),
    "boxed": (lambda: np_batch(3, 6, 7, 10, 0.5), {}),
    "infeasible": (lambda: cat(np_batch(4, 3, 6, 4, 0.5),
                               axis_lane(6, 4, "infeasible")), {}),
    "dependent": (lambda: cat(np_batch(5, 3, 5, 3, 0.5),
                              axis_lane(5, 3, "dependent")),
                  {"zero_z_threshold": -1.0}),
    "max_iter": (lambda: cat(np_batch(6, 6, 8, 16, 0.9),
                             axis_lane(8, 16, "infeasible")),
                 {"max_iter": 4}),
    "vertex": (lambda: np_batch(7, 8, 3, 12, 1.0), {}),
    "no_rows": (lambda: np_batch(8, 4, 5, 0, 0.0), {}),
}
_EDITS = {"equalities": _eq_fixed, "boxed": _boxed, "no_rows": _boxed}


def make(name, dtype=np.float64):
    """(numpy arrays, option keywords) of a case."""
    maker, kw = CASES[name]
    d = maker()
    if name in _EDITS:
        _EDITS[name](d)
    return {k: v.astype(dtype) for k, v in d.items()}, kw


def loop_before_k10(pb, state, opt):
    """``run_loop`` as it was before K10, without hooks: the masked pass of
    ``gi_iteration`` in a host loop while a lane is RUNNING."""
    while True:
        capped = (state.term == RUNNING) & (state.it >= opt.max_iter)
        state = dataclasses.replace(state, term=torch.where(
            capped, MAX_ITER_REACHED, state.term).to(torch.int32))
        if not bool((state.term == RUNNING).any()):
            return state
        state = dense.gi_iteration(pb, state, opt)


def assert_states_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name


def _options(dtype, kw):
    if dtype == np.float32:
        kw = {"zero_z_threshold": 1e-6, **kw}
    return SolverOptions(dtype=torch.float32 if dtype == np.float32
                         else torch.float64, **kw)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(CASES))
def test_jr_loop_plain_is_the_loop_before_k10(name, dtype):
    d, kw = make(name, dtype)
    pb = problem_from_numpy(**d, device="cpu")
    opt = _options(dtype, kw)
    st0 = dense.init_state(pb, opt)
    # what the case covers, seen pass by pass
    seen = {"removal": False, "q_eq_n": False}

    def watch(before, after):
        run = before.term == RUNNING
        seen["removal"] |= bool((run & (after.q < before.q)).any())
        seen["q_eq_n"] |= bool((after.q == pb.n).any())

    ref = loop_before_k10(pb, st0, opt)
    assert_states_equal(dense.jr_loop_plain(pb, st0, opt), ref)
    assert_states_equal(dense.run_loop(pb, st0, opt), ref)
    assert_states_equal(dense.run_loop(pb, st0, opt, on_pass=watch), ref)
    assert len(set(ref.it.tolist())) > 1          # stops at different passes
    term = set(ref.term.tolist())
    want = {"removals": lambda: seen["removal"],
            "equalities": lambda: bool((st0.q > 0).any()),
            "infeasible": lambda: TS.INFEASIBLE in term,
            "dependent": lambda: TS.LINEAR_DEPENDENCY_DETECTED in term,
            "max_iter": lambda: TS.MAX_ITER_REACHED in term,
            "vertex": lambda: seen["q_eq_n"]}
    if name in want:
        assert want[name](), f"{name}: the case does not cover its kind"


@pytest.mark.parametrize("name", list(CASES))
def test_solve_batch_matches_jax_on_the_lane_kinds(name):
    d, kw = make(name)
    ours = solve_batch(problem_from_numpy(**d, device="cpu"),
                       SolverOptions(**kw))
    ref = j_solve_batch_jit(JQP(**{k: jnp.asarray(v) for k, v in d.items()},
                                objcst=jnp.zeros(len(d["a"]))),
                            JOptions(**kw))
    np.testing.assert_array_equal(ours.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(ours.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(ours.active_set.numpy(),
                                  np.asarray(ref.active_set))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(ours.multipliers.numpy(),
                               np.asarray(ref.multipliers), rtol=0,
                               atol=1e-10)


def test_cpu_dispatch_runs_the_plain_version(monkeypatch):
    d, _ = make("removals")
    pb = problem_from_numpy(**d, device="cpu")
    opt = SolverOptions()
    st0 = dense.init_state(pb, opt)
    calls = []
    orig = dense.jr_loop_plain

    def plain(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr(dense, "jr_loop_plain", plain)
    spans.reset("launch.K10")
    out = dense.run_loop(pb, st0, opt)
    solve_batch(pb, opt)
    assert calls == [1, 1] and spans.counter("launch.K10") == 0
    assert_states_equal(out, loop_before_k10(pb, st0, opt))


@pytest.mark.parametrize("hook", ["select_fn", "step_fn", "on_pass"])
def test_hooks_run_the_pass_loop(monkeypatch, hook):
    d, _ = make("removals")
    pb = problem_from_numpy(**d, device="cpu")
    opt = SolverOptions()
    st0 = dense.init_state(pb, opt)

    def no_k10(*args):
        raise AssertionError("the hooked loop reached K10's dispatch")

    monkeypatch.setattr(dense, "jr_loop", no_k10)
    fn = {"select_fn": dense._select_violated,
          "step_fn": dense._compute_step,
          "on_pass": lambda before, after: None}[hook]
    assert_states_equal(dense.run_loop(pb, st0, opt, **{hook: fn}),
                        loop_before_k10(pb, st0, opt))


def test_jr_loop_raises_on_a_device_without_kernel():
    d, _ = make("adds")
    pb = problem_from_numpy(**d, device="cpu")
    st0 = dense.init_state(pb, SolverOptions())
    meta = dataclasses.replace(st0, x=st0.x.to("meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        dense.run_loop(pb, meta, SolverOptions())


def _c_params(entry):
    """The parameter kinds of an extern "C" entry point of jr_kernel.cu:
    P for a pointer, I for an int, D for a double."""
    src = (CSRC / "jr_kernel.cu").read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
                    re.S).group(1)
    kinds = []
    for p in sig.split(","):
        p = p.strip()
        kinds.append("P" if "*" in p else "D" if p.startswith("double")
                     else "I" if p.startswith("int") else "?")
    return kinds


@pytest.mark.parametrize("entry", ["jrlqp_jr_loop_f64", "jrlqp_jr_loop_f32"])
def test_k10_entry_points_are_declared(entry):
    # the ctypes signature the build binds, against the C source; needs no
    # nvcc
    kinds = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_double: "D"}
    sig = [kinds[t] for t in _build._SIGNATURES[entry]]
    assert sig == ["P"] * 13 + ["I"] * 4 + ["D"] * 2 + ["P"]
    assert _c_params(entry) == sig


def test_k10_bound_counts():
    # one lane, 3 iterations from q = 0 to q = 2 at (n, m) = (4, 5): per
    # iteration 2mn + 2n^2 + 6n(n - q) + q^2 at q = 1
    one = torch.tensor([3])
    assert jr_kernel.jr_flops(one, torch.tensor([0]), torch.tensor([2]), 4,
                              5) == 3 * (40 + 32 + 72 + 1)
    # problem 8 (20 + 10 + 8), state 2 (8 (32 + 8 + 2) + 4 (5 + 8 + 6))
    assert jr_kernel.jr_bytes(2, 4, 5, 8) == 2 * (8 * 38 + 2 * (8 * 42 + 76))
