"""K11, the explicit-form engine's loop as one CUDA kernel
(``ops/cuda/fast_loop.py``, ``csrc/fast_loop.cu``), on the CPU: its plain
version ``fast.fast_loop_plain`` against the pass loop that ``_run_loop``
ran before K11 (bit for bit, the whole state) from cold, warm-hint,
carried and pending-candidate states; the port's ``solve_fast``,
``solve_refined`` and ``solve_structured_fast_batch`` against the JAX
package's jitted counterparts on the same draws (status, iterations and
active set equal; x within 1e-10 in f64 and 1e-5 in f32: the same
algorithm in another summation order); the dispatch of ``_run_loop``; the
C entry points' signatures; and the bound's counts. Inputs are numpy draws
from a seed. tests/test_torch_card.py holds K11 against the plain version
on a card."""
import ctypes
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.solver import fast as jfast
from jrlqp_tpu.structured import solver as js
from jrlqp_tpu_torch import (
    SolverOptions,
    TerminationStatus,
    problem_from_numpy,
    solve_fast,
)
from jrlqp_tpu_torch.ops.cuda import _build, fast_loop
from jrlqp_tpu_torch.solver import dense, fast
from jrlqp_tpu_torch.structured import (
    GType,
    solve_structured_fast_batch,
    solve_structured_fast_carry,
)
from jrlqp_tpu_torch.testing import fast_parting
from jrlqp_tpu_torch.testing.ik_gen import ik_batch, ik_step
from jrlqp_tpu_torch.types import MAX_ITER_REACHED, RUNNING
from jrlqp_tpu_torch.utils import spans
from test_torch_gi_kernel import jax_problem
from test_torch_jr_kernel import CASES, make
from test_torch_structured import _args, _assert_same, _jax_args

torch.set_num_threads(1)

TS = TerminationStatus
CSRC = pathlib.Path(__file__).resolve().parents[1] / "jrlqp_tpu_torch" / "csrc"
F32, F64 = torch.float32, torch.float64
j_fast = jax.jit(jax.vmap(jfast.solve_fast, in_axes=(0, None)),
                 static_argnums=1)


def loop_before_k11(pb, state, opt, on_pass=None):
    """``_run_loop`` as it was before K11: the masked pass of
    ``fast_iteration`` in a host loop while a lane is RUNNING."""
    while True:
        capped = (state.term == RUNNING) & (state.it >= opt.max_iter)
        state = dataclasses.replace(state, term=torch.where(
            capped, MAX_ITER_REACHED, state.term).to(torch.int32))
        if not bool((state.term == RUNNING).any()):
            return state
        nxt = fast.fast_iteration(pb, state, opt)
        if on_pass is not None:
            on_pass(state, nxt)
        state = nxt


def assert_states_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name


def dependent_lane(dtype):
    """One lane with G = I (n = 2) that ends LINEAR_DEPENDENCY_DETECTED in
    the explicit-form engine: x_0 is fixed at 0, then the row (1, eps) x >=
    eps / 2 is violated with z = H n+ = (0, eps), a full step (x_0 cannot
    be removed) whose delta = eps^2 is below dep_eps hscale |n+|^2."""
    eps = 1e-4 if dtype == np.float32 else 1e-7
    d = dict(G=np.eye(2)[None], a=np.zeros((1, 2)), C=np.zeros((1, 1, 2)),
             l=np.full((1, 1), 0.5 * eps), u=np.full((1, 1), np.inf),
             xl=np.array([[0.0, -np.inf]]), xu=np.array([[0.0, np.inf]]))
    d["C"][0, 0] = (1.0, eps)
    return {k: v.astype(dtype) for k, v in d.items()}


def _options(dtype, **kw):
    if dtype == np.float32:
        kw = {"zero_z_threshold": 1e-6, **kw}
    return SolverOptions(dtype=F32 if dtype == np.float32 else F64, **kw)


KINDS = list(CASES) + ["fast_dependent"]


def _case(name, dtype):
    """(problem, options, numpy arrays) of a lane kind."""
    if name == "fast_dependent":
        d, kw = dependent_lane(dtype), {}
    else:
        d, kw = make(name, dtype)
    return problem_from_numpy(**d, device="cpu"), _options(dtype, **kw), d


def _pending(pb, opt):
    """A state in which some lane holds a pending candidate: the loop
    capped at the first cap that leaves a lane MAX_ITER_REACHED after a
    partial step, those lanes set RUNNING again."""
    st0 = fast._init_fast(pb, opt)
    for cap in range(1, 20):
        mid = loop_before_k11(pb, st0, opt.with_(max_iter=cap))
        capped = mid.term == MAX_ITER_REACHED
        if bool((capped & mid.skip1).any()):
            return dataclasses.replace(mid, term=torch.where(
                capped, RUNNING, mid.term).to(torch.int32))
    raise AssertionError("no lane stops on a pending candidate")


def _init_state(init, dtype):
    """(problem, options, state) of an init kind, on the removals case
    (act_frac 0.9): "warm" the hint init from the solved active set with
    a slot dropped and one added per lane, "carry" the carried operators
    on the bounds shifted by 0.05, "pending" a pending candidate resumed
    uncapped, "pending_cap5" the same state under a cap of 5."""
    pb, opt, d = _case("removals", dtype)
    if init == "warm":
        opt = opt.with_(warm_start=True)
        hints = loop_before_k11(pb, fast._init_fast(pb, opt), opt).status
        hints = hints.clone()
        hints[::2, 0] = 0
        hints[1::2, pb.m + 1] = 4          # LOWER_BOUND
        return pb, opt, fast._init_fast_warm(pb, hints, opt)
    if init == "carry":
        done = loop_before_k11(pb, fast._init_fast(pb, opt), opt)
        shift = np.random.default_rng(9).standard_normal(d["l"].shape)
        d2 = dict(d, l=d["l"] + 0.05 * shift, u=d["u"] + 0.05 * shift)
        pb2 = problem_from_numpy(**{k: v.astype(dtype) for k, v in d2.items()},
                                 device="cpu")
        return pb2, opt, fast._init_fast_from_carry(
            pb2, done.H, done.Ns, done.status, done.aorder, done.q)
    state = _pending(pb, opt)
    if init == "pending_cap5":
        opt = opt.with_(max_iter=int(state.it.max()) + 5)
    return pb, opt, state


def _check_plain(pb, opt, st0):
    seen = {"removal": False}

    def watch(before, after):
        run = before.term == RUNNING
        seen["removal"] |= bool((run & (after.q < before.q)).any())

    ref = loop_before_k11(pb, st0, opt)
    assert_states_equal(fast.fast_loop_plain(pb, st0, opt), ref)
    assert_states_equal(fast._run_loop(pb, st0, opt), ref)
    assert_states_equal(fast._run_loop(pb, st0, opt, on_pass=watch), ref)
    return ref, seen


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", KINDS)
def test_fast_loop_plain_is_the_loop_before_k11(name, dtype):
    pb, opt, _ = _case(name, dtype)
    st0 = fast._init_fast(pb, opt)
    ref, seen = _check_plain(pb, opt, st0)
    term = set(ref.term.tolist())
    want = {"removals": lambda: seen["removal"],
            "equalities": lambda: bool((st0.q > 0).any()),
            "infeasible": lambda: TS.INFEASIBLE in term,
            "fast_dependent": lambda: TS.LINEAR_DEPENDENCY_DETECTED in term,
            "max_iter": lambda: TS.MAX_ITER_REACHED in term,
            "vertex": lambda: bool((ref.q == pb.n).any())}
    if name in want:
        assert want[name](), f"{name}: the case does not cover its kind"


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("init", ["warm", "carry", "pending",
                                  "pending_cap5"])
def test_fast_loop_plain_from_each_init(init, dtype):
    pb, opt, st0 = _init_state(init, dtype)
    ref, _ = _check_plain(pb, opt, st0)
    if init.startswith("pending"):
        assert bool(st0.skip1.any())
    if init == "pending_cap5":
        assert TS.MAX_ITER_REACHED in set(ref.term.tolist())
    if init == "warm":
        assert int(st0.q.min()) > 0


def _assert_result_matches(ours, ref, x_tol):
    np.testing.assert_array_equal(ours.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(ours.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(ours.active_set.numpy(),
                                  np.asarray(ref.active_set))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=x_tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", KINDS)
def test_solve_fast_matches_jax(name, dtype):
    # x within 1e-10 in f64 and 1e-5 in f32: the same iterations in another
    # summation order
    pb, opt, d = _case(name, dtype)
    jopt = JOptions(max_iter=opt.max_iter, zero_z_threshold=opt.zero_z_threshold,
                    dtype=jnp.float32 if dtype == np.float32 else jnp.float64)
    _assert_result_matches(solve_fast(pb, opt), j_fast(jax_problem(d), jopt),
                           1e-5 if dtype == np.float32 else 1e-10)


@pytest.mark.parametrize("name", list(CASES))
def test_solve_refined_matches_jax(name):
    # the f32 loop, then three steps of f64 refinement: x within 1e-10
    d, kw = make(name)
    ref = jax.jit(jax.vmap(lambda p: jfast.solve_refined(p, JOptions(**kw))))(
        jax_problem(d))
    ours = fast.solve_refined(problem_from_numpy(**d, device="cpu"),
                              SolverOptions(**kw))
    _assert_result_matches(ours, ref, 1e-10)


@pytest.mark.parametrize("gtype", list(GType))
def test_structured_fast_matches_jax(gtype):
    # the cold batch and one carried step (both through _run_loop), against
    # the JAX package's Pallas route in interpret mode: x within 1e-10
    d = ik_batch(5, nb=3, s=8, mc=2, seed=int(gtype) + 11)
    opt, jopt = SolverOptions(max_iter=200), JOptions(max_iter=200)
    res, carry = solve_structured_fast_carry(*_args(d, gtype), None, opt=opt)
    ref = js.solve_structured_fast_batch(*_jax_args(d, gtype), opt=jopt,
                                         backend="pallas", interpret=True)
    _assert_same(res, ref, x_tol=1e-10)
    _assert_same(solve_structured_fast_batch(*_args(d, gtype), opt=opt), ref,
                 x_tol=1e-10)
    step = ik_step(d, 0.02, np.random.default_rng(int(gtype)))
    res_w, _ = solve_structured_fast_carry(*_args(step, gtype), carry,
                                           opt=opt)
    _, jcarry = js.solve_structured_fast_carry(
        *_jax_args(d, gtype), None, opt=jopt, backend="pallas",
        interpret=True)
    ref_w, _ = js.solve_structured_fast_carry(
        *_jax_args(step, gtype), jcarry, opt=jopt, backend="pallas",
        interpret=True)
    _assert_same(res_w, ref_w, x_tol=1e-10)


def test_cpu_dispatch_runs_the_plain_version(monkeypatch):
    pb, opt, _ = _case("removals", np.float32)
    st0 = fast._init_fast(pb, opt)
    calls = []

    orig = fast.fast_loop_plain

    def plain(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr(fast, "fast_loop_plain", plain)
    spans.reset("launch.K11")
    out = fast._run_loop(pb, st0, opt)
    fast.solve_refined(pb.with_dtype(torch.float64), SolverOptions())
    assert calls == [1, 1] and spans.counter("launch.K11") == 0
    assert_states_equal(out, loop_before_k11(pb, st0, opt))


def test_on_pass_runs_the_pass_loop(monkeypatch):
    pb, opt, _ = _case("removals", np.float32)
    st0 = fast._init_fast(pb, opt)

    def no_k11(*args):
        raise AssertionError("the hooked loop reached K11's dispatch")

    monkeypatch.setattr(fast, "fast_loop", no_k11)
    passes, ref_passes = [], []
    out = fast._run_loop(pb, st0, opt,
                         on_pass=lambda before, after: passes.append(1))
    ref = loop_before_k11(pb, st0, opt,
                          on_pass=lambda before, after: ref_passes.append(1))
    assert_states_equal(out, ref)
    assert len(passes) == len(ref_passes) > int(out.it.max())


def test_fast_loop_raises_on_a_device_without_kernel():
    pb, opt, _ = _case("adds", np.float32)
    st0 = fast._init_fast(pb, opt)
    meta = dataclasses.replace(st0, x=st0.x.to("meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        fast._run_loop(pb, meta, opt)


def test_fast_loop_raises_past_shared_memory():
    # f32: (8n + 2 + m) + (m + 3n) words; n = 5300 is past a block
    assert fast_loop.fast_loop_smem_bytes(387, 36, 4) == 17328
    fast_loop._require_fits(387, 36, 4)
    with pytest.raises(ValueError, match="233216 B of shared memory"):
        fast_loop._require_fits(5300, 0, 4)


def _c_params(entry):
    """The parameter kinds of an extern "C" entry point of fast_loop.cu:
    P for a pointer, I for an int, D for a double."""
    src = (CSRC / "fast_loop.cu").read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
                    re.S).group(1)
    kinds = []
    for p in sig.split(","):
        p = p.strip()
        kinds.append("P" if "*" in p else "D" if p.startswith("double")
                     else "I" if p.startswith("int") else "?")
    return kinds


@pytest.mark.parametrize("entry", ["jrlqp_fast_loop_f32",
                                   "jrlqp_fast_loop_f64"])
def test_k11_entry_points_are_declared(entry):
    # the ctypes signature the build binds, against the C source; needs no
    # nvcc
    kinds = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_double: "D"}
    sig = [kinds[t] for t in _build._SIGNATURES[entry]]
    assert sig == ["P"] * 15 + ["I"] * 4 + ["D"] * 3 + ["P"]
    assert _c_params(entry) == sig
    assert _c_params("jrlqp_fast_loop_config") == ["I", "I", "I", "P"]


def test_k11_onchip_entry_point_is_declared():
    # the on-chip instance's entry: the streamed entry's parameters with the
    # cluster size after m; its config takes (n, m, cluster, out)
    kinds = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_double: "D"}
    entry = "jrlqp_fast_loop_onchip_f32"
    sig = [kinds[t] for t in _build._SIGNATURES[entry]]
    assert sig == ["P"] * 15 + ["I"] * 5 + ["D"] * 3 + ["P"]
    assert _c_params(entry) == sig
    assert _c_params("jrlqp_fast_loop_onchip_config") == ["I", "I", "I", "P"]


@pytest.mark.parametrize("n, m, dtype, instance, cluster", [
    (387, 36, F32, "onchip", 3),       # the IK width: 129 rows a block
    (50, 100, F32, "streamed", 1),     # the headline width, 128 threads
    (387, 36, F64, "streamed", 1),     # f64 stays streamed
    (640, 36, F32, "streamed", 1),     # 80 rows a block overflow 8 blocks
    (256, 0, F32, "onchip", 2),        # the first 256-thread width
    (255, 36, F32, "streamed", 1)])
def test_fast_loop_plan_chooses_the_instance(n, m, dtype, instance, cluster):
    # the on-chip instance where f32 at n >= 256 fits H in a cluster of at
    # most 8 blocks, in the smallest such cluster; the streamed one else
    plan = fast_loop.fast_loop_plan(n, m, dtype)
    assert (plan["instance"], plan["cluster"]) == (instance, cluster)
    base = fast_loop.fast_loop_smem_bytes(n, m, 8 if dtype == F64 else 4)
    if instance == "onchip":
        base += (8 * m + 16 * n + 15) // 16 * 16  # l, u, xl, xu, z, r
        band = -(-n // cluster)
        assert plan["smem_bytes"] == base + band * n * 4 < 232448
        smaller = base + -(-n // (cluster - 1)) * n * 4
        assert smaller > fast_loop._SMEM_LIMIT
    else:
        assert plan["smem_bytes"] == base


def test_k11_onchip_byte_model():
    # one lane of 5 iterations from q = 1 to 2 (3 adds, 2 removals at q =
    # 1.5) at (n, m) = (4, 5) in clusters of 2, f32: H read and written
    # once (32); an add mn + cn + 3qn = 20 + 8 + 18, a removal n^2 + cn +
    # 4qn = 16 + 8 + 24; a lane that does not step moves no H
    five, zero = torch.tensor([5]), torch.tensor([0])
    q0, q1 = torch.tensor([1]), torch.tensor([2])
    assert fast_loop.fast_loop_onchip_bytes(five, q0, q1, 4, 5, 4, 2) == \
        4 * (32 + 3 * 46 + 2 * 48)
    assert fast_loop.fast_loop_onchip_bytes(zero, q0, q0, 4, 5, 4, 2) == 0


def test_k11_bound_counts():
    # one lane: 5 iterations from q = 1 to q = 2, so 3 adds and 2
    # removals at q = 1.5, (n, m) = (4, 5): an add 2mn + 4n^2 + 4qn =
    # 40 + 64 + 24, a removal 6n^2 + 6qn = 96 + 36
    five = torch.tensor([5])
    q0, q1 = torch.tensor([1]), torch.tensor([2])
    assert fast_loop.fast_loop_flops(five, q0, q1, 4, 5) == 3 * 128 + 2 * 132
    # streamed, f32: an add mn + 3n^2 + 3qn = 20 + 48 + 18, a removal
    # 4n^2 + 4qn = 64 + 24
    assert fast_loop.fast_loop_stream_bytes(five, q0, q1, 4, 5, 4) == 4 * (
        3 * 86 + 2 * 88)
    # problem 8 (16 + 20 + 10 + 8 + 1), state 8 (32 + 8 + 2) + 4 (5 + 8 +
    # 6), read and written
    assert fast_loop.fast_loop_bytes(2, 4, 5, 8) == 2 * (
        8 * 55 + 2 * (8 * 42 + 76))


def test_jax_parts_from_the_plain_loop_only_at_vertices():
    # where m >= n, lanes reach a vertex (q = n) at which H is zero in exact
    # arithmetic and the zero-z and dependence tests read its rounding
    # noise: there the JAX package's own XLA loop and the port's plain
    # loop may part in f64, as K11 and the plain loop do on the card. On
    # the card tests' lane kinds at n = 10, m = 100, every lane on which
    # the two packages part has been at a vertex
    from test_torch_card import jr_card_batch

    d = jr_card_batch(10, 100, 64, seed=117)
    pb = problem_from_numpy(**d, device="cpu")
    opt = SolverOptions(max_iter=140)
    top_q = torch.zeros(pb.batch, dtype=torch.int32)

    def watch(before, after):
        torch.maximum(top_q, after.q, out=top_q)

    ours = dense.finalize(pb, fast.fast_loop_plain(
        pb, fast._init_fast(pb, opt), opt, on_pass=watch))
    ref = j_fast(jax_problem(d), JOptions(max_iter=140))
    same = ((ours.status.numpy() == np.asarray(ref.status))
            & (ours.iterations.numpy() == np.asarray(ref.iterations))
            & (ours.active_set.numpy() == np.asarray(ref.active_set)).all(1))
    parted = np.nonzero(~same)[0]
    print(f"the JAX package and the plain loop part on lanes "
          f"{parted.tolist()} of {pb.batch}")
    assert (top_q.numpy()[parted] >= pb.n).all()
    assert (top_q >= pb.n).any()


def _margins(**kw):
    """fast_parting.margins of a lane at n = 12 that no fixed window
    flags, with ``kw`` set."""
    mg = {"q": 5, "n": 12, "viol": -1.0, "t1": 1.0, "t2": 2.0, "t_gap": 0.5,
          "t1_runner_up_gap": 0.5, "selection_runner_up_gap": 0.5,
          "zz_over_threshold": 1e6, "delta_over_dep": 1e3}
    return {**mg, **kw}


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_near_ties_take_f64_partings_only_at_a_vertex(dtype):
    # f64: only q >= n; the f32 windows and the dependence test's measured
    # spread do not count there
    flip = _margins(delta_over_dep=5.0), _margins(delta_over_dep=-3.0)
    assert fast_parting.near_ties(*flip, dtype) == (
        ["dependence"] if dtype == F32 else [])
    assert fast_parting.near_ties(_margins(q=12), _margins(q=12),
                                  dtype) == ["vertex"]
    tight = _margins(t_gap=1e-6, zz_over_threshold=2.0)
    assert fast_parting.near_ties(tight, tight, dtype) == (
        ["zero-z test", "t2 <= t1"] if dtype == F32 else [])
    # the slot count alone is no witness
    near = _margins(q=11)
    assert fast_parting.near_ties(near, near, dtype) == []


def test_near_ties_dependence_needs_a_negative_delta():
    # delta >= 0 in exact arithmetic: two positive ratios that straddle the
    # threshold are no measured rounding, one negative side is
    def dep(dp, dk):
        return "dependence" in fast_parting.near_ties(
            _margins(delta_over_dep=dp), _margins(delta_over_dep=dk), F32)

    assert not dep(5.0, 0.5) and not dep(1e3, 2e3)
    assert dep(17.1, -27.6) and dep(-11.6, 235.0) and dep(0.369, -12.2)
    assert dep(134.0, -10.6)
    # the plain side farther from the threshold than the two sides apart,
    # or than 16 times the rounding that the negative side shows
    assert not dep(-50.0, -1.0) and not dep(900.0, -1.0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_outcomes_hold_both_sides_to_a_sound_end(dtype):
    # the same end on both sides is sound; a lane that ends INFEASIBLE on
    # one side and SUCCESS on the other is not (its active set refines to
    # no KKT point); a lane whose end code differs but whose active set
    # refines to the same KKT point on both sides is
    pb, opt, _ = _case("infeasible", dtype)
    want = fast.fast_loop_plain(pb, fast._init_fast(pb, opt), opt)
    bad = int(torch.nonzero(want.term == TS.INFEASIBLE)[0, 0])
    good = int(torch.nonzero(want.term == TS.SUCCESS)[0, 0])
    same = fast_parting.outcomes(pb, want, want, [bad, good])
    assert all(o["sound"] for o in same.values())
    term = want.term.clone()
    term[bad], term[good] = TS.SUCCESS, TS.MAX_ITER_REACHED
    got = dataclasses.replace(want, term=term)
    out = fast_parting.outcomes(pb, got, want, [bad, good])
    assert out[bad]["terms"] == (int(TS.INFEASIBLE), int(TS.SUCCESS))
    assert not out[bad]["sound"] and out[good]["sound"]
    assert max(out[good]["kkt"]) <= 1e-8
    # INFEASIBLE and LINEAR_DEPENDENCY_DETECTED are one class: no answer
    term[bad] = TS.LINEAR_DEPENDENCY_DETECTED
    out = fast_parting.outcomes(pb, got, want, [bad])
    assert out[bad]["sound"] and min(out[bad]["kkt"]) > 1e-8


def test_jax_splits_answers_at_f32_vertices():
    # the card tests' lane kinds at n = 10, m = 100 in f32, the same draws:
    # the JAX package's own loop parts from the port's plain loop, and on
    # some lanes one ends with an answer (SUCCESS) and the other with none
    # (LINEAR_DEPENDENCY_DETECTED), every such lane having been at a
    # vertex. K11 splits so from the plain version on the card on as few
    # lanes (tests/test_torch_card.py::test_fast_loop_kernel_matches_plain)
    from test_torch_card import jr_card_batch

    d = {k: v.astype(np.float32)
         for k, v in jr_card_batch(10, 100, 256, seed=117).items()}
    pb = problem_from_numpy(**d, device="cpu")
    opt = SolverOptions(dtype=F32, max_iter=140, zero_z_threshold=1e-6)
    top_q = torch.zeros(pb.batch, dtype=torch.int32)

    def watch(before, after):
        torch.maximum(top_q, after.q, out=top_q)

    ours = dense.finalize(pb, fast.fast_loop_plain(
        pb, fast._init_fast(pb, opt), opt, on_pass=watch))
    ref = j_fast(jax_problem(d), JOptions(max_iter=140, dtype=jnp.float32,
                                          zero_z_threshold=1e-6))
    mine, theirs = ours.status.numpy(), np.asarray(ref.status)
    answer = int(TS.SUCCESS)
    split = np.nonzero((mine == answer) != (theirs == answer))[0]
    print(f"answer splits between the JAX package and the plain loop: "
          f"lanes {split.tolist()} of {pb.batch}, (plain, jax) "
          f"{list(zip(mine[split].tolist(), theirs[split].tolist()))}")
    assert len(split) >= 6
    assert (top_q.numpy()[split] >= pb.n).all()
    assert set(mine[split]) | set(theirs[split]) == {
        answer, int(TS.LINEAR_DEPENDENCY_DETECTED)}
