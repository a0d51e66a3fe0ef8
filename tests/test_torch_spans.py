"""The port's spans and counters (``jrlqp_tpu_torch.utils.spans``) on the
CPU: off, a span is a shared no-op that calls into no profiler and records
nothing; on, the three benchmark paths (the dense main path, the IK cold
batch and the IK warm step) give their documented stages, each under the
root of its call; the host-sync spans of a carry step match its
deactivation rounds; the spans are ``user_annotation`` events of the
profiler's trace, nested as the records say; a sharded solve's shards carry
the caller's call id; the buffer is bounded; and the launch counters of old
read the one registry."""
import dataclasses
import json
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from jrlqp_tpu_torch import SolverOptions, solve_refined_kernel
from jrlqp_tpu_torch.ops.cuda import (
    _build,
    block_llt,
    fast_loop,
    gi_kernel,
    jr_kernel,
)
from jrlqp_tpu_torch.parallel import make_mesh, solve_sharded
from jrlqp_tpu_torch.solver import fast
from jrlqp_tpu_torch.structured import (
    GType,
    StructuredC,
    StructuredG,
    solve_structured_fast,
    solve_structured_fast_batch,
    solve_structured_fast_carry,
)
from jrlqp_tpu_torch.testing.batch_gen import random_qp_batch
from jrlqp_tpu_torch.testing.ik_gen import ik_batch, ik_step
from jrlqp_tpu_torch.utils import spans

torch.set_num_threads(1)

OPT_DENSE = SolverOptions(max_iter=150)
OPT_IK = SolverOptions(max_iter=200)

# the top-level stages of each path's call, runs of one stage merged
STAGES = {
    "dense": ["prepare", "loop", "remap", "refine"],
    "ik_cold": ["prepare", "factor", "init", "loop", "refine"],
    "ik_track": ["prepare", "init", "loop", "refine"],
}
# the kept names of the launch counters, and their registry names
KEPT = [(gi_kernel, "launches", "launch.K1"),
        (gi_kernel, "loop_launches", "launch.K3"),
        (gi_kernel, "warm_launches", "launch.K4"),
        (gi_kernel, "compact_launches", "launch.K9"),
        (block_llt, "launches", "launch.chol_inv_b"),
        (block_llt, "tri_llt_launches", "launch.K5"),
        (block_llt, "tri_solve_launches", "launch.K6"),
        (block_llt, "arrow_llt_launches", "launch.K7"),
        (block_llt, "arrow_solve_launches", "launch.K8"),
        (jr_kernel, "launches", "launch.K10"),
        (fast_loop, "launches", "launch.K11"),
        (_build, "loads", "library.load")]


def _dense():
    gen = torch.Generator().manual_seed(0)
    return random_qp_batch(gen, 4, 6, 12, 0.3, dtype=torch.float32
                           ).with_dtype(torch.float64)


def _ik(d):
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    sg = StructuredG(diag=t["diag"], off=t["off"],
                     gtype=GType.TRI_BLOCK_DIAGONAL)
    return sg, t["a"], StructuredC(blocks=t["blocks"]), t["l"], t["u"]


IK_BASE = ik_batch(3, nb=2, s=4, mc=2, seed=1)


def _ik_step(seed=0, drift=0.5):
    return _ik(ik_step(IK_BASE, drift, np.random.default_rng(seed)))


def _call(path):
    """A function that makes one call of ``path``; a track step's carry
    comes from a cold step solved here."""
    if path == "dense":
        pb = _dense()
        return lambda: solve_refined_kernel(pb, OPT_DENSE, ir_steps=1)
    if path == "ik_cold":
        return lambda: solve_structured_fast_batch(*_ik(IK_BASE), opt=OPT_IK)
    _, carry = solve_structured_fast_carry(*_ik(IK_BASE), None, opt=OPT_IK)
    return lambda: solve_structured_fast_carry(*_ik_step(), carry,
                                               opt=OPT_IK)


def _record(fn):
    spans.clear()
    with spans.recording():
        out = fn()
    return out, spans.recorded()


def _top(call):
    """The names of the root's children, runs of one name merged."""
    names = [s.stage for s in call if s.parent is call[0]]
    return [n for i, n in enumerate(names) if i == 0 or names[i - 1] != n]


def test_off_makes_no_profiler_call_and_records_nothing(monkeypatch):
    def boom(*args, **kw):
        raise AssertionError("a span called into torch while off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    spans.clear()
    for path in STAGES:
        _call(path)()
    assert spans.recorded() == [] and spans.calls() == []
    t = torch.zeros(2)
    assert spans.span("jrlqp.prepare", t) is spans.call("x", t) \
        is spans.span("jrlqp.loop")
    assert spans.current() is None


def test_off_span_takes_no_lock_and_allocates_nothing(monkeypatch):
    class NoLock:
        def __enter__(self):
            raise AssertionError("a span took the lock while off")

        def __exit__(self, *exc):
            return False

    t = torch.zeros(2)

    def spans_off(k):
        for _ in range(k):
            with spans.span("jrlqp.prepare", t):
                pass
            with spans.call("solve", t):
                pass
            with spans.sync("pad"):
                pass
            spans.current()

    spans_off(10)
    monkeypatch.setattr(spans, "_lock", NoLock())
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        spans_off(5000)
        cur, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # 20,000 calls: one object each would hold at least 320 KB at once
    assert cur - base <= 0 and peak - base < 1024, (cur - base, peak - base)


@pytest.mark.parametrize("path", sorted(STAGES))
def test_each_path_gives_its_stages_under_its_root(path):
    _, calls = _record(_call(path))
    assert len(calls) == 1, [c[0] for c in calls]
    call = calls[0]
    root = call[0]
    assert root.name == spans.CALL and root.parent is None
    assert _top(call) == STAGES[path]
    assert sum(s.name == spans.CALL for s in call) == 1
    for s in call:
        assert s.call == root.call and s.host1 >= s.host0
        assert s.thread == root.thread
        if s.name.startswith("jrlqp.sync."):
            assert s.parent.stage in ("prepare", "init", "loop"), s
        elif s is not root:
            assert s.parent is root, s
    summary = spans.calls()[0]
    assert summary["call"] == root.call
    assert set(summary["stages"]) >= set(STAGES[path])
    assert summary["syncs"] == sum(s.name.startswith("jrlqp.sync.")
                                   for s in call)
    assert summary["stages"]["loop"]["n"] == 1
    total = sum(v["host_ms"] for k, v in summary["stages"].items()
                if k in STAGES[path])
    assert 0 < total <= summary["host_ms"]


def test_an_inner_entry_point_opens_no_second_root():
    sg, a, sc, l, u = _ik(IK_BASE)
    one = dataclasses.replace(sg, diag=sg.diag[0], off=sg.off[0])
    _, calls = _record(lambda: solve_structured_fast(
        one, a[0], StructuredC(blocks=sc.blocks[0]), l[0], u[0], opt=OPT_IK))
    # solve_structured_fast opens no span; its batch of one is the root
    assert len(calls) == 1 and calls[0][0].entry == \
        "solve_structured_fast_batch"
    _, calls = _record(lambda: solve_sharded(
        _dense(), OPT_DENSE, mesh=make_mesh(devices=["cpu"]),
        engine="pallas", fused_init=True))
    assert len(calls) == 1
    inner = [s for s in calls[0] if s.name == spans.CALL][1:]
    assert [s.entry for s in inner] == ["solve_refined_kernel"]
    assert inner[0].parent.name == "jrlqp.shard"


def test_carry_step_syncs_once_per_deactivation_round_and_once_more(
        monkeypatch):
    _, carry = solve_structured_fast_carry(*_ik(IK_BASE), None, opt=OPT_IK)
    # the CPU batch's carry init is the plain version of K12, a round of
    # torch ops and a host read per deactivation
    inits = []
    init = fast._init_fast_from_carry

    def kept(*args):
        inits.append(init(*args))
        return inits[-1]

    monkeypatch.setattr(fast, "_init_fast_from_carry", kept)
    _, calls = _record(lambda: solve_structured_fast_carry(
        *_ik_step(seed=3, drift=1.0), carry, opt=OPT_IK))
    # each round removes one slot of every lane still active and counts
    # it as an iteration: the rounds are the most any lane made
    rounds = int(inits[0].it.max())
    assert rounds >= 1
    n = sum(s.name == "jrlqp.sync.deactivate" for s in calls[0])
    assert n == rounds + 1


def test_spans_are_user_annotations_nested_as_recorded(tmp_path):
    spans.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        solve_refined_kernel(_dense(), OPT_DENSE, ir_steps=1)
    calls = spans.recorded()
    assert len(calls) == 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("jrlqp.")]
    events.sort(key=lambda e: float(e["ts"]))
    call = calls[0]
    assert [e["name"] for e in events] == [s.name for s in call]
    ev = {id(s): e for s, e in zip(call, events)}
    for s in call[1:]:
        p, c = ev[id(s.parent)], ev[id(s)]
        assert float(p["ts"]) <= float(c["ts"])
        assert float(c["ts"]) + float(c["dur"]) <= \
            float(p["ts"]) + float(p["dur"])


def test_under_a_profiler_alone_a_span_records_no_cuda_event(monkeypatch):
    def boom(*args, **kw):
        raise AssertionError("a span touched CUDA under a profiler alone")

    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.cuda, "current_stream", boom)
    card = torch.device("cuda", 0)
    spans.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.call("solve", card):
            with spans.span("jrlqp.loop"):
                pass
    (call,) = spans.recorded()
    assert [s.device for s in call] == [card, card]
    assert all(s.events is None and s.device_ms is None for s in call)
    (summary,) = spans.calls()
    assert summary["device_ms"] is None
    assert summary["stages"]["loop"]["device_ms"] is None
    with spans.recording(), pytest.raises(AssertionError, match="CUDA"):
        with spans.span("jrlqp.loop", card):
            pass


@pytest.mark.parametrize("engine", ["pallas", "f64"])
def test_shard_spans_on_worker_threads_carry_the_callers_call_id(
        engine, monkeypatch):
    from jrlqp_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "_THREADED_ENGINES", mesh_mod.ENGINES)
    mesh = make_mesh(devices=["cpu"] * 4)
    _, calls = _record(lambda: solve_sharded(
        _dense(), OPT_DENSE, mesh=mesh, engine=engine, fused_init=True))
    assert len(calls) == 1
    call = calls[0]
    root = call[0]
    shards = [s for s in call if s.name == "jrlqp.shard"]
    assert len(shards) == 4 and [s.lanes for s in shards] == [1] * 4
    assert all(s.parent is root and s.call == root.call for s in shards)
    assert len({s.thread for s in shards}) == 4
    assert root.thread not in {s.thread for s in shards}
    assert sum(s.name == "jrlqp.scatter" for s in call) == 4
    assert [s.stage for s in call if s.parent is root][-1] == "gather"
    for s in call:
        assert s.call == root.call
        if s.name == spans.CALL and s is not root:
            assert s.parent.name == "jrlqp.shard"


def test_the_buffer_keeps_the_last_calls():
    spans.clear()
    t = torch.zeros(3)
    with spans.recording():
        for i in range(spans.CALLS_KEPT + 10):
            with spans.call(f"e{i}", t):
                with spans.span("jrlqp.loop"):
                    pass
    calls = spans.recorded()
    assert len(calls) == spans.CALLS_KEPT
    assert [c[0].entry for c in calls] == [
        f"e{i}" for i in range(10, spans.CALLS_KEPT + 10)]
    assert all(c[0].lanes == 3 and c[1].device == t.device for c in calls)


def test_launch_counters_read_the_registry_through_their_old_names():
    saved = spans.counts()
    try:
        spans.reset()
        for k, (_, _, key) in enumerate(KEPT):
            spans.count(key, k + 1)
        for k, (mod, name, _) in enumerate(KEPT):
            assert getattr(mod, name) == k + 1, (mod.__name__, name)
        spans.reset("launch.K1")
        assert gi_kernel.launches == 0
        assert jr_kernel.launches == 10 and fast_loop.launches == 11
        spans.reset("launch")
        assert [getattr(m, n) for m, n, _ in KEPT] == [0] * 11 + [12]
        assert spans.counts("library") == {"library.load": 12}
    finally:
        spans.reset()
        for k, v in saved.items():
            spans.count(k, v)
    for mod in {m for m, _, _ in KEPT}:
        assert not hasattr(mod, "_count_lock"), mod.__name__
        with pytest.raises(AttributeError):
            mod.no_such_counter  # noqa: B018


def test_counters_lose_no_update_across_threads():
    n_threads, per = 16, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        spans.reset("test.stress")
        threads = [threading.Thread(target=lambda: [
            spans.count("test.stress") for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert spans.counter("test.stress") == n_threads * per
    spans.reset("test.stress")
