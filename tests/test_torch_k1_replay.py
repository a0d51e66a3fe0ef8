"""K1's whole solve replayed on the CPU in K1's own order
(``jrlqp_tpu_torch.testing.k1_replay.k1_order_solve``), held bit for bit to
what the card recorded:

- every state of ``tests/data/split_states_card.npz`` that K1 kept, at
  every iteration cap (``miss_census --states`` on an H100: x, u, H, N*,
  the active set, the slots and the scalars);
- on every K1 lane of ``tests/data/missed_lanes_port.npz`` and
  ``missed_lanes_jax.npz``, the card's ``kernel_card_alone`` outcome
  (status, iterations, pass or fail, active set, the refined x within
  1e-9 where it ends SUCCESS), and, where the record keeps it, the card's
  trajectory at every cap (x, the active set, q, it and term);

and, on small batches with equalities, fixed variables, a non-SPD G and
vertices touched by many rows, the port's plain K1 path at every lane, as
the card tests hold the kernel to it; on a QP whose selection and step
lengths tie exactly, the ties resolved as the kernel resolves them; and
the FMA chain that the replay's dot products use, against one ``fma32``
per step.

No host library chooses an order in the replay, so these hold on any CPU.
This file imports neither jax nor the JAX package; it runs on a machine
with a card and no jax too:

    python -m pytest --noconftest tests/test_torch_k1_replay.py
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np
import pytest
import torch

from jrlqp_tpu_torch import problem_from_numpy
from jrlqp_tpu_torch.ops.cuda import gi_kernel
from jrlqp_tpu_torch.testing import miss_census as mc
from jrlqp_tpu_torch.testing import op_split, order_exact
from jrlqp_tpu_torch.testing.k1_replay import STATE_KEYS, k1_order_solve
from jrlqp_tpu_torch.types import LOWER
from test_torch_card import CASES, make_case

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"
CARD_STATES = DATA / "split_states_card.npz"
LANE_FILES = {w: DATA / f"missed_lanes_{w}.npz" for w in ("port", "jax")}


@functools.cache
def _lanes(which: str) -> dict:
    return {mc.lane_id(r): r
            for r in mc.load_lanes(str(LANE_FILES[which]))[0]}


@functools.cache
def _card_states() -> list[dict]:
    return [c for c in mc.load_lanes(str(CARD_STATES))[0]
            if c["path"] == "K1"]


def pytest_generate_tests(metafunc):
    # the cases are read from the files at collection (a missing file fails)
    if "card_lane" in metafunc.fixturenames:
        metafunc.parametrize("card_lane", [
            pytest.param(i, id=f"{c['file']}-{c['lane']}")
            for i, c in enumerate(_card_states())])
    if "k1_lane" in metafunc.fixturenames:
        metafunc.parametrize("k1_lane", [
            pytest.param((w, lane), id=f"{w}-{lane}")
            for w in LANE_FILES for lane, r in _lanes(w).items()
            if r["path"] == "K1"])


def test_k1_replay_holds_the_card_states(card_lane):
    # K1's state at each kept cap: the state K1 returns when launched with
    # that max_iter, every key bit for bit
    c = _card_states()[card_lane]
    rec = _lanes(c["file"])[c["lane"]]
    caps = [int(k) for k in c["caps"]]
    got = k1_order_solve(rec["arrays"], rec["max_iter"], rec["ir_steps"],
                         caps=caps)["states"]
    assert sorted(c["states"]) == sorted(STATE_KEYS)
    for i, cap in enumerate(caps):
        for k, v in c["states"].items():
            assert np.array_equal(np.asarray(got[cap][k]), v[i]), (cap, k)


def test_k1_replay_gives_the_card_outcome(k1_lane):
    which, lane = k1_lane
    rec = _lanes(which)[lane]
    traj = rec.get("kernel_card_trajectory")
    caps = range(len(traj["it"])) if traj else ()
    got = k1_order_solve(rec["arrays"], rec["max_iter"], rec["ir_steps"],
                         caps=caps)
    want = rec["outcomes"]["kernel_card_alone"]
    o = got["outcome"]
    assert (o["status"], o["iterations"], o["passed"]) == (
        want["status"], want["iterations"], want["passed"])
    np.testing.assert_array_equal(o["active_set"], want["active_set"])
    # the same f32 state refined in f64 on the CPU and on the card; a
    # dependent active set (LINEAR_DEPENDENCY_DETECTED) magnifies the f64
    # products' summation order (3.1e-8 on size_sweep-0-n10-9034)
    tol = 1e-9 if want["status"] == 0 else 1e-6
    np.testing.assert_allclose(o["x"], want["x"], rtol=0, atol=tol)
    for c in caps:
        for k, v in traj.items():
            assert np.array_equal(np.asarray(got["states"][c][k]), v[c]), (
                c, k)


def _lane_arrays(d: dict, i: int) -> dict:
    return {k: v[i] for k, v in d.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_k1_replay_matches_the_plain_path(name):
    # the card tests' batches (equalities, fixed variables, a non-SPD G,
    # vertices of many rows): every lane as the plain K1 path ends it
    d, max_iter = make_case(name)
    pb = problem_from_numpy(
        **{k: v.astype(np.float32) for k, v in d.items()}, device="cpu")
    ref = gi_kernel.gi_fused_plain(pb, max_iter)
    for i in range(pb.batch):
        raw = k1_order_solve(_lane_arrays(d, i), max_iter, 1)["raw"]
        for k in ("term", "it", "q", "status", "aorder"):
            assert np.array_equal(np.asarray(raw[k]),
                                  ref[k][i].numpy()), (i, k)
        for k in ("x", "u", "H", "Ns"):
            np.testing.assert_allclose(raw[k], ref[k][i].numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"{i} {k}")


def tie_qp() -> dict:
    """n = 2, G = I, a = 0, rows 2 x1 >= 2 and x1 + x2 >= 2, every value
    exact in f32. At x = 0 both rows are violated by 2: the selection ties
    and takes row 0 (x = (1, 0), u0 = 0.5). Row 1 then has t1 = u0 / r0 =
    0.5 / 0.5 = 1 and t2 = (2 - 1) / 1 = 1: the step lengths tie and
    t2 <= t1 makes it a full step. SUCCESS after 2 iterations, x = (1, 1),
    both rows active (row 0 with multiplier 0)."""
    inf = np.inf
    return {"G": np.eye(2), "a": np.zeros(2),
            "C": np.array([[2.0, 0.0], [1.0, 1.0]]),
            "l": np.array([2.0, 2.0]), "u": np.array([inf, inf]),
            "xl": np.full(2, -inf), "xu": np.full(2, inf)}


def test_ties_resolve_as_the_kernel_resolves_them():
    # lowest index on a tied selection; a full step on t2 == t1 (every
    # path of both packages: test_torch_missed_lanes.py)
    o = k1_order_solve(tie_qp(), 20, 1)["outcome"]
    assert (o["status"], o["iterations"]) == (0, 2)
    assert o["active_set"].tolist() == [LOWER, LOWER, 0, 0]
    np.testing.assert_array_equal(o["x"], [1.0, 1.0])


@pytest.mark.parametrize("seed", range(4))
def test_chain_is_a_chain_of_fmas(seed):
    # op_split's FMA chain (f64 sums, the halfway and subnormal cases
    # through fma32) against one order_exact.fma32 per step; half the
    # draws are small integers scaled by powers of two, whose sums land
    # halfway between two f32 often
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n, c = rng.integers(1, 120), rng.integers(1, 220)
        if rng.random() < 0.5:
            vec = (rng.integers(-8, 8, n)
                   * 2.0 ** rng.integers(-3, 3)).astype(np.float32)
            A = (rng.integers(-2 ** 12, 2 ** 12, (n, c))
                 * 2.0 ** -rng.integers(0, 20)).astype(np.float32)
        else:
            vec = (rng.standard_normal(n)
                   * 10.0 ** rng.integers(-30, 30)).astype(np.float32)
            A = rng.standard_normal((n, c)).astype(np.float32)
        acc = torch.zeros(c)
        for k in range(n):
            acc = order_exact.fma32(torch.full((c,), float(vec[k])),
                                    torch.from_numpy(A[k]), acc)
        got = op_split._chain(vec, A)
        assert np.array_equal(got.view(np.int32), acc.numpy().view(np.int32))
