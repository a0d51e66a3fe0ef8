"""The per-operation split of an f32 GI parting (``jrlqp_tpu_torch.testing.
op_split``): the split on a hand-built QP whose every operation's exact
value is known, and the replays of one GI iteration that the split reads
each side's operations from, held bit for bit to the states they replay:

- K1's order (FMA chains in k order, the warp butterfly sums, products
  rounded apart) against the card's own states at consecutive iteration
  caps, ``tests/data/split_states_card.npz`` (``miss_census --states`` on
  an H100);
- the plain version's order against the plain version's states on the CPU.

The JAX package's side (its Pallas kernel's replay, the bisection of its
kernel against its XLA loop) is in ``test_torch_slack_split_jax.py``.
"""
from __future__ import annotations

import functools
import pathlib

import numpy as np
import pytest
import torch

from jrlqp_tpu_torch.testing import miss_census as mc
from jrlqp_tpu_torch.testing import op_split
from jrlqp_tpu_torch.types import LOWER

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"
CARD_STATES = DATA / "split_states_card.npz"
LANE_FILES = {w: DATA / f"missed_lanes_{w}.npz" for w in ("port", "jax")}


# ---- the split on a hand-built QP, n = 3 ----

def _qp():
    """G = diag(2, 4, 5), two rows; at the unconstrained minimizer x0 row 0
    (c0 x >= 1) is violated, row 1 (c1 x >= -2) is inactive at both
    vertices and is the deciding slack."""
    d = op_split.f32_data({
        "G": np.diag([2.0, 4.0, 5.0]), "a": np.array([1.0, -2.0, 0.5]),
        "C": np.array([[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]]),
        "l": np.array([1.0, -2.0]), "u": np.array([np.inf, np.inf]),
        "xl": np.full(3, -np.inf), "xu": np.full(3, np.inf)})
    st0 = np.zeros(5, np.int64)
    st1 = st0.copy()
    st1[0] = LOWER
    return d, st0, st1


def _split(dot=0.0, e=(0.0, 0.0, 0.0), dx=(0.0, 0.0, 0.0),
           dz=(0.0, 0.0, 0.0), dt=0.0, dH=None):
    """The split of constraint 1's slack after one full step that adds row
    0, from a side state whose x is off by ``e`` and H by ``dH``, with the
    step's z off by ``dz`` (from z~ = H n+), t by ``dt`` (from t~), the x
    update by ``dx`` and the slack's dot by ``dot``; and the exact parts."""
    d, st0, st1 = _qp()
    e, dx, dz = (np.array(v, np.float64) for v in (e, dx, dz))
    it0, it1 = op_split.iterate64(d, st0), op_split.iterate64(d, st1)
    H = np.linalg.inv(d["G"].astype(np.float64))
    H = H + (0.0 if dH is None else dH)
    x_pv = it0["x"] + e
    n1 = d["C"][0].astype(np.float64)
    z_t = H @ n1
    t_t = (float(d["l"][0]) - n1 @ x_pv) / (n1 @ z_t)
    z_h, t_h = z_t + dz, t_t + dt
    x_lo = x_pv + t_h * z_h + dx
    state = {"x": x_pv, "H": H, "Ns": np.zeros((3, 3)), "u": np.zeros(3),
             "status": st0, "aorder": np.full(3, -1)}
    step = {"dual": False, "full": True, "t": t_h, "z": z_h, "npl": n1,
            "sc_status": LOWER, "bsel": d["l"][0], "lpos": 0}
    g, scale = op_split.slack_gradient(d, it1["x"], 1)
    s_hat = op_split.violations(d, x_lo)[0][1] + dot
    got = op_split.slack_split(d, 1, s_hat, [state, dict(state, x=x_lo)],
                               [step], it0["x"], it1["x"])
    us = float(np.spacing(np.float32(scale)))
    want = {"dot": dot, "inherited": g @ e, "x_update": g @ dx,
            "directions": t_h * (g @ dz), "step_length": dt * (g @ z_t),
            "state_x": -(g @ z_t) * (n1 @ e) / (n1 @ z_t),
            "state_operator": g @ (t_t * z_t + (n1 @ e) / (n1 @ z_t) * z_t
                                   - (it1["x"] - it0["x"]))}
    return got, {k: v / us for k, v in want.items()}, scale / us


CASES = {
    "exact": {},
    "dot": {"dot": 3e-7},
    "inherited": {"e": (2e-7, -1e-7, 4e-7)},
    "x_update": {"dx": (0.0, -3e-7, 1e-7)},
    "directions": {"dz": (1e-7, 2e-7, -5e-8)},
    "step_length": {"dt": -2e-7},
    "operator": {"dH": np.diag([1e-7, -2e-7, 3e-7])},
}


@pytest.mark.parametrize("case", CASES)
def test_slack_split_on_a_hand_built_qp(case):
    got, want, scale = _split(**CASES[case])
    parts = ("dot", "inherited", "x_update", "directions", "step_length",
             "state")
    # the parts sum to the total, within 1e-12 of the slack's scale |C_p x|
    # (the f64 rounding of the differences the parts are made of)
    assert abs(sum(got[k] for k in parts) - got["total"]) <= 1e-12 * scale
    assert abs(got["state_x"] + got["state_operator"] - got["state"]) \
        <= 1e-12 * scale
    # each part is the error put in, with its sign; nothing else moves
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12 * scale, (k, got[k], v)
    injected = {"dot": "dot", "inherited": "inherited",
                "x_update": "x_update", "directions": "directions",
                "step_length": "step_length",
                "operator": "state_operator"}.get(case)
    if injected:
        assert abs(got[injected]) > 0.1
        assert np.sign(got[injected]) == np.sign(want[injected])


# ---- the replays, held to the states they replay ----

@functools.cache
def _card_states() -> list[dict]:
    return mc.load_lanes(str(CARD_STATES))[0]


@functools.cache
def _lane(which: str, lane: str) -> dict:
    return next(r for r in mc.load_lanes(str(LANE_FILES[which]))[0]
                if mc.lane_id(r) == lane)


def _pairs(caps):
    return [i for i in range(len(caps) - 1) if caps[i + 1] == caps[i] + 1]


def pytest_generate_tests(metafunc):
    if "card_lane" in metafunc.fixturenames:
        metafunc.parametrize("card_lane", [
            pytest.param(i, id=f"{r['file']}-{r['lane']}")
            for i, r in enumerate(_card_states())])


def test_card_states_are_the_census_caps(card_lane):
    # the card kept each lane's state at split_caps of its record
    c = _card_states()[card_lane]
    rec = _lane(c["file"], c["lane"])
    assert list(c["caps"]) == mc.split_caps(rec)
    assert c["path"] == rec["path"]
    assert list(c["states"]["it"]) == list(c["caps"])


def test_k1_replay_holds_the_card_states(card_lane):
    # every iteration between two kept caps, replayed in K1's order from
    # the card's state, gives the card's next state bit for bit
    c = _card_states()[card_lane]
    d = op_split.f32_data(_lane(c["file"], c["lane"])["arrays"])
    S = c["states"]
    pairs = _pairs(c["caps"])
    assert pairs
    for i in pairs:
        st = {k: v[i] for k, v in S.items()}
        nxt = {k: v[i + 1] for k, v in S.items()}
        it = op_split.k1_iteration(st, d)
        assert op_split.same_next(it, nxt), (c["lane"], int(c["caps"][i]))


@pytest.mark.parametrize("which, lane", [
    ("port", "headline-3-9615"), ("jax", "headline-6-13413"),
    ("port", "size_sweep-0-n100-6448")])
def test_plain_replay_holds_the_plain_path(which, lane):
    # the plain version on the CPU at the card's caps: each iteration
    # replayed in the plain version's order gives its next state
    rec = _lane(which, lane)
    caps = [int(c) for c in next(
        r for r in _card_states() if (r["file"], r["lane"]) == (which, lane)
    )["caps"]]
    tr = mc.trajectory(rec["path"], mc.lane_problem(rec, "cpu"),
                       rec["max_iter"], caps, full=True)
    d = op_split.f32_data(rec["arrays"])
    order = op_split.PlainOrder(rec["n"], rec["m"])
    for i in _pairs(caps):
        st = {k: v[i] for k, v in tr.items()}
        nxt = {k: v[i + 1] for k, v in tr.items()}
        assert op_split.same_next(op_split.gi_iteration(st, d, order), nxt)


def test_k1_order_differs_from_the_plain_order():
    # the replay is not vacuous: on the card's states K1's order and the
    # plain version's give other bits for some iteration
    c = next(r for r in _card_states() if r["lane"] == "headline-3-9615")
    d = op_split.f32_data(_lane(c["file"], c["lane"])["arrays"])
    order = op_split.PlainOrder(50, 100)
    differ = 0
    for i in _pairs(c["caps"]):
        st = {k: v[i] for k, v in c["states"].items()}
        a = op_split.k1_iteration(st, d)["next"]
        b = op_split.gi_iteration(st, d, order)["next"]
        differ += not np.array_equal(a["x"], b["x"])
    assert differ > 0


@pytest.mark.parametrize("which, lane", [("jax", "headline-6-13413"),
                                         ("port", "size_sweep-0-n100-6448")])
def test_range_split_sums_and_reduces_to_the_last_step(which, lane):
    # over the card's consecutive states of a 3d lane's stage range, the
    # range split's parts sum to the total; over its last segment alone it
    # is the split at the parting (``before`` = the inherited error after
    # the step's response, ``operator`` = the operator's part)
    c = next(r for r in _card_states() if (r["file"], r["lane"]) == (which,
                                                                     lane))
    rec = _lane(which, lane)
    d = op_split.f32_data(rec["arrays"])
    caps = [int(k) for k in c["caps"]]
    p = rec["verdict"]["constraint"]
    lo = rec["verdict"]["iteration"] - 1
    start = rec["verdict_stages"]["port_above_from_cap"]
    states = op_split.states_at(c["states"], caps, range(start, lo + 1))
    its = [op_split.k1_iteration(s, d) for s in states]
    x64 = {i: op_split.iterate64(d, s["status"])["x"]
           for i, s in enumerate(states) if int(s["skip1"]) == 0}
    s_hat = float(its[-1]["sel"][p])
    got = op_split.range_split(d, p, s_hat, states, its, x64)
    parts = ("dot", "before", "x_update", "directions", "step_length",
             "operator")
    assert got["segments"] >= 2
    assert abs(sum(got[k] for k in parts) - got["total"]) <= 1e-6
    v = sorted(x64)[-2:]
    last = op_split.range_split(d, p, s_hat, states[v[0]:], its[v[0]:],
                                {i - v[0]: x64[i] for i in v})
    one = op_split.slack_split(d, p, s_hat, states[v[0]:], its[v[0]:-1],
                               x64[v[0]], x64[v[1]])
    for a, b in (("before", one["inherited"] + one["state_x"]),
                 ("operator", one["state_operator"]),
                 ("x_update", one["x_update"]), ("dot", one["dot"]),
                 ("total", one["total"])):
        assert abs(last[a] - b) <= 1e-6, (a, last[a], b)
