"""The JAX package's side of the per-operation split
(``tests/missed_lanes_census.py --split``): the replay of one iteration of
the JAX package's Pallas kernel (``_packed_iterate`` in interpret mode on
the CPU: its ``_vecmat`` and ``jnp.sum`` on a pack of copies of the lane,
each update a - b c one FMA, as XLA on the CPU contracts it) holds the
kernel's next state bit for bit. The bisection of ``--spread`` is in
``test_torch_slack_split_spread.py``."""
from __future__ import annotations

import missed_lanes_census as census

from jrlqp_tpu_torch.testing import miss_census as mc
from jrlqp_tpu_torch.testing import op_split


def _lane(which: str, lane: str) -> dict:
    rec = next(r for r in census._load(which)[0] if mc.lane_id(r) == lane)
    return dict(rec, file=which)


def test_jax_kernel_replay_holds_its_next_state():
    census._setup_jax()
    rec = _lane("port", "headline-3-9615")
    caps = [60, 61]
    states = census._side_states(rec, "jax", caps)
    it = op_split.gi_iteration(states[0], op_split.f32_data(rec["arrays"]),
                               census.JaxOrder(rec))
    assert it["full"]
    assert op_split.same_next(it, states[1])
