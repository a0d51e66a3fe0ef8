"""The reference's own spread (``tests/missed_lanes_census.py --spread``):
the bisection of the JAX package's Pallas kernel against its XLA f32 loop
(``_run_fast``, capped as ``solve_refined`` calls it) finds, on a small
saved lane of the JAX file, the first parting iteration and the deciding
test that ``--spread`` recorded."""
from __future__ import annotations

import missed_lanes_census as census
import numpy as np

from jrlqp_tpu_torch.testing import miss_census as mc


def test_spread_finds_the_recorded_first_parting():
    census._setup_jax()
    rec = next(r for r in census._load("jax")[0]
               if mc.lane_id(r) == "size_sweep-0-n10-8610")
    want = rec["verdict_xla"]
    o = rec["outcomes"]
    j, s = o["jax_pallas_alone"], o["jax_solve_refined_alone"]
    assert not mc.same_outcome(j, s)
    got = census.first_parting(
        rec, lambda c: census.xla_capped(rec, c),
        min(max(j["iterations"], s["iterations"]) + 1, rec["max_iter"]),
        {j["iterations"], s["iterations"]})
    assert got["iteration"] == want["iteration"] == 11
    assert got["kind"] == want["kind"]
    assert got["test"] == want["test"] == "|z|^2 > zs^2 nn"
    np.testing.assert_allclose(got["ulps"], want["ulps"], rtol=1e-9)
    assert want["near_tie"]
