"""The benchmark's copies of the generators and of the reference against
the port's originals, on the CPU."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from jrlqp_tpu_torch.reference_impl import solve_np
from jrlqp_tpu_torch.testing import ik_gen
from jrlqp_tpu_torch.testing.batch_gen import random_qp_batch
from qpbench import gen, reference
from qpbench.loader import load_module

KEYS = ("G", "a", "C", "l", "u", "xl", "xu")
DENSE = load_module("families", "dense")
IK = load_module("families", "ik")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_copy_draws_what_the_port_draws(dtype):
    want = random_qp_batch(torch.Generator().manual_seed(9), 6, 5, 11, 0.3,
                           dtype=dtype)
    got = DENSE.random_qp_batch(torch.Generator().manual_seed(9), 6, 5, 11,
                                0.3, dtype, "cpu")
    for k in KEYS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_dense_draw_is_f64_from_the_seed_and_the_pool_index():
    cfg = dict(batch=10, n=3, m=6, act_frac=0.3, draw_dtype="float32")
    a = DENSE.draw(cfg, 2 ** 31 + 77, 0, "cpu")
    b = DENSE.draw(cfg, 2 ** 31 + 77, 0, "cpu")
    c = DENSE.draw(cfg, 2 ** 31 + 78, 0, "cpu")
    d = DENSE.draw(cfg, 2 ** 31 + 77, 1, "cpu")
    assert a.G.dtype == torch.float64 and a.G.shape == (10, 3, 3)
    assert all(torch.equal(getattr(a, k), getattr(b, k)) for k in KEYS)
    assert not torch.equal(a.a, c.a) and not torch.equal(a.a, d.a)
    # drawn in float32: every entry is a float32 number
    assert torch.equal(a.C, a.C.float().double())


def test_ik_copy_has_the_ports_distribution():
    B, nb, s, mc = 256, 3, 6, 2
    ref = ik_gen.ik_batch(B, nb, s, mc, seed=5)
    got = IK.draw(dict(batch=B, nb=nb, s=s, mc=mc), 5, 0, "cpu")
    # G is tri-block-diagonal, symmetric, positive definite
    dense = got.dense()
    assert torch.equal(dense.G, dense.G.mT)
    assert bool((torch.linalg.eigvalsh(dense.G) > 0).all())
    assert dense.C.shape == (B, nb * mc, nb * s)
    # diag = A A^T + nb s I: its diagonal is nb s + s on average; off, C
    # and a standard normal; u - l = U(0, 0.5) + U(0, 2), 1.25 on average
    want = np.array([1.0, 1.0, 1.0, 1.0, 1.25])
    for d in (ref, {k: getattr(got, k).numpy() for k in
                    ("diag", "off", "blocks", "a", "l", "u")}):
        diag_mean = np.diagonal(d["diag"], axis1=-2, axis2=-1).mean()
        stats = np.array([(diag_mean - nb * s) / s, d["off"].std(),
                          d["blocks"].std(), d["a"].std(),
                          (d["u"] - d["l"]).mean()])
        assert stats == pytest.approx(want, rel=0.05)


def test_drift_moves_a_and_both_bounds_alike():
    base = DENSE.draw(dict(batch=400, n=4, m=8, act_frac=0.3,
                           draw_dtype="float64"), 1, 0, "cpu")
    a, lo, hi = gen.drift(base, 0.02, 1, 3)
    assert torch.allclose(hi - base.u, lo - base.l)
    assert float((a - base.a).std()) == pytest.approx(0.02, rel=0.05)
    assert float((lo - base.l).std()) == pytest.approx(0.02, rel=0.05)
    a2, _, _ = gen.drift(base, 0.02, 1, 4)
    assert not torch.equal(a, a2)


def test_stream_seeds_take_large_run_seeds():
    seeds = {gen.stream_seed(s, 1, 0) for s in (0, 1, 2 ** 31 + 5,
                                                2 ** 40, -3)}
    assert len(seeds) == 5 and all(0 <= v < 2 ** 63 for v in seeds)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_copy_answers_as_the_original(seed):
    qp = DENSE.draw(dict(batch=4, n=8, m=16, act_frac=0.5,
                         draw_dtype="float32"), seed, 0, "cpu").numpy()
    for i in range(4):
        args = [qp[k][i] for k in KEYS]
        want, got = solve_np(*args), reference.solve(*args)
        assert got.status == want.status == 0
        assert got.iterations == want.iterations
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.multipliers, want.multipliers)


def test_reference_in_float32_is_the_lower_precision():
    qp = DENSE.draw(dict(batch=3, n=10, m=20, act_frac=0.3,
                         draw_dtype="float32"), 4, 0, "cpu").numpy()
    for i in range(3):
        args = [qp[k][i] for k in KEYS]
        x64 = reference.solve(*args).x
        x32 = reference.solve(*args, dtype=np.float32).x
        gap = np.abs(x64 - x32).max() / (1 + np.abs(x64).max())
        assert 1e-9 < gap < 1e-4


def test_lanes_and_numpy_keep_the_problem():
    qp = DENSE.draw(dict(batch=3, n=2, m=3, act_frac=0.3,
                         draw_dtype="float32"), 0, 0, "cpu")
    one = qp.lanes([1]).numpy()
    assert one["G"].shape == (1, 2, 2)
    np.testing.assert_array_equal(one["a"][0], qp.a[1].numpy())
    assert dataclasses.fields(qp)


def test_a_block_batch_and_its_steps_keep_their_dense_form():
    cfg = dict(batch=3, nb=2, s=3, mc=2)
    b = IK.draw(cfg, 7, 0, "cpu")
    dense = b.dense()
    a, lo, hi = gen.drift(dense, 0.02, 7, 0)
    step = b.with_step(a, lo, hi)
    assert step.diag is b.diag and torch.equal(step.dense().G, dense.G)
    moved = dense.with_step(a, lo, hi)
    assert moved.G is dense.G and moved.a is a and moved.dense() is moved
    with pytest.raises(ValueError):
        IK.draw(dict(cfg, gtype="BLOCK_ARROW"), 7, 0, "cpu")
