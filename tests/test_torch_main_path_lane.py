"""The one lane of the headline batch that misses the main path's gate on
an H100 (``tests/data/main_path_lane_11415.npz``: lane 11415 of
``random_qp_batch`` at seed 0, batch 16384, n=50, m=100, act_frac 0.3, as
``chip_smoke.py`` draws it, saved from the card with numpy).

K1 on the card takes 61 iterations: constraint 95 has a slack of +8.9e-7
at the f64 solution (3.7 f32 ulps of C x = 3.22), the kernel's f32 sums
see it violated and activate it at its lower bound, it comes out with a
multiplier of 3.6e-7 of the wrong sign, and the f64 refinement of that
active set stalls at a KKT residual of 7.0e-8, over the 1e-8 gate,
whatever ``ir_steps``. The f64 optimum's active set is the card's without
constraint 95.

On the CPU the lane is a near-tie, and which side an f32 sum lands on
depends on the host: the JAX package's fused Pallas kernel in interpret
mode misses the lane on some hosts exactly as the card does (61
iterations, constraint 95 on top) and passes it on others after 60, and
the port's plain main path likewise. So each CPU solver is held to what
every host reproduces: where it passes, x is within 1e-7 of the f64
solution (the port's ``dense.solve_batch`` on the CPU); where it misses,
``solve_refined_kernel_rescued`` passes the lane. The card's own outcome
is held on any host by K1's order-exact replay
(``testing.k1_replay.k1_order_solve``, the ``k1_order_replay`` case).

Verdict: a shared f32 deviation, not a fault of the port. The miss census
(``tests/missed_lanes_census.py``; ``tests/test_torch_missed_lanes.py``
holds its lanes) saves every lane that either package misses on the
headline set and solves it by the other: on 131,072 lanes each
(seeds 0-7) K1 misses 10 of the card's draws and the JAX package's fused
kernel 8 of its own; each passes about half of the other's misses and
misses the rest the same way. This lane parts on a near-tie (3.7 ulps,
within the 16 f32 ulps that the census calls a tie). The card's side
of this lane is the ``main-path-lane-11415-gate`` case of
``test_missed_lane_on_card`` in ``tests/test_torch_card.py``, expected to
fail. ``solve_refined_kernel_rescued`` repairs such a lane."""
import pathlib

import jax
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.solver.fast import solve_refined as j_solve_refined
from jrlqp_tpu.solver.fast import solve_refined_pallas
from jrlqp_tpu_torch import (
    SolverOptions,
    problem_from_numpy,
    result_to_numpy,
    solve_batch,
    solve_refined_kernel,
    solve_refined_kernel_rescued,
)
from jrlqp_tpu_torch.testing.k1_replay import k1_order_solve
from jrlqp_tpu_torch.testing.kkt import kkt_residual
from test_torch_gi_kernel import jax_problem

torch.set_num_threads(1)

LANE = pathlib.Path(__file__).parent / "data" / "main_path_lane_11415.npz"
MAX_ITER = 150
X_TOL = 1e-7
ARRAYS = ("G", "a", "C", "l", "u", "xl", "xu")


def _lane():
    z = np.load(LANE)
    return {k: z[k] for k in ARRAYS}, z


def _jax_pallas_fused(d):
    return solve_refined_pallas(jax_problem(d), JOptions(max_iter=MAX_ITER),
                                ir_steps=1, fused_init=True, interpret=True)


def _jax_solve_refined(d):
    return jax.vmap(lambda p: j_solve_refined(
        p, JOptions(max_iter=MAX_ITER), ir_steps=1))(jax_problem(d))


def _port_plain_main_path(d):
    return solve_refined_kernel(problem_from_numpy(**d, device="cpu"),
                                SolverOptions(max_iter=MAX_ITER), ir_steps=1)


def _k1_order_replay(d):
    return k1_order_solve({k: v[0] for k, v in d.items()}, MAX_ITER,
                          1)["outcome"]


def _as_numpy(res) -> dict:
    if isinstance(res, dict):
        return {"x": res["x"][None], "status": np.array([res["status"]]),
                "iterations": np.array([res["iterations"]]),
                "active_set": res["active_set"][None],
                "kkt": np.array([res["kkt"]])}
    if not isinstance(res.x, torch.Tensor):
        out = {k: np.asarray(getattr(res, k))
               for k in ("x", "multipliers", "status", "iterations",
                         "active_set")}
    else:
        out = result_to_numpy(res)
    out["kkt"] = kkt_residual(
        torch.from_numpy(out["x"].astype(np.float64)),
        torch.from_numpy(out["multipliers"].astype(np.float64)),
        problem_from_numpy(**_lane()[0], device="cpu")).numpy()
    return out


def _f64(d) -> dict:
    """The lane's f64 solution: the port's J/R engine on the CPU."""
    return _as_numpy(solve_batch(problem_from_numpy(**d, device="cpu"),
                                 SolverOptions(max_iter=MAX_ITER)))


@pytest.mark.parametrize("path", [_jax_pallas_fused, _jax_solve_refined,
                                  _port_plain_main_path, _k1_order_replay],
                         ids=["jax_pallas_fused_interpret",
                              "jax_solve_refined", "port_plain_main_path",
                              "k1_order_replay"])
def test_main_path_lane_passes_off_the_card(path):
    d, z = _lane()
    res = _as_numpy(path(d))
    f64 = _f64(d)
    assert f64["status"].tolist() == [0] and float(f64["kkt"][0]) <= 1e-8
    # what the card returned for the same arrays: 61 iterations, the f64
    # optimum's active set and constraint 95, and a residual over the gate
    assert z["iterations"].tolist() == [61]
    differs = np.nonzero(z["active_set"][0] != f64["active_set"][0])[0]
    assert differs.tolist() == [95]
    assert 1e-8 < float(z["resid"][0]) < 1e-7
    pb = problem_from_numpy(**d, device="cpu")
    saved = kkt_residual(torch.from_numpy(z["x"]),
                         torch.from_numpy(z["multipliers"]), pb)
    np.testing.assert_allclose(saved.numpy(), z["resid"], rtol=1e-6)
    if path is _k1_order_replay:
        # K1's order-exact replay gives the card's outcome on any host
        assert res["status"].tolist() == [0]
        assert res["iterations"].tolist() == z["iterations"].tolist()
        np.testing.assert_array_equal(res["active_set"], z["active_set"])
        assert 1e-8 < float(res["kkt"][0]) < 1e-7
        return
    passed = res["status"].tolist() == [0] and float(res["kkt"][0]) <= 1e-8
    if passed:
        np.testing.assert_allclose(res["x"], f64["x"], rtol=0, atol=X_TOL)
    else:
        resc = _as_numpy(solve_refined_kernel_rescued(
            pb, SolverOptions(max_iter=MAX_ITER), ir_steps=1))
        assert resc["status"].tolist() == [0]
        assert float(resc["kkt"][0]) <= 1e-8
