"""K1: the port's fused GI loop (plain version on the CPU) against the Pallas
kernel ``run_loop_pallas(..., fused_init=True)`` in interpret mode, on the
batch kinds of tests/test_pallas_kernel.py: adds and removes, equalities and
fixed variables, an equality-only lane mix, vertex touches (q == n) and a
non-SPD lane. Inputs are made with numpy and shared by both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu.ops.pallas.gi_kernel import run_loop_pallas
from jrlqp_tpu.problems import QPProblem as JQP
from jrlqp_tpu_torch import problem_from_numpy
from jrlqp_tpu_torch.ops.cuda import gi_kernel
from jrlqp_tpu_torch.utils import spans
from test_torch_card import CASES, make_case, np_qp_batch

torch.set_num_threads(1)


def jax_problem(d):
    B = d["G"].shape[0]
    dt = d["G"].dtype
    return JQP(**{k: jnp.asarray(v) for k, v in d.items()},
               objcst=jnp.zeros((B,), dt))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpret(name):
    d, max_iter = make_case(name)
    d32 = {k: v.astype(np.float32) for k, v in d.items()}
    ref = run_loop_pallas(jax_problem(d32), None, max_iter, interpret=True,
                          pack=4, fused_init=True)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ours = gi_kernel.run_loop_fused(problem_from_numpy(**d32, device="cpu"), max_iter)
    ours = {k: v.numpy() for k, v in ours.items()}
    for k in ("term", "it", "q", "status", "aorder", "skip1", "sc_idx",
              "sc_status"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for k in ("x", "u", "H", "Ns"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(ours["hscale"], ref["hscale"], rtol=1e-5)
    if name == "non_spd":
        assert ours["term"][2] == 2 and (ours["term"][[0, 1, 3]] == 0).all()
    if name == "eq_fixed":
        assert (ours["status"][:, [0, 3]] == 3).all()     # EQUALITY
        assert (ours["status"][:, 6 + 2] == 6).all()      # FIXED


def test_run_loop_fused_on_cpu_is_the_plain_version():
    d, max_iter = make_case("n8_m12")
    pb = problem_from_numpy(**{k: v.astype(np.float32) for k, v in d.items()},
                            device="cpu")
    a = gi_kernel.run_loop_fused(pb, max_iter)
    b = gi_kernel.gi_fused_plain(pb, max_iter)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert spans.counter("launch.K1") == 0


def test_overconstrained_by_equalities():
    # more equalities than variables: OVERCONSTRAINED unless a dependent
    # one is met first, exactly as the Pallas kernel decides
    d = np_qp_batch(5, 4, 3, 6, 0.3)
    d["l"][:, :4] = d["u"][:, :4]
    d32 = {k: v.astype(np.float32) for k, v in d.items()}
    ref = run_loop_pallas(jax_problem(d32), None, 30, interpret=True, pack=4,
                          fused_init=True)
    ours = gi_kernel.gi_fused_plain(problem_from_numpy(**d32, device="cpu"), 30)
    np.testing.assert_array_equal(ours["term"].numpy(),
                                  np.asarray(ref["term"]))
    assert set(ours["term"].tolist()) <= {5, 6}

