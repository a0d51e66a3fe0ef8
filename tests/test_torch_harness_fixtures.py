"""The port's harness fixtures beside time_batch (jrlqp_tpu_torch.bench.
harness) against the JAX package's: the warm-start trajectory, the box
batch, the decompositions and the structured IK batch. Rows' names and
keys are equal letter for letter. Where both harnesses draw the same
problems -- the numpy-seeded box and IK batches -- the success rates and
iteration means are equal too (tolerance 0: means of integer counts and
flags). The JAX kernels run in interpret mode."""
import pytest
import torch

from jrlqp_tpu.bench import harness as jh
from jrlqp_tpu_torch.bench import harness as th
from jrlqp_tpu_torch.ops.cuda import block_llt, gi_kernel
from test_torch_harness import same_rows, shared_batches  # noqa: F401

torch.set_num_threads(1)


def _launches():
    return (gi_kernel.launches, gi_kernel.loop_launches,
            gi_kernel.warm_launches, block_llt.tri_llt_launches,
            block_llt.tri_solve_launches, block_llt.arrow_llt_launches)


@pytest.mark.parametrize("solver", ["pallas", "f64"])
def test_warm_start_trajectory_rows(shared_batches, solver):  # noqa: F811
    kw = dict(n=6, m=12, steps=4, batch=4, solver=solver, time_window=3)
    ours = th.bench_warm_start_trajectory(**kw, device="cpu")
    ref = jh.bench_warm_start_trajectory(**kw)
    same_rows([ours], [ref])
    assert ours["name"] == f"warm_start_trajectory/{solver}/n=6/m=12/steps=4"
    assert ours["warm_success"] == ours["cold_success"] == 1.0
    assert ref["warm_success"] == ref["cold_success"] == 1.0
    # step 0 of the warm run is cold; the later steps start near the answer
    assert ours["warm_mean_it"] < ours["cold_mean_it"]
    assert ours["warm_us_per_solve"] > 0 and ours["cold_us_per_solve"] > 0


def test_box_single_matches_jax():
    ours = th.bench_box_single(n=5, batch=8, device="cpu")
    ref = jh.bench_box_single(n=5, batch=8)
    same_rows([ours], [ref], ("batch", "mean_iterations", "success_rate"))
    assert ours["success_rate"] == 1.0


def test_decompositions_rows_on_plain_versions():
    before = _launches()
    ours = th.bench_decompositions(nb=3, s=4, batch=2, device="cpu")
    ref = jh.bench_decompositions(nb=3, s=4, batch=2, interpret=True)
    same_rows(ours, ref)
    assert _launches() == before        # the CPU runs the plain versions
    assert all(r["ms"] > 0 for r in ours)
    f32 = th.bench_decompositions(nb=3, s=4, batch=2, include_f64=False,
                                  device="cpu")
    same_rows(f32, jh.bench_decompositions(nb=3, s=4, batch=2,
                                           include_f64=False,
                                           interpret=True))


def test_decompositions_raise_on_a_bad_shape(monkeypatch):
    """A failing kernel row raises: the JAX harness drops the row and
    prints a line to stderr instead."""
    real = block_llt.identity_rhs

    def one_row_too_many(B, nb, s, **kw):
        return real(B, nb, s + 1, **kw)[:, :, :, :nb * s]

    monkeypatch.setattr(block_llt, "identity_rhs", one_row_too_many)
    with pytest.raises(ValueError, match="tri_block_solve"):
        th.bench_decompositions(nb=3, s=4, batch=2, device="cpu")


def test_structured_ik_matches_jax():
    ours = th.bench_structured_ik(nb=3, s=4, mc=2, batch=3, device="cpu")
    ref = jh.bench_structured_ik(nb=3, s=4, mc=2, batch=3, interpret=True)
    same_rows(ours, ref, ("batch", "success_rate"))
    assert [r["success_rate"] for r in ours] == [1.0] * 3
    assert all(r["max_diff_vs_pallas"] <= 1e-9 for r in ours[1:])
