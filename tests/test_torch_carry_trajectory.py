"""The dense control loop on the CPU against the plain reference: a cold
step and twelve warm steps of ``solve_refined_kernel_carry`` (K1, then K4,
as their plain versions) over a drifting trajectory whose G and C stay
fixed, each step's lanes held to ``reference_impl.solve_np`` in f64. It is
the benchmark cell ``dense50-track`` at a size the CPU holds: 40% of the
rows tight, 0.02 N(0, 1) noise on a and one 0.02 N(0, 1) shift per row on
l and u a step, one f64 refinement step. Also: a warm step drops a
constraint whose multiplier turned negative, however slightly; a lane the
refinement finds spoiled restarts from the cold step's state, by one
rule at every batch size."""
import dataclasses

import numpy as np
import pytest
import torch

from jrlqp_tpu_torch import (
    SolverOptions,
    problem_from_numpy,
    solve_refined_kernel_carry,
)
from jrlqp_tpu_torch.reference_impl import solve_np
from jrlqp_tpu_torch.testing.batch_gen import random_qp_batch
from jrlqp_tpu_torch.testing.kkt import kkt_residual

torch.set_num_threads(1)

B, N, M, ACT_FRAC, STEPS, DRIFT = 64, 10, 20, 0.4, 12, 0.02
OPT = SolverOptions(max_iter=150)
# the configuration's guarantee: SUCCESS with a KKT residual within 1e-8
KKT_MAX = 1e-8
# x within 1e-9 of the f64 reference, relative to 1 + |x_ref|_inf (the
# benchmark's x_gap limit): one f64 refinement step brings the f32 loop's
# answer to ~1e-12, where the f32 answer alone is ~1e-6 off
X_GAP = 1e-9
# the configuration's stated pass share 0.999
MISS_SHARE = 1e-3


def _trajectory(seed):
    """The base batch and its STEPS drifted steps, f64."""
    gen = torch.Generator().manual_seed(seed)
    base = random_qp_batch(gen, B, N, M, ACT_FRAC, dtype=torch.float32
                           ).with_dtype(torch.float64)
    steps = []
    for _ in range(STEPS):
        da = DRIFT * torch.randn(base.a.shape, generator=gen,
                                 dtype=torch.float64)
        db = DRIFT * torch.randn(base.l.shape, generator=gen,
                                 dtype=torch.float64)
        steps.append(dataclasses.replace(base, a=base.a + da, l=base.l + db,
                                         u=base.u + db))
    return base, steps


def _held(res, pb):
    """(x gaps, KKT residuals, misses): each SUCCESS lane's gap to the f64
    reference and its KKT residual, and the count of lanes not SUCCESS."""
    success = res.status == 0
    kkt = kkt_residual(res.x, res.multipliers, pb)[success].tolist()
    gaps = []
    for i in torch.nonzero(res.status == 0)[:, 0].tolist():
        ref = solve_np(*(getattr(pb, k)[i].numpy() for k in
                         ("G", "a", "C", "l", "u", "xl", "xu")),
                       max_iter=1000)
        assert ref.status == 0, i
        x = res.x[i].numpy()
        gaps.append(float(np.abs(x - ref.x).max()
                          / (1 + np.abs(ref.x).max())))
    return gaps, kkt, int((~success).sum())


def _run(seed, ir_steps):
    base, steps = _trajectory(seed)
    res, carry = solve_refined_kernel_carry(base, None, OPT,
                                            ir_steps=ir_steps)
    out = [_held(res, base)]
    for pb in steps:
        res, carry = solve_refined_kernel_carry(pb, carry, OPT,
                                                ir_steps=ir_steps)
        assert carry.raw is not None     # the kernels' layout is carried
        out.append(_held(res, pb))
    return out


@pytest.mark.parametrize("seed", [3, 22])
def test_dense_trajectory_holds_to_the_reference(seed):
    per_step = _run(seed, ir_steps=1)
    gaps = [g for step, _, _ in per_step for g in step]
    kkt = [r for _, step, _ in per_step for r in step]
    misses = [k for _, _, k in per_step]
    assert max(gaps) <= X_GAP, max(gaps)
    assert max(kkt) <= KKT_MAX, max(kkt)
    assert sum(misses) <= MISS_SHARE * B * len(per_step), misses
    # a carry that kept a failed lane failing would make the misses grow
    half = len(misses) // 2
    assert sum(misses[half:]) <= sum(misses[:half]), misses


def test_the_check_fails_without_the_refinement():
    # the same trajectory with the warm steps' f32 answers unrefined: the
    # gap check above must catch it
    per_step = _run(3, ir_steps=0)
    assert max(g for step, _, _ in per_step[1:] for g in step) > X_GAP


def test_a_warm_step_drops_a_constraint_whose_multiplier_turned_negative():
    # min 0.5|x|^2 + a'x s.t. x_0 >= 0: active with multiplier a_0 = 1 at
    # the cold step; at a_0 = -1e-6 its multiplier is -1e-6, and the warm
    # step must drop it (x_0 = 1e-6), not keep it with the wrong sign
    def problem(a0):
        d = dict(G=np.eye(2)[None], a=np.array([[a0, 0.5]]),
                 C=np.array([[[1.0, 0.0]]]), l=np.zeros((1, 1)),
                 u=np.full((1, 1), np.inf), xl=np.full((1, 2), -np.inf),
                 xu=np.full((1, 2), np.inf))
        return problem_from_numpy(**d, device="cpu")

    res, carry = solve_refined_kernel_carry(problem(1.0), None, OPT)
    assert int(res.active_set[0, 0]) != 0
    pb = problem(-1e-6)
    res, _ = solve_refined_kernel_carry(pb, carry, OPT)
    assert int(res.status[0]) == 0 and int(res.active_set[0, 0]) == 0
    torch.testing.assert_close(res.x[0], torch.tensor([1e-6, -0.5],
                                                      dtype=torch.float64),
                               rtol=0, atol=1e-12)
    assert float(kkt_residual(res.x, res.multipliers, pb)[0]) <= KKT_MAX


@pytest.mark.parametrize("batch", [1, 64, 16384])
def test_the_lanes_flagged_for_reset_are_those_above_the_tolerance(batch):
    # one rule at every batch size: a lane is flagged where its largest
    # residual entry, of r1 or of r2, lies above RESET_TOL, and nowhere else
    from jrlqp_tpu_torch.solver import fast

    gen = torch.Generator().manual_seed(batch)
    scale = 10.0 ** torch.randint(-14, -7, (batch, 1), generator=gen)
    r1 = scale * torch.rand((batch, 50), generator=gen)
    r2 = scale * torch.rand((batch, 40), generator=gen)
    r2[::3] *= 100.0
    wide = torch.maximum(r1.abs().amax(1), r2.abs().amax(1))
    flags = fast._spoiled((-r1, r2))
    assert flags.dtype == torch.int32 and flags.shape == (batch,)
    assert torch.equal(flags.bool(), wide > fast.RESET_TOL)


def _operator_error(pb, carry):
    """Per lane, the largest error of the carry's H and N* against the
    operators of its active set formed in f64, relative to the size of
    G^-1 and of N* (H is 0 at a vertex). The problems have general rows
    alone."""
    out = []
    for i in range(pb.a.shape[0]):
        ao = carry.aorder[i].long()
        slots = torch.nonzero(ao >= 0)[:, 0]
        idx = ao[slots]
        sgn = torch.where(carry.status[i].long()[idx] == 2, -1.0, 1.0)
        N = (pb.C[i][idx] * sgn.double()[:, None]).T
        Gi = torch.linalg.inv(pb.G[i])
        Ns = torch.linalg.solve(N.T @ Gi @ N, N.T @ Gi)
        H = Gi - Gi @ N @ Ns
        out.append(max(float((carry.H[i].double() - H).abs().max()
                             / Gi.abs().max()),
                       float((carry.Ns[i].double()[slots] - Ns).abs().max()
                             / Ns.abs().max())))
    return torch.tensor(out)


@pytest.mark.parametrize("reset", [True, False])
def test_a_lane_the_refinement_finds_spoiled_restarts_cold(reset):
    # lane 0's carried operators are spoiled by 1e-3: one refinement step
    # through them leaves a residual far above what sound f32 operators
    # leave, the carry flags that lane, and its next step starts from the
    # cold step's state, whose operators are K1's; the other lanes keep
    # their own. With the flags cleared the spoiled operators go on.
    base, steps = _trajectory(7)
    _, cold = solve_refined_kernel_carry(base, None, OPT, ir_steps=1)
    carry = dataclasses.replace(cold, raw=tuple(t.clone() for t in cold.raw))
    K = carry.raw[2]
    gen = torch.Generator().manual_seed(1)
    K[0, :N, :N] += 1e-3 * K[0, :N, :N].abs().max() * torch.randn(
        (N, N), generator=gen)
    _, carry = solve_refined_kernel_carry(steps[0], carry, OPT, ir_steps=1)
    assert float(_operator_error(steps[0], carry)[0]) > 1e-4
    assert int(carry.reset[0]) == 1
    assert int(carry.reset.sum()) < B // 2
    if not reset:
        carry = dataclasses.replace(carry,
                                    reset=torch.zeros_like(carry.reset))
    _, carry = solve_refined_kernel_carry(steps[1], carry, OPT, ir_steps=1)
    err = _operator_error(steps[1], carry)
    assert float(err[1:].max()) < 1e-5
    if reset:
        assert float(err[0]) < 1e-5
    else:
        assert float(err[0]) > 1e-4
