"""The warm carry in the kernels' own layout, and the solves' rhs widths.

- A trajectory of one cold and four warm steps of
  ``solve_refined_kernel_carry``, each warm step on the carry the step
  before returned (K, status and aorder as the kernel wrote them, the padded
  G and C^T of the first step), against ``solve_refined_pallas_carry`` in
  interpret mode on the same numpy arrays; the carry's H, Ns, status,
  aorder and q against the JAX carry's fields.
- The rule that forms the per-slot statuses and signed active bounds inside
  K4 (here in its plain version) against the host gathers it replaced.
- A carry built from the five plain tensors against the kernel-layout one.
- The plain versions of K6 and K8 against the Pallas kernels in interpret
  mode at rhs widths that are no multiple of any tile, with zero blocks in
  the rhs.
On the CPU every kernel wrapper runs its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrlqp_tpu import SolverOptions as JOptions
from jrlqp_tpu.ops.pallas import block_llt as jbl
from jrlqp_tpu.solver.fast import solve_refined_pallas_carry
from jrlqp_tpu_torch import (
    SolverOptions,
    problem_from_numpy,
    result_to_numpy,
    solve_refined_kernel_carry,
)
from jrlqp_tpu_torch.ops.cuda import block_llt, gi_kernel
from jrlqp_tpu_torch.solver import fast
from jrlqp_tpu_torch.testing.ik_gen import ik_batch
from jrlqp_tpu_torch.types import (
    EQUALITY,
    FIXED,
    LOWER,
    LOWER_BOUND,
    UPPER,
    UPPER_BOUND,
)
from test_torch_card import drifted, np_qp_batch
from test_torch_gi_kernel import jax_problem

torch.set_num_threads(1)

MAX_ITER = 100
CARRY_FIELDS = ("H", "Ns", "status", "aorder", "q")


def _trajectory(n, m, special):
    """The cold batch and four drifted steps (G and C fixed). With
    ``special``, lane 0 sits at a vertex in every step (n active bounds, q =
    n: a steep linear term against a finite box, its rows of C out of the
    way), and from warm step 2 on lane 1's lower bounds lie 10 below, which
    frees every constraint its carry holds at the lower side: they are
    deactivated at K4's entry."""
    d = np_qp_batch(100 * n + m, 5, n, m, 0.4)
    if special:
        d["a"][0] = 50.0
        d["xl"][0], d["xu"][0] = -1.0, 1.0
        d["l"][0], d["u"][0] = -1e3, 1e3
    steps = [d]
    for k in range(4):
        ds = drifted(d, 0.02, 10 + k)
        if special and k >= 1:
            ds["l"][1] -= 10.0
        steps.append(ds)
    return steps


def _assert_same_result(ours, ref):
    np.testing.assert_array_equal(ours["status"], np.asarray(ref.status))
    np.testing.assert_array_equal(ours["iterations"],
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(ours["active_set"],
                                  np.asarray(ref.active_set))
    np.testing.assert_allclose(ours["x"], np.asarray(ref.x), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(ours["multipliers"],
                               np.asarray(ref.multipliers), rtol=0,
                               atol=1e-9)


def _assert_same_carry(carry, jcarry):
    for k in ("status", "aorder", "q"):
        np.testing.assert_array_equal(getattr(carry, k).numpy(),
                                      np.asarray(getattr(jcarry, k)),
                                      err_msg=k)
    # f32 operators carried over up to five steps by two programs whose
    # sums run in different orders: 1e-6 absolute plus 1e-5 relative
    for k in ("H", "Ns"):
        np.testing.assert_allclose(getattr(carry, k).numpy(),
                                   np.asarray(getattr(jcarry, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("special", [False, True],
                         ids=["drift", "vertex_and_entry_deactivation"])
@pytest.mark.parametrize("n,m", [(6, 10), (10, 20)])
def test_kernel_layout_carry_trajectory_matches_pallas_interpret(n, m,
                                                                 special):
    steps = _trajectory(n, m, special)
    jopt, opt = JOptions(max_iter=MAX_ITER), SolverOptions(max_iter=MAX_ITER)
    jcarry = carry = None
    for k, ds in enumerate(steps):
        ref, jcarry = solve_refined_pallas_carry(
            jax_problem(ds), jcarry, jopt, ir_steps=3, interpret=True, pack=4)
        res, carry = solve_refined_kernel_carry(
            problem_from_numpy(**ds, device="cpu"), carry, opt, ir_steps=3)
        assert carry.raw is not None      # the kernels' layout rides along
        _assert_same_result(result_to_numpy(res), ref)
        _assert_same_carry(carry, jcarry)
        assert bool((res.status == 0).all())
        if special:
            assert int(carry.q[0]) == n   # the vertex lane
            if k == 2:
                # lane 1 came in holding lower-side constraints and left
                # without them, with its removals counted as iterations
                assert int(res.iterations[1]) >= 1
                assert not bool((carry.status[1, :m] == LOWER).any())


def _old_gathers(pb32, status, aorder, n):
    """statk and b_act as the host formed them before K4 did (the Pallas
    wrapper's gathers): from the unpadded bounds, infinities to +/-1e30."""
    ao = aorder.long()
    valid = ao >= 0
    idxs = torch.where(valid, ao, 0)
    sts = torch.where(valid, status.long().gather(1, idxs), 0)

    def clamp(v):
        return torch.nan_to_num(v.float(), posinf=1e30,
                                neginf=-1e30).clamp(-1e30, 1e30)

    lo_all = clamp(torch.cat([pb32.l, pb32.xl], dim=1)).gather(1, idxs)
    up_all = clamp(torch.cat([pb32.u, pb32.xu], dim=1)).gather(1, idxs)
    upperish = (sts == UPPER) | (sts == UPPER_BOUND)
    b_act = torch.where(valid, torch.where(upperish, -up_all, lo_all), 0.0)
    return sts[:, :n], b_act[:, :n]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_in_kernel_slot_rule_matches_host_gathers(seed):
    # slots of every status, free slots between them, and infinite bounds,
    # some on the side a slot holds (clamped to +/-1e30)
    rng = np.random.default_rng(seed)
    B, n, m = 4, 7, 9
    d = np_qp_batch(seed, B, n, m, 0.4)
    d["xl"] = rng.uniform(-2.0, -1.0, (B, n))
    d["xu"] = rng.uniform(1.0, 2.0, (B, n))
    d["u"][:, ::2] = np.inf
    d["l"][:, 1::2] = -np.inf
    d["xu"][:, ::3] = np.inf
    status = np.zeros((B, m + n), np.int32)
    aorder = np.full((B, n), -1, np.int32)
    kinds_c, kinds_b = (LOWER, UPPER, EQUALITY), (LOWER_BOUND, UPPER_BOUND,
                                                  FIXED)
    for b in range(B):
        slots = rng.permutation(n)[:rng.integers(2, n)]    # the rest: free
        idxs = rng.permutation(m + n)[:len(slots)]
        for k, idx in zip(slots, idxs):
            st = (kinds_c if idx < m else kinds_b)[rng.integers(3)]
            status[b, idx], aorder[b, k] = st, idx
    pb32 = problem_from_numpy(**{k: v.astype(np.float32)
                                 for k, v in d.items()}, device="cpu")
    ts, ta = torch.from_numpy(status), torch.from_numpy(aorder)
    eye = torch.eye(n).expand(B, n, n)
    ins, _ = gi_kernel.prepare_warm(pb32, eye, torch.zeros_like(eye), ts, ta,
                                    torch.from_numpy((aorder >= 0).sum(1)))
    _, _, lo, up, xlo, xup, _, _, status_p, aorder_p = ins[:10]
    statk, b_act = gi_kernel._warm_slots(lo, up, xlo, xup, status_p.long(),
                                         aorder_p.long())
    ref_statk, ref_b = _old_gathers(pb32, ts, ta, n)
    assert torch.equal(statk[:, :n], ref_statk)
    assert torch.equal(b_act[:, :n], ref_b)
    assert bool((statk[:, n:] == 0).all()) and bool((b_act[:, n:] == 0).all())
    assert bool((b_act.abs() <= 1e30).all())
    assert bool((b_act.abs() == 1e30).any())     # an infinite side is held


@pytest.mark.parametrize("n,m", [(6, 10), (10, 20)])
def test_plain_tensor_carry_gives_the_kernel_layout_step(n, m):
    steps = _trajectory(n, m, True)
    opt = SolverOptions(max_iter=MAX_ITER)
    _, carry = solve_refined_kernel_carry(
        problem_from_numpy(**steps[0], device="cpu"), None, opt)
    for ds in steps[1:3]:
        pb = problem_from_numpy(**ds, device="cpu")
        plain = fast.WarmCarry(*(getattr(carry, k) for k in CARRY_FIELDS))
        assert plain.raw is None
        res_p, carry_p = solve_refined_kernel_carry(pb, plain, opt)
        res, carry = solve_refined_kernel_carry(pb, carry, opt)
        for k in ("x", "multipliers", "status", "iterations", "active_set"):
            assert torch.equal(getattr(res, k), getattr(res_p, k)), k
        for k in CARRY_FIELDS:
            assert torch.equal(getattr(carry, k), getattr(carry_p, k)), k
    with pytest.raises(ValueError, match="does not fit"):
        solve_refined_kernel_carry(
            problem_from_numpy(**np_qp_batch(0, 5, n + 8, m, 0.4),
                               device="cpu"), carry, opt)


@pytest.mark.parametrize("k", [1, 3, 57, 65])
@pytest.mark.parametrize("kind", ["tri", "tri_lower", "arrow_down",
                                  "arrow_up"])
def test_solve_plain_matches_pallas_interpret_at_ragged_widths(kind, k):
    nb, s, B = 4, 5, 3
    d = ik_batch(B, nb=nb, s=s, mc=2, seed=17)
    diag, off = d["diag"].astype(np.float32), d["off"].astype(np.float32)
    r = np.random.default_rng(k).standard_normal((B, nb, s, k)).astype(
        np.float32)
    r[:, 1] = 0.0              # a zero block row in every problem
    r[0, :3] = 0.0             # lane 0: nonzero in the last block only
    r[1, :, :, k // 2:] = 0.0  # lane 1: zero columns
    td, to, tr = (torch.from_numpy(v) for v in (diag, off, r))
    up = kind == "arrow_up"
    if kind.startswith("tri"):
        lower = kind == "tri_lower"
        _, Lo, Li = block_llt.tri_block_llt_plain(td, to)
        y = block_llt.tri_block_solve(Lo, Li, tr, lower)
        _, jLo, jLi = jbl.tri_block_llt_pallas(
            jnp.asarray(diag), jnp.asarray(off), interpret=True)
        jy = jbl.tri_block_solve_pallas(jLo, jLi, jnp.asarray(r),
                                        interpret=True, lower_only=lower)
    else:
        _, Lo, Li = block_llt.block_arrow_llt_plain(td, to, up=up)
        y = block_llt.block_arrow_solve(Lo, Li, tr, up=up)
        _, jLo, jLi = jbl.block_arrow_llt_pallas(
            jnp.asarray(diag), jnp.asarray(off), up=up, interpret=True)
        jy = jbl.block_arrow_solve_pallas(jLo, jLi, jnp.asarray(r), up=up,
                                          interpret=True)
    assert y.shape == (B, nb, s, k)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    if kind != "tri_lower":
        assert bool((y[1, :, :, k // 2:] == 0).all())


def test_occupied_padded_slot_comes_in_free():
    # a kernel may leave a padded slot (index n and up) occupied on a lane
    # that ended LINEAR_DEPENDENCY_DETECTED at q > n; the library's carry
    # has n slots and drops it, and so does K4 at entry: its N* column, its
    # constraint's status and its count in q go, and the step is the one
    # from the carry without it
    n, m = 6, 10
    steps = _trajectory(n, m, False)
    opt = SolverOptions(max_iter=MAX_ITER)
    _, carry = solve_refined_kernel_carry(
        problem_from_numpy(**steps[0], device="cpu"), None, opt)
    pb = problem_from_numpy(**steps[1], device="cpu")
    # no lane flagged for reset, so lane 0 starts from the slots edited here
    ins, _ = gi_kernel.prepare_warm_carry(pb, carry.raw, carry.q,
                                          torch.zeros_like(carry.reset),
                                          carry.first)
    np_ = ins[0].shape[1]
    dirty = [t.clone() for t in ins]
    K, status, aorder, q = dirty[7], dirty[8], dirty[9], dirty[10]
    free = int((status[0, :m] == 0).nonzero()[0])   # an inactive constraint
    aorder[0, n] = free
    status[0, free] = LOWER
    q[0] += 1
    K[0, :, np_ + n] = torch.randn(np_)
    clean = gi_kernel._gi_warm_plain_raw(*ins, n, m, MAX_ITER)
    ours = gi_kernel._gi_warm_plain_raw(*dirty, n, m, MAX_ITER)
    for k, (a, b) in enumerate(zip(ours, clean)):
        assert torch.equal(a, b), k
    assert int(ours[2][0, free]) == 0
