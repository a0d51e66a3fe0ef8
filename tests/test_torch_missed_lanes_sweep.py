"""The size sweep's missed lanes (n = 10 to 100, m = 2n, ``max_iter`` 500,
3 refinement steps), held as ``tests/test_torch_missed_lanes.py`` holds
the headline set's: K1's order-exact replay gives the card's outcome, and
the JAX package's Pallas kernel in interpret mode (``fused_init=True``,
K1's counterpart), ``vmap(solve_refined)`` and the port's plain K1 path on
the CPU each pass within 1e-7 of the lane's f64 solution or are rescued;
where the JAX kernel and the port both pass, they agree within 1e-7."""
import torch

from test_torch_missed_lanes import check_lane, lane_cases, record

torch.set_num_threads(1)


def pytest_generate_tests(metafunc):
    # the cases are read from the files at collection (a missing file fails)
    metafunc.parametrize("which, lane", lane_cases(sweep=True))


def test_sweep_lane_against_the_other_package(which, lane, record_property):
    check_lane(record(which, lane), record_property)
