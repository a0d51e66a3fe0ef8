"""Test-support library of the port: the KKT oracle, the seeded problem
generators and a batch generator (the exports of
``jrlqp_tpu/testing/__init__.py``)."""
from .kkt import check_kkt, check_kkt_feasibility, check_kkt_stationarity, kkt_residual
from .random_matrices import rand_dependent, rand_ortho, randn_rank
from .random_problems import ProblemCharacteristics, RandomLeastSquare, random_problem

__all__ = [
    "check_kkt",
    "check_kkt_stationarity",
    "check_kkt_feasibility",
    "kkt_residual",
    "rand_ortho",
    "randn_rank",
    "rand_dependent",
    "ProblemCharacteristics",
    "RandomLeastSquare",
    "random_problem",
]
