"""The program under test, ``jrlqp_tpu_torch``, and what its entry points
share.

The program is imported through :func:`program` and nowhere else in the
harness. A cell's own file (``cells/<cell>.json``) names its entry point, a
module ``entries/<entry>.py`` whose ``Entry`` turns the benchmark's batches
into the program's inputs once, at set-up (:meth:`Entry.prepare`: wrapping
tensors that are already on the card, no arithmetic), then solves them
(:meth:`Entry.solve`), returning the program's result (x, multipliers,
iterations, status and active set per lane) and, for a trajectory, the
carry that the next step starts from.
"""
from __future__ import annotations

import importlib

from .loader import load_module


def program(module: str = ""):
    """``jrlqp_tpu_torch`` or one of its modules."""
    return importlib.import_module(
        "jrlqp_tpu_torch" + (f".{module}" if module else ""))


class Entry:
    """An entry point with the configuration's options."""

    carries = False      # True where a step hands its successor a carry

    def __init__(self, cfg: dict, devices):
        self.cfg = cfg
        self.devices = devices
        self.opt = program().SolverOptions(**cfg.get("options", {}))

    def prepare(self, batch):
        raise NotImplementedError

    def solve(self, args, carry=None):
        """(result, carry) of one call."""
        raise NotImplementedError


def dense_problem(qp):
    """The program's ``QPProblem`` of a batch of the dense family."""
    return program().QPProblem(G=qp.G, a=qp.a, C=qp.C, l=qp.l, u=qp.u,
                               xl=qp.xl, xu=qp.xu,
                               objcst=qp.a.new_zeros(qp.a.shape[0]))


def structured_inputs(cfg: dict, ik):
    """The program's (G, a, C, l, u) of a batch in block form, G of the
    configuration's ``gtype``."""
    st = program("structured")
    sg = st.StructuredG(diag=ik.diag, off=ik.off,
                        gtype=getattr(st.GType, cfg["gtype"]))
    return sg, ik.a, st.StructuredC(blocks=ik.blocks), ik.l, ik.u


def load_entry(name: str, cfg: dict, devices) -> Entry:
    """The entry point ``entries/<name>.py`` with ``cfg``'s options."""
    return load_module("entries", name).Entry(cfg, devices)
