"""The track pattern: a control loop around one base batch. Step k is the
base with the drift of :func:`qpbench.gen.drift` (``drift`` N(0, 1) noise on
a, one ``drift`` N(0, 1) shift per constraint on l and u; G and C fixed);
``pool`` distinct steps, cycled. The entry solves a cold step on step 0 at
set-up, which builds the carry, and every call after it is a warm step
from the carry of the call before."""

from qpbench import gen


def batches(cfg: dict, traffic: dict, seed: int, device, draw) -> list:
    base = draw(cfg, seed, 0, device)
    dense = base.dense()
    out = []
    for k in range(int(traffic["pool"])):
        step = gen.drift(dense, traffic["drift"], seed, k)
        out.append((base.with_step(*step), dense.with_step(*step)))
    return out
