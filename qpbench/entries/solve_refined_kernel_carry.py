"""``solve_refined_kernel_carry``: a cold step without a carry (K1), else
K4 from the previous step's carry in the kernels' own layout
(``WarmCarry.raw``: only a and the bounds are padded), then f64
refinement."""

from qpbench import program


class Entry(program.Entry):
    carries = True

    def prepare(self, qp):
        return program.dense_problem(qp)

    def solve(self, pb, carry=None):
        return program.program().solve_refined_kernel_carry(
            pb, carry, self.opt, ir_steps=self.cfg["ir_steps"])
