"""``solve_refined_kernel``: K1 (``fused_init``), then f64 refinement."""

from qpbench import program


class Entry(program.Entry):
    def prepare(self, qp):
        return program.dense_problem(qp)

    def solve(self, pb, carry=None):
        return program.program().solve_refined_kernel(
            pb, self.opt, ir_steps=self.cfg["ir_steps"],
            fused_init=self.cfg.get("fused_init", True)), None
